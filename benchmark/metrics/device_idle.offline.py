"""``device_idle.offline``: see ``harness/readers.py::device_idle``."""

from harness.readers import device_idle as read  # noqa: F401
