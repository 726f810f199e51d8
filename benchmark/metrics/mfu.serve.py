"""``mfu.serve``: see ``harness/readers.py::mfu``."""

from harness.readers import mfu as read  # noqa: F401
