"""``queue_wait_ms.serve``: see ``harness/readers.py::queue_wait_ms``."""

from harness.readers import queue_wait_ms as read  # noqa: F401
