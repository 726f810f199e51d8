"""``bucket_wait_ms.serve``: see ``harness/spans.py::bucket_wait_ms``."""

from harness.spans import bucket_wait_ms as read  # noqa: F401
