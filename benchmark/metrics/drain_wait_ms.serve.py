"""``drain_wait_ms.serve``: see ``harness/spans.py::drain_wait_ms``."""

from harness.spans import drain_wait_ms as read  # noqa: F401
