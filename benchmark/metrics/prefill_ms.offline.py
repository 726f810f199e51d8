"""``prefill_ms.offline``: see ``harness/spans.py::prefill_ms``."""

from harness.spans import prefill_ms as read  # noqa: F401
