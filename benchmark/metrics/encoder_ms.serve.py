"""``encoder_ms.serve``: see ``harness/spans.py::encoder_ms``."""

from harness.spans import encoder_ms as read  # noqa: F401
