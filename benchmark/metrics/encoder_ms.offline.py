"""``encoder_ms.offline``: see ``harness/spans.py::encoder_ms``."""

from harness.spans import encoder_ms as read  # noqa: F401
