"""``decode_ms_per_step.serve``: see ``harness/readers.py::decode_ms_per_step``."""

from harness.readers import decode_ms_per_step as read  # noqa: F401
