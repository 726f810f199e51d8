"""``vad_ms_per_min.offline``: see ``harness/readers.py::vad_ms_per_min``."""

from harness.readers import vad_ms_per_min as read  # noqa: F401
