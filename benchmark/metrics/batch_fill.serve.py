"""``batch_fill.serve``: see ``harness/readers.py::batch_fill``."""

from harness.readers import batch_fill as read  # noqa: F401
