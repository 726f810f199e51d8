"""``step_gap.serve``: see ``harness/spans.py::step_gap``."""

from harness.spans import step_gap as read  # noqa: F401
