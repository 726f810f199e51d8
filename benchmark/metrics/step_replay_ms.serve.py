"""``step_replay_ms.serve``: see ``harness/spans.py::step_replay_ms``."""

from harness.spans import step_replay_ms as read  # noqa: F401
