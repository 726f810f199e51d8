"""``graph_builds.offline``: see ``harness/spans.py::graph_builds``."""

from harness.spans import graph_builds as read  # noqa: F401
