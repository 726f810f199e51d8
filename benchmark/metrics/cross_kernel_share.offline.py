"""``cross_kernel_share.offline``: see ``harness/passes.py::cross_kernel_share``."""

from harness.passes import cross_kernel_share as read  # noqa: F401
