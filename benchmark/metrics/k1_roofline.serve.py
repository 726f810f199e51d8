"""``k1_roofline.serve``: see ``harness/readers.py::k1_roofline``."""

from harness.readers import k1_roofline as read  # noqa: F401
