"""``requests_per_call.serve``: see ``harness/readers.py::requests_per_call``."""

from harness.readers import requests_per_call as read  # noqa: F401
