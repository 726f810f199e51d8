"""The benchmark's harness: discovery of cells, configurations, traffic and
metric readers by name, the system under test's set-up, the profiler slice,
the benchmark's own arithmetic and the check that decides ``correct``."""
