"""The benchmark's harness: the specification, the base of the protocol
modules, the timed window, the trace reader and the comparison that
decides ``correct``.  Nothing here is specific to one cell: cells,
configurations, traffic mixes, their protocols and per-layer metrics are
found by their names in ``BENCHMARK.json`` and its files."""
