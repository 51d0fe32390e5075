"""Benchmarks of the port, each the counterpart of a script in the
repository's ``benchmarks/``."""
