"""The harness of the port's benchmark: it reads ``BENCHMARK.json`` and the
cell's data files, makes the inputs from the seed, drives the port's timed
path, and holds what it produced against ``reference``."""
