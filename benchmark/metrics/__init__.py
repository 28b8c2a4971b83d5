"""One reader per metric of ``BENCHMARK.json``, found by the metric's
name: ``read(run)`` takes a :class:`benchmark.harness.Run` and returns
the number, or None where the run has nothing to read."""
