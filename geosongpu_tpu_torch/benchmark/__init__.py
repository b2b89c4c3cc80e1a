"""Benchmark records and the measured phase tree of the step."""
