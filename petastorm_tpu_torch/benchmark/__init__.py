"""Measurement helpers for the port's paths on the card, and the port of
``petastorm_tpu.benchmark``: reader throughput, the link probe, the decode and
wire micro-benchmarks and their CLI."""

from petastorm_tpu_torch.benchmark.throughput import BenchmarkResult, reader_throughput  # noqa: F401
