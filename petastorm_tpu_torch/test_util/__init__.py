"""Test scaffolding shipped with the package: copies of ``petastorm_tpu.test_util``'s
reader mock and fault-injecting filesystem
(:mod:`~petastorm_tpu_torch.test_util.fault_injection`)."""

from petastorm_tpu_torch.test_util.reader_mock import ReaderMock  # noqa: F401
