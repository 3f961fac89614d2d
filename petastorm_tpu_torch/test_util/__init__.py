"""Test scaffolding shipped with the package (a copy of ``petastorm_tpu.test_util``'s
reader mock)."""

from petastorm_tpu_torch.test_util.reader_mock import ReaderMock  # noqa: F401
