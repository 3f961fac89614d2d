"""pipecheck of the port: the AST-based invariant analyzer for the
cross-process data plane, the port of ``petastorm_tpu.analysis``.

The multi-process pipeline's correctness rests on invariants no general tool
checks: the process pool's pipe message kinds (``str`` tuples over
``multiprocessing.connection``) and the input service's ZMQ kinds must match
between producers and consumers; shm descriptor fields written by
``to_bytes`` must be read by ``from_bytes``; results-channel sidecar keys
written by ``serializers.serialize`` must be read back by ``deserialize``;
telemetry stage names must exist in the ``spans.py`` catalog;
retry/breaker/deadline code must never read the wall clock directly; broad
excepts in worker loops must justify themselves; the mypy-strict module set
may only grow. Protocol drift between processes otherwise fails only at
runtime, on the slow path, under load: pipecheck pins each invariant
statically.

It parses the files it checks and never imports them, and imports none of
torch, zmq or pyarrow itself, so it runs where those are absent.

Defined differences from the JAX package's analyzer:

- the pool pair's kinds are read as ``str`` pipe kinds (the first ``str``
  of a tuple handed to ``send``/``_send``; ``kind == 'x'`` and
  ``message[0] == 'x'`` dispatches) beside the ZMQ bytes kinds, which stay
  as they were for the input service's trio;
- the mypy ratchet considers only the ``mypy.ini`` sections whose module
  pattern lies in the analyzed package (whole dotted components);
- the catalog and registry fallbacks read this package's modules
  (``petastorm_tpu_torch.telemetry.spans``, ``.autotune.knobs``,
  ``.resilience``, ``.service.ledger``, ``.parallel.topology``,
  ``.telemetry.history``);
- the raise-taxonomy message names ``petastorm_tpu_torch.errors``;
- ``LEAKABLE_TYPES`` adds the pool's pipe ``Connection`` (released by
  ``close``) beside the zmq ``Context`` row, which matches only the
  service;
- bench.py has no ``pipecheck`` section for the port.

Entry points: ``python -m petastorm_tpu_torch.analysis``,
``petastorm-tpu-torch-pipecheck``, ``petastorm-tpu-torch-throughput
pipecheck`` and the doctor's ``report['pipecheck']`` block. Rule catalog and
suppression syntax: docs/static-analysis.md.
"""

from petastorm_tpu_torch.analysis.cli import main, run_pipecheck
from petastorm_tpu_torch.analysis.config import AnalysisConfig, default_config
from petastorm_tpu_torch.analysis.core import Finding, Report, Rule, run_analysis
from petastorm_tpu_torch.analysis.rules import ALL_RULES, default_rules

__all__ = ['AnalysisConfig', 'ALL_RULES', 'Finding', 'Report', 'Rule',
           'default_config', 'default_rules', 'main', 'run_analysis',
           'run_pipecheck']
