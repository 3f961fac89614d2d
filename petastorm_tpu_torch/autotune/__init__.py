"""Closed-loop autotuner: telemetry-driven online retuning of pipeline knobs.
The port's copy of ``petastorm_tpu.autotune`` (plain Python, no torch):
``attribute_bottleneck`` names the knob that moves the dominant stage, and
this package turns it, live, mid-epoch:

- :mod:`~petastorm_tpu_torch.autotune.knobs` — the typed knob actuation layer
  (:class:`Knob`/:class:`KnobCatalog`, the declared ``KNOB_IDS`` catalog, and
  builders that wire knobs into live readers and loaders);
- :mod:`~petastorm_tpu_torch.autotune.policy` — :class:`AutotunePolicy`, the
  pacing and hysteresis constants;
- :mod:`~petastorm_tpu_torch.autotune.controller` — the hill-climbing
  :class:`AutotuneController` (propose -> hold -> measure -> commit/revert,
  breaker-board safety interlock, JSONL + flight-recorder decision audit).

Enable per reader with ``make_reader(..., autotune=True)`` (or an
:class:`AutotunePolicy`); inspect with ``Reader.autotune_report()`` /
``diagnostics['autotune']``. A :class:`~petastorm_tpu_torch.TorchDataLoader`
over such a reader adds its own knobs to the reader's controller. Off by
default: with ``autotune`` unset no controller is built and no knob is ever
touched. A knob changes how fast rows arrive, never which rows an epoch
delivers.
"""

from petastorm_tpu_torch.autotune.controller import (AutotuneController,
                                                     choose_from_bottleneck,
                                                     setup_reader_autotune,
                                                     snapshot_delta)
from petastorm_tpu_torch.autotune.knobs import (KNOB_IDS, Knob, KnobCatalog,
                                                build_loader_knobs,
                                                build_reader_knobs)
from petastorm_tpu_torch.autotune.policy import AutotunePolicy, resolve_policy

__all__ = ['AutotuneController', 'AutotunePolicy', 'KNOB_IDS', 'Knob',
           'KnobCatalog', 'build_loader_knobs', 'build_reader_knobs',
           'choose_from_bottleneck', 'resolve_policy', 'setup_reader_autotune',
           'snapshot_delta']
