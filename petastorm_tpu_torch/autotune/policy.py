"""Autotune policy: the constants of the closed control loop. A copy of
``petastorm_tpu.autotune.policy`` without ``warm_start`` (it seeds knobs from
the run-history store, which waits with the history plane).

One frozen dataclass holds every pacing/hysteresis parameter the
:class:`~petastorm_tpu_torch.autotune.controller.AutotuneController` consults, so a
policy can be passed through ``make_reader(autotune=AutotunePolicy(...))``,
logged verbatim into the decision stream, and compared across runs. The
defaults are deliberately conservative — the controller must never oscillate a
healthy pipeline: a 2s sampling window, one hold window per proposal, a 2%
relative-improvement hysteresis gate before any commit, and a multi-window
cooldown after every revert (the tf.data AUTOTUNE stance of changing one thing
at a time and measuring).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class AutotunePolicy:
    """Pacing and hysteresis of the closed-loop autotuner.

    :param window_s: telemetry sampling window — the controller wakes, samples
        rows/s and the stage histograms, and takes at most one action per
        window.
    :param warmup_windows: windows ignored after start (cold caches, pool
        spin-up) before the first proposal may fire.
    :param hold_windows: windows a proposed knob change is held before its
        rows/s effect is measured (lets in-flight work drain through the new
        setting).
    :param min_improvement: hysteresis gate — the relative rows/s gain a held
        proposal must show to be committed; anything less reverts. Prevents
        noise-chasing oscillation.
    :param cooldown_windows: windows a knob is barred from new proposals after
        a revert (or a bound pin) — the anti-oscillation half of hysteresis.
    :param freeze_cooldown_windows: windows the controller stays frozen after
        every circuit breaker has closed again (the safety interlock's
        re-entry delay).
    :param max_decisions: bound of the in-memory decision log surfaced by
        ``Reader.autotune_report()`` (every decision also goes to the JSONL
        event log when one is configured).
    :param knob_ids: explicit allowlist of knob ids the controller may turn;
        ``None`` = every live knob in the catalog. An empty tuple yields a
        measure-only controller (samples and reports, never actuates).
    """

    window_s: float = 2.0
    warmup_windows: int = 2
    hold_windows: int = 1
    min_improvement: float = 0.02
    cooldown_windows: int = 3
    freeze_cooldown_windows: int = 2
    max_decisions: int = 64
    knob_ids: Optional[Tuple[str, ...]] = None

    def __post_init__(self) -> None:
        if self.window_s <= 0:
            raise ValueError('window_s must be > 0, got {!r}'.format(self.window_s))
        if self.warmup_windows < 0 or self.hold_windows < 0:
            raise ValueError('warmup_windows/hold_windows must be >= 0')
        if self.min_improvement < 0:
            raise ValueError('min_improvement must be >= 0, got {!r}'
                             .format(self.min_improvement))
        if self.cooldown_windows < 1 or self.freeze_cooldown_windows < 0:
            raise ValueError('cooldown_windows must be >= 1 and '
                             'freeze_cooldown_windows >= 0')
        if self.max_decisions < 1:
            raise ValueError('max_decisions must be >= 1')


def resolve_policy(
        autotune: Union[bool, None, AutotunePolicy]) -> Optional[AutotunePolicy]:
    """The ONE normalization of the ``autotune`` reader argument: ``None``/
    ``False`` mean off (no controller object is ever built and no knob is
    touched), ``True`` means the default policy, and
    an :class:`AutotunePolicy` passes through."""
    if autotune is None or autotune is False:
        return None
    if autotune is True:
        return AutotunePolicy()
    if isinstance(autotune, AutotunePolicy):
        return autotune
    raise ValueError('autotune must be True/False/None or an AutotunePolicy, '
                     'got {!r}'.format(autotune))
