"""pipecheck rule registry: the shipped rule families, by name.

Rules register here so the CLI (``--rules``, ``--list-rules``), the doctor
summary and the smoke's phase 22 all see one canonical set. Adding a rule =
subclass :class:`petastorm_tpu_torch.analysis.core.Rule` in a module under this
package and list it in :data:`ALL_RULES` (docs/static-analysis.md "Adding a
rule").
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Type

from petastorm_tpu_torch.analysis.core import Rule
from petastorm_tpu_torch.analysis.rules.clock import ClockDisciplineRule
from petastorm_tpu_torch.analysis.rules.determinism import DeterminismRule
from petastorm_tpu_torch.analysis.rules.exceptions import ExceptionHygieneRule
from petastorm_tpu_torch.analysis.rules.journal import JournalDisciplineRule
from petastorm_tpu_torch.analysis.rules.lifecycle import ResourceLifecycleRule
from petastorm_tpu_torch.analysis.rules.locks import LockDisciplineRule
from petastorm_tpu_torch.analysis.rules.protocol import ProtocolConformanceRule
from petastorm_tpu_torch.analysis.rules.ratchet import MypyRatchetRule
from petastorm_tpu_torch.analysis.rules.telemetry_names import TelemetryNamesRule

#: every shipped rule class, in the order reports list them
ALL_RULES: List[Type[Rule]] = [
    ProtocolConformanceRule,
    TelemetryNamesRule,
    ClockDisciplineRule,
    ExceptionHygieneRule,
    LockDisciplineRule,
    ResourceLifecycleRule,
    DeterminismRule,
    JournalDisciplineRule,
    MypyRatchetRule,
]

#: rule name -> class
RULES_BY_NAME: Dict[str, Type[Rule]] = {cls.name: cls for cls in ALL_RULES}


def default_rules(names: Optional[Sequence[str]] = None) -> List[Rule]:
    """Instantiate the shipped rules; ``names`` (when given) selects a
    subset and raises ``ValueError`` on an unknown rule name."""
    if names is None:
        return [cls() for cls in ALL_RULES]
    unknown = [name for name in names if name not in RULES_BY_NAME]
    if unknown:
        raise ValueError('unknown rule(s) {}; known: {}'.format(
            unknown, sorted(RULES_BY_NAME)))
    return [RULES_BY_NAME[name]() for name in names]
