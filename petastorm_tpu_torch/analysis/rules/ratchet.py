"""mypy-ratchet: the strict-module manifest and mypy.ini may only move
together, forward (the port of ``petastorm_tpu.analysis.rules.ratchet``).

The repo types new modules strictly (full signatures, no implicit Any) and
records each promotion as a ``[mypy-<module>]`` section with the four strict
flags (``analysis/config.py: STRICT_FLAGS``). Nothing stops a later refactor
from quietly dropping a section — mypy would simply check less. The ratchet
pins the floor:

- ``analysis/strict_modules.txt`` (one module pattern per line, ``#``
  comments allowed) is the checked-in manifest of promoted modules;
- every manifest entry must have a ``[mypy-<entry>]`` section in ``mypy.ini``
  with all strict flags true — a dropped/weakened section is a finding;
- every mypy.ini section that already has all strict flags true, and whose
  module pattern lies in the analyzed package, must be in the manifest —
  that is how the manifest grows in the same commit as the promotion;
- the manifest must be sorted and duplicate-free (merge-conflict hygiene).

Shrinking the manifest itself cannot be seen statically (no git history at
analysis time) — that half of the ratchet is what scrutiny of a
``strict_modules.txt`` deletion is for; this rule makes the deletion loud by
forcing it to be explicit.

``mypy.ini`` is located by walking up from the analyzed roots (override:
``--mypy-ini``); when none is found the rule is skipped with a note — e.g.
when pipecheck runs against an installed site-packages tree.

Defined difference from the JAX package's rule: one ``mypy.ini`` holds the
sections of both packages, so the "must be in the manifest" check considers
only the sections whose module pattern lies in the analyzed package, matched
by whole dotted components (``petastorm_tpu_torch.x`` is not in
``petastorm_tpu``). The packages are the dotted names of the analyzed roots
that are packages, else this one (a fixture or temp tree is no package). Over the JAX package with its own
manifest the verdict is the JAX rule's.
"""

from __future__ import annotations

import configparser
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from petastorm_tpu_torch.analysis.core import AnalysisContext, Finding, Rule

#: packaged manifest location (next to this rules package)
DEFAULT_MANIFEST = Path(__file__).resolve().parent.parent / 'strict_modules.txt'
#: the package this analyzer ships in: the ratchet's scope over trees that
#: are no package
OWN_PACKAGE = __name__.split('.')[0]


def read_manifest(path: Path) -> List[str]:
    """Manifest entries (one per line, ``#`` comments and blanks skipped)."""
    entries = []
    for raw in path.read_text(encoding='utf-8').splitlines():
        line = raw.split('#', 1)[0].strip()
        if line:
            entries.append(line)
    return entries


def locate_mypy_ini(roots: Iterable[Path]) -> Optional[Path]:
    """Walk up (3 levels) from each analyzed root looking for ``mypy.ini``."""
    for root in roots:
        base = root if root.is_dir() else root.parent
        for candidate_dir in [base, *list(base.parents)[:3]]:
            candidate = candidate_dir / 'mypy.ini'
            if candidate.is_file():
                return candidate
    return None


def root_package(root: Path) -> Optional[str]:
    """The dotted package name of an analyzed root (a directory, or a file's
    directory, holding ``__init__.py``, named up through every parent that
    holds one too), else None."""
    base = root if root.is_dir() else root.parent
    base = base.resolve()
    if not (base / '__init__.py').is_file():
        return None
    parts = [base.name]
    parent = base.parent
    while (parent / '__init__.py').is_file() and parent != parent.parent:
        parts.insert(0, parent.name)
        parent = parent.parent
    return '.'.join(parts)


def ratchet_scope(roots: Sequence[Path]) -> Set[str]:
    """The packages whose strict sections the ratchet requires in the
    manifest (see the module doc)."""
    packages = {name for name in (root_package(root) for root in roots) if name}
    return packages or {OWN_PACKAGE}


def pattern_in_scope(pattern: str, packages: Set[str]) -> bool:
    """True when a section's module pattern lies in one of ``packages``, by
    whole dotted components (a trailing ``.*`` names the package itself)."""
    name = pattern[:-2] if pattern.endswith('.*') else pattern
    return any(name == package or name.startswith(package + '.')
               for package in packages)


class MypyRatchetRule(Rule):
    """Manifest/mypy.ini strict-section consistency (module doc)."""

    name = 'mypy-ratchet'
    description = ('the strict-module manifest (analysis/strict_modules.txt) '
                   'and mypy.ini strict sections must stay in lockstep; '
                   'strict coverage can only grow')

    def finalize(self, ctx: AnalysisContext) -> Iterable[Finding]:
        manifest_path = (Path(ctx.config.manifest_path)
                         if ctx.config.manifest_path else DEFAULT_MANIFEST)
        if not manifest_path.is_file():
            return [Finding(self.name, manifest_path.as_posix(), 1,
                            'strict-module manifest not found — the mypy '
                            'ratchet has no floor to enforce')]
        mypy_path = (Path(ctx.config.mypy_ini_path)
                     if ctx.config.mypy_ini_path
                     else locate_mypy_ini(ctx.roots))
        if mypy_path is None or not mypy_path.is_file():
            # not a source checkout; nothing to ratchet against — but say so:
            # a skipped check must never read as a passed one
            ctx.notes.append(
                'mypy-ratchet did NOT run: no mypy.ini found near the '
                'analyzed paths (pass --mypy-ini to point at one)')
            return []
        entries = read_manifest(manifest_path)
        findings: List[Finding] = []
        findings.extend(self._check_manifest_hygiene(manifest_path, entries))
        parser = configparser.ConfigParser()
        try:
            parser.read(mypy_path, encoding='utf-8')
        except configparser.Error as exc:
            return findings + [Finding(
                self.name, mypy_path.as_posix(), 1,
                'mypy.ini is unparseable: {!r}'.format(exc))]
        strict_sections = self._strict_sections(parser, ctx)
        manifest_display = manifest_path.as_posix()
        mypy_display = mypy_path.as_posix()
        for entry in entries:
            section = 'mypy-' + entry
            if not parser.has_section(section):
                findings.append(Finding(
                    self.name, mypy_display, 1,
                    'strict module {!r} is in the ratchet manifest but '
                    '[{}] is missing from mypy.ini — strict coverage may '
                    'only grow'.format(entry, section)))
                continue
            missing = [flag for flag in ctx.config.strict_flags
                       if not parser.getboolean(section, flag, fallback=False)]
            if missing:
                findings.append(Finding(
                    self.name, mypy_display, 1,
                    'strict section [{}] no longer sets {} — the ratchet '
                    'forbids weakening a promoted module'.format(
                        section, ', '.join(missing))))
        for entry in sorted(strict_sections - set(entries)):
            findings.append(Finding(
                self.name, manifest_display, 1,
                'mypy.ini promotes {!r} to strict but the ratchet manifest '
                'does not list it — add it to strict_modules.txt so the '
                'promotion cannot be silently reverted'.format(entry)))
        return findings

    def _strict_sections(self, parser: configparser.ConfigParser,
                         ctx: AnalysisContext) -> set:
        scope = ratchet_scope(ctx.roots)
        out = set()
        for section in parser.sections():
            if not section.startswith('mypy-'):
                continue
            if not pattern_in_scope(section[len('mypy-'):], scope):
                continue
            if all(parser.getboolean(section, flag, fallback=False)
                   for flag in ctx.config.strict_flags):
                out.add(section[len('mypy-'):])
        return out

    def _check_manifest_hygiene(self, path: Path,
                                entries: List[str]) -> List[Finding]:
        findings = []
        display = path.as_posix()
        if entries != sorted(entries):
            findings.append(Finding(
                self.name, display, 1,
                'manifest entries are not sorted — keep them ordered so '
                'merges stay conflict-free'))
        duplicates: List[Tuple[str, int]] = []
        seen = set()
        for index, entry in enumerate(entries, start=1):
            if entry in seen:
                duplicates.append((entry, index))
            seen.add(entry)
        for entry, index in duplicates:
            findings.append(Finding(
                self.name, display, index,
                'duplicate manifest entry {!r}'.format(entry)))
        return findings
