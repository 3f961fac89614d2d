"""pipecheck CLI of the port: ``python -m petastorm_tpu_torch.analysis
[paths...]``, the port of ``petastorm_tpu.analysis.cli``.

Also reachable as ``petastorm-tpu-torch-throughput pipecheck`` and the
``petastorm-tpu-torch-pipecheck`` console script. With no paths, analyzes the
installed ``petastorm_tpu_torch`` package — the self-application mode the
tests keep green. Exit codes: 0 clean, 1 findings, 2 usage error.

    $ petastorm-tpu-torch-pipecheck                      # self-check the package
    $ petastorm-tpu-torch-pipecheck path/to/tree --json  # machine-readable
    $ petastorm-tpu-torch-pipecheck --rules clock-discipline,mypy-ratchet src/
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from typing import List, Optional, Sequence, Set

from petastorm_tpu_torch.analysis.config import AnalysisConfig, default_config
from petastorm_tpu_torch.analysis.core import Report, run_analysis
from petastorm_tpu_torch.analysis.rules import ALL_RULES, default_rules


def package_root() -> Path:
    """The installed ``petastorm_tpu_torch`` package directory (the default
    analysis target), found from this file: nothing is imported for it."""
    return Path(__file__).absolute().parent.parent


def run_pipecheck(paths: Optional[Sequence[str]] = None,
                  rules: Optional[Sequence[str]] = None,
                  mypy_ini: Optional[str] = None,
                  manifest: Optional[str] = None,
                  diff_base: Optional[str] = None) -> Report:
    """Programmatic entry (doctor, smoke, tests): analyze ``paths`` (default:
    the installed package) with the shipped rules and return the
    :class:`~petastorm_tpu_torch.analysis.core.Report`.

    ``diff_base`` restricts the *reported* findings to files changed vs the
    given git ref — the analysis itself still runs over the whole tree
    (cross-file rules need full context), so the filter narrows the output
    without weakening the checks."""
    config = default_config()
    if mypy_ini is not None or manifest is not None:
        config = AnalysisConfig(mypy_ini_path=mypy_ini, manifest_path=manifest)
    targets = [Path(p) for p in paths] if paths else [package_root()]
    report = run_analysis(targets, default_rules(rules), config)
    if diff_base is not None:
        report = _restrict_to_diff(report, diff_base, targets)
    return report


def _changed_paths(diff_base: str, targets: Sequence[Path]) -> Set[str]:
    """Repo-relative posix paths changed vs ``diff_base`` in the repo(s)
    owning ``targets``. Raises ``ValueError`` when git cannot diff (bad
    ref, not a repository) — surfaced as a usage error (exit 2)."""
    changed: Set[str] = set()
    seen_tops: Set[str] = set()
    for target in targets:
        anchor = target if target.is_dir() else target.parent
        try:
            top = subprocess.run(
                ['git', '-C', str(anchor), 'rev-parse', '--show-toplevel'],
                capture_output=True, text=True, check=True).stdout.strip()
            if top in seen_tops:
                continue
            seen_tops.add(top)
            diff = subprocess.run(
                ['git', '-C', top, 'diff', '--name-only', diff_base, '--'],
                capture_output=True, text=True, check=True).stdout
        except (OSError, subprocess.CalledProcessError) as exc:
            stderr = getattr(exc, 'stderr', '') or ''
            raise ValueError(
                '--diff-base {!r}: git diff failed under {} ({})'.format(
                    diff_base, anchor, stderr.strip() or exc))
        changed.update(line.strip() for line in diff.splitlines()
                       if line.strip())
    return changed


def _restrict_to_diff(report: Report, diff_base: str,
                      targets: Sequence[Path]) -> Report:
    """Drop findings whose file did not change vs ``diff_base`` (matched by
    path suffix either way, so display paths and repo-relative git paths
    agree without a common anchor)."""
    changed = _changed_paths(diff_base, targets)

    def touched(display: str) -> bool:
        for path in changed:
            if (display == path or display.endswith('/' + path)
                    or path.endswith('/' + display)):
                return True
        return False

    kept = [finding for finding in report.findings
            if touched(finding.path)]
    note = ('--diff-base {}: reporting {} of {} finding(s) in {} changed '
            'file(s)'.format(diff_base, len(kept), len(report.findings),
                             len(changed)))
    return replace(report, findings=kept,
                   notes=list(report.notes) + [note])


def build_parser() -> argparse.ArgumentParser:
    """The pipecheck argument parser (split out for doc/tests)."""
    parser = argparse.ArgumentParser(
        prog='pipecheck',
        description='AST-based invariant analyzer for the petastorm_tpu_torch '
                    'cross-process data plane (docs/static-analysis.md)')
    parser.add_argument('paths', nargs='*',
                        help='files/directories to analyze (default: the '
                             'installed petastorm_tpu_torch package)')
    parser.add_argument('--json', action='store_true',
                        help='print one JSON document instead of the '
                             'flake8-style listing')
    parser.add_argument('--rules',
                        help='comma-separated rule subset (see --list-rules)')
    parser.add_argument('--diff-base', metavar='REF',
                        help='report only findings in files changed vs this '
                             'git ref (analysis still runs whole-program; '
                             'keeps the CI gate fast as the tree grows)')
    parser.add_argument('--list-rules', action='store_true',
                        help='print the rule catalog and exit')
    parser.add_argument('--mypy-ini',
                        help='explicit mypy.ini path for the mypy-ratchet '
                             'rule (default: walk up from the analyzed '
                             'paths)')
    parser.add_argument('--manifest',
                        help='explicit strict-module manifest path (default: '
                             'the packaged analysis/strict_modules.txt)')
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Console entry: parse args, run the analysis, print, return the exit
    code (0 clean / 1 findings / 2 usage error)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.list_rules:
        for cls in ALL_RULES:
            print('{:24s} {}'.format(cls.name, cls.description))
        return 0
    selected: Optional[List[str]] = None
    if args.rules:
        selected = [name.strip() for name in args.rules.split(',')
                    if name.strip()]
    try:
        report = run_pipecheck(paths=args.paths or None, rules=selected,
                               mypy_ini=args.mypy_ini,
                               manifest=args.manifest,
                               diff_base=args.diff_base)
    except ValueError as exc:
        print('pipecheck: {}'.format(exc), file=sys.stderr)
        return 2
    print(report.to_json() if args.json else report.format_human())
    return 0 if report.clean else 1


if __name__ == '__main__':
    sys.exit(main())
