"""Throughput CLI: ``petastorm-tpu-torch-throughput`` or ``python -m
petastorm_tpu_torch.benchmark.cli``, the port of ``petastorm_tpu.benchmark.cli``.

Subcommands (a first positional argument):

- ``wire-bench``: :mod:`~petastorm_tpu_torch.benchmark.wire_bench` (data-plane
  micro-benchmark, one JSON line);
- ``decode-bench``: :mod:`~petastorm_tpu_torch.benchmark.decode_bench`
  (decode-engine micro-benchmark, one JSON line);
- ``costs``: :mod:`~petastorm_tpu_torch.telemetry.cost_model` (one
  trace-armed epoch folded into the per-rowgroup cost ledger, the expensive
  rowgroups and the what-if rows);
- ``analyze``: :mod:`~petastorm_tpu_torch.telemetry.analyze` (stage shares and
  the bottleneck's knob over a telemetry snapshot);
- ``trace``: :mod:`~petastorm_tpu_torch.telemetry.trace_export` (a flight
  recorder capture of a read as Chrome-trace JSON);
- ``doctor``: :mod:`~petastorm_tpu_torch.tools.doctor` (the environment
  health report);
- ``serve``: :func:`~petastorm_tpu_torch.service.fleet.serve` (an
  input-service fleet, dispatcher and decode workers, on this host until
  interrupted);
- ``lineage``: :mod:`~petastorm_tpu_torch.telemetry.lineage` (``record`` a
  lineage-armed epoch, ``verify`` a manifest by dry replay, ``diff`` two
  manifests to their first divergent step, an exit code per attribution);
- ``autopsy``: :mod:`~petastorm_tpu_torch.telemetry.incident` (rank the
  probable causes of one incident bundle);
- ``history``: :mod:`~petastorm_tpu_torch.telemetry.history` (``list``,
  ``show`` and ``compare`` the run records of a history store).

The JAX package's ``chaos`` and ``pipecheck`` wait for modules the port
does not have yet: each exits 2 with a line naming the module. Anything else is the dataset throughput
measurement, with ``--read-method torch`` (a ``TorchDataLoader`` onto
``--device``, the card by default) in place of the JAX package's ``jax``.
"""

import argparse
import logging
import sys

from petastorm_tpu_torch.benchmark.throughput import READ_PYTHON, READ_TORCH, reader_throughput

#: subcommand -> (module, function) of the port
SUBCOMMANDS = {
    'wire-bench': ('petastorm_tpu_torch.benchmark.wire_bench', 'main'),
    'decode-bench': ('petastorm_tpu_torch.benchmark.decode_bench', 'main'),
    'costs': ('petastorm_tpu_torch.telemetry.cost_model', 'main'),
    'analyze': ('petastorm_tpu_torch.telemetry.analyze', 'main'),
    'trace': ('petastorm_tpu_torch.telemetry.trace_export', 'main'),
    'doctor': ('petastorm_tpu_torch.tools.doctor', 'main'),
    'serve': ('petastorm_tpu_torch.service.fleet', 'serve'),
    'lineage': ('petastorm_tpu_torch.telemetry.lineage', 'main'),
    'autopsy': ('petastorm_tpu_torch.telemetry.incident', 'main'),
    'history': ('petastorm_tpu_torch.telemetry.history', 'main'),
}

#: the JAX package's subcommands whose modules the port lacks -> that module
NOT_PORTED = {
    'chaos': 'petastorm_tpu.test_util.chaos',
    'pipecheck': 'petastorm_tpu.analysis',
}


def main(argv=None):
    """``petastorm-tpu-torch-throughput`` entry: dispatch a subcommand, else
    parse the arguments, run
    :func:`~petastorm_tpu_torch.benchmark.throughput.reader_throughput` and
    print the report."""
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in SUBCOMMANDS:
        import importlib
        module, function = SUBCOMMANDS[argv[0]]
        return getattr(importlib.import_module(module), function)(argv[1:])
    if argv and argv[0] in NOT_PORTED:
        print('{}: not in petastorm_tpu_torch yet; it waits for a port of {}'.format(
            argv[0], NOT_PORTED[argv[0]]), file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(
        description='Measure petastorm_tpu_torch reader throughput on a dataset')
    parser.add_argument('dataset_url')
    parser.add_argument('-f', '--field-regex', nargs='+',
                        help='read only fields matching these regexes')
    parser.add_argument('-w', '--workers-count', type=int, default=3)
    parser.add_argument('-p', '--pool-type', choices=['thread', 'process', 'dummy'],
                        default='thread')
    parser.add_argument('-m', '--warmup-cycles', type=int, default=200)
    parser.add_argument('-n', '--measure-cycles', type=int, default=1000)
    parser.add_argument('-d', '--read-method', choices=[READ_PYTHON, READ_TORCH],
                        default=READ_PYTHON)
    parser.add_argument('--device', default=None,
                        help="the torch read method's device: cuda (default) or cpu")
    parser.add_argument('--in-process', action='store_true',
                        help='measure in THIS interpreter instead of a spawned one '
                             '(the default spawns, for a clean RSS reading)')
    parser.add_argument('--torch-batch-size', type=int, default=256)
    parser.add_argument('--no-shuffle-row-groups', action='store_true')
    parser.add_argument('--profile-threads', action='store_true',
                        help='sampled cProfile across thread-pool workers (one shared '
                             'profiler slot on py3.12+); aggregate logged on shutdown')
    parser.add_argument('--ngram-length', type=int,
                        help='measure NGram windows/sec with windows of this many '
                             'timesteps instead of plain rows')
    parser.add_argument('--ngram-ts-field',
                        help='timestamp field ordering the NGram windows')
    parser.add_argument('--ngram-delta-threshold', type=int,
                        help='max timestamp gap between consecutive window timesteps '
                             '(default: unbounded)')
    parser.add_argument('--pack-field',
                        help='measure packed-bin formation: pack this native list '
                             'column inside the batch-reader workers '
                             '(ops.packing.make_packing_transform)')
    parser.add_argument('--pack-seq-len', type=int,
                        help='bin length for --pack-field')
    parser.add_argument('-v', '--verbose', action='store_true')
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    result = reader_throughput(
        args.dataset_url, field_regex=args.field_regex,
        warmup_cycles_count=args.warmup_cycles,
        measure_cycles_count=args.measure_cycles, pool_type=args.pool_type,
        loaders_count=args.workers_count, read_method=args.read_method,
        shuffle_row_groups=not args.no_shuffle_row_groups,
        torch_batch_size=args.torch_batch_size, spawn_new_process=not args.in_process,
        profile_threads=args.profile_threads, ngram_length=args.ngram_length,
        ngram_ts_field=args.ngram_ts_field,
        ngram_delta_threshold=args.ngram_delta_threshold,
        pack_field=args.pack_field, pack_seq_len=args.pack_seq_len, device=args.device)
    unit = ('windows/sec' if args.ngram_length
            else 'bins/sec' if args.pack_field else 'samples/sec')
    print('Throughput: {:.2f} {}; RSS: {:.2f} MB; CPU: {:.2f}%{}'.format(
        result.samples_per_second, unit, result.memory_info.rss / (1 << 20), result.cpu,
        '; input-stall: {:.1%}'.format(result.input_stall_fraction)
        if result.input_stall_fraction else ''))
    return 0


if __name__ == '__main__':
    sys.exit(main())
