"""Readings that set the limits of a cell's output check. Not run by the
benchmark's own runs.

    python portbench/control.py --workload <cell> --seeds 1,2,3 [--faults 3]

For each seed: the program's first steps as a run makes them, judged
against the reference (the lower readings); and, on the first ``--faults``
seeds, with the same batches and initial weights:

- ``control``: the reference itself in the program's place, one precision
  lower than the configuration states (the workload's ``control``: fp8
  operands for the products run in bfloat16, TF32 for those run in float32);
- ``half_batch``: the reference in the program's place, its loss the mean
  over the first half of each batch;
- ``unchanged``: a step that leaves the weights as they were (no run: every
  change reads 0);
- ``altered``: one answer altered where it is produced (one pixel of the
  first image by 32 steps, or one token of the first bin), through the
  batch checks.

One JSON line a seed on standard output.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def altered_copy(captured, workload):
    """The captured batches with one answer altered where the loader
    produced it: the first pixel of the first image up 32 steps of 255, or
    the first token of the first bin changed."""
    batches = [dict(batch) for batch in captured]
    first = batches[0]
    if 'image' in first:
        image = first['image'].clone()
        image[0, 0, 0, 0] += 32.0 / 255.0 / workload['load']['normalize'][1][0]
        first['image'] = image
    else:
        tokens = first['tokens'].copy()
        tokens[0, 0] = (tokens[0, 0] + 1) % workload['data']['vocab']
        first['tokens'] = tokens
    return batches


def fault_readings(program, readings, device, precision):
    from portbench.tasks import common
    with common.exact_float32():
        reference = program.follow(device)
        control = program.follow(device, precision=precision)
        half = program.follow(device, rows=slice(0, program.batch_size // 2))
        out = {'control': common.training_gaps(control, reference),
               'half_batch': common.training_gaps(half, reference),
               'unchanged': common.training_gaps(
                   dict(readings, change_norms={n: 0.0 for n in readings['change_norms']}),
                   reference)}
        out['control']['logit_gap'] = common.logit_gap(
            program.reference_logits(device, precision), program.reference_logits(device))
    out['altered'] = program.batch_checks(device,
                                          altered_copy(program.captured, program.workload))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--faults', type=int, default=3)
    args = parser.parse_args(argv)
    sys.path[0] = REPO
    import torch
    from portbench import harness
    from portbench.reference.precision import Precision
    cell = harness.Cell(REPO, args.workload)
    precision = Precision(**cell.workload['control'])
    program_class = harness.program_class_of(cell.config)
    for index, seed in enumerate(int(s) for s in args.seeds.split(',')):
        started = time.perf_counter()
        program = program_class(cell.config, cell.workload, seed, 'cuda',
                                harness.data_cache(REPO))
        readings = harness.first_steps(program)
        program.close()
        torch.cuda.empty_cache()
        line = {'seed': seed, 'program': program.judge(readings, 'cuda')}
        if index < args.faults:
            line.update(fault_readings(program, readings, 'cuda', precision))
        line['seconds'] = time.perf_counter() - started
        print(json.dumps(line), flush=True)
        del program
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
