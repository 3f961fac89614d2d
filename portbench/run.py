"""Run one cell of the benchmark of ``petastorm_tpu_torch`` and print its
result as one JSON line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics. The numbers the output check compared follow on
standard error, each beside its limit.
"""

import os
import sys
import time


def _process_age():
    """Seconds since this process started, from /proc (0 where it is not)."""
    try:
        with open('/proc/self/stat') as f:
            started_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return max(uptime - started_ticks / os.sysconf('SC_CLK_TCK'), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


STARTED = time.perf_counter() - _process_age()

import argparse  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # imports start at the checkout's root, not at this script's directory
    sys.path[0] = REPO
    caches = os.path.join(REPO, 'portbench_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(caches, 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(caches, 'triton')
    from portbench import harness
    return harness.main(args, STARTED)


if __name__ == '__main__':
    sys.exit(main())
