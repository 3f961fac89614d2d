"""``python -m petastorm_tpu_torch.analysis``: the pipecheck CLI entry point."""

import sys

from petastorm_tpu_torch.analysis.cli import main

if __name__ == '__main__':
    sys.exit(main())
