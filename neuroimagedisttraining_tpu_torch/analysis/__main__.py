"""Entry point: ``python -m neuroimagedisttraining_tpu_torch.analysis <paths>``."""

import sys

from neuroimagedisttraining_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
