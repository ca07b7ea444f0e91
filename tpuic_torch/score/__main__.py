"""``python -m tpuic_torch.score``: the elastic bulk-scoring worker CLI."""

import sys

from tpuic_torch.score.driver import main

if __name__ == "__main__":
    sys.exit(main())
