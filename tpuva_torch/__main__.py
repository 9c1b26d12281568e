"""`python -m tpuva_torch` — the port's command line (see tpuva_torch/cli.py)."""

import sys

from tpuva_torch.cli import main

sys.exit(main())
