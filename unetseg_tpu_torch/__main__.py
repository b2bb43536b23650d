"""python -m unetseg_tpu_torch preprocess|train (see cli/main.py)."""

import sys

from unetseg_tpu_torch.cli.main import main

sys.exit(main())
