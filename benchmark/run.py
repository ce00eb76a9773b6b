"""Runs one cell of the port's benchmark once (see harness/core.py):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It drives ribodetector_tpu_torch on the CUDA card it is started on, and
fails with no result where torch sees no card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
