import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
for path in (str(BENCH.parent / "src"), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)

torch.set_num_threads(1)
