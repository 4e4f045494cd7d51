"""The harness's modules import as the benchmark's command imports them:
``benchmark/`` and the checkout's root on ``sys.path``."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent.parent, HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
