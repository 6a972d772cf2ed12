"""The benchmark's own tests run on the CPU, from the checkout's root
(``python -m pytest fluidbench/tests``); the program is imported from
there."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
