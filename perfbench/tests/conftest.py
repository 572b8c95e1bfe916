"""The benchmark's own tests (``python -m pytest perfbench/tests`` from
the root of the checkout): the harness and its references on the CPU at
smoke sizes; a case that needs the card is marked ``cuda`` and skips
inside the test without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
