"""The benchmark's CPU tests: ``python -m pytest azbench/tests -o addopts=""``
from the root of the repo. Tests marked ``cuda`` skip without a card."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
