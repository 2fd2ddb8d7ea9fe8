"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository root (on the card: ``-m cuda`` runs the tests that need it).
They put ``benchmark/`` and the root on the path, as ``run.py`` does."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
