"""The benchmark's own tests: run on the CPU from the root of the checkout,

    python3 -m pytest portbench/tests -q

(the repository's ``tests/`` does not collect them).  Cases that need the
cards skip here, decided inside a fixture."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
