"""The benchmark's CPU tests: run from the repository's root with
``python -m pytest benchmark/tests -q``. They need no card and no JAX."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
