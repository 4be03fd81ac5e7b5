"""Puts the benchmark's directory and the program's ``src`` on the path
for the benchmark's own tests; the tiny cell they run."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DATA = BENCH / "tests" / "data"
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def run_tiny(seed: int = 7, seconds: float = 0.5, trace: bool = False):
    import harness
    return harness.run_cell(REPO, "tiny.prune", seed, seconds, trace,
                            device="cpu", manifest_path=DATA / "manifest.json",
                            data_dir=DATA)
