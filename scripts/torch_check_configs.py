"""config-check for the PyTorch port: validate every JSON under configs/
with the port's ``RunSpec`` (strict — unknown keys, bad choices and
cross-field violations all fail), and pin the scenario files to the
port's preset registry.

    PYTHONPATH=src python scripts/torch_check_configs.py

Exits non-zero on the first kind of failure it finds (every failing file
is listed).  ``tests/test_torch_api_specs.py`` runs it.
"""
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.api.scenarios import SCENARIOS  # noqa: E402
from repro_torch.api.specs import RunSpec, SpecError  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> int:
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.json"),
                             recursive=True))
    if not paths:
        print("config-check: no JSON configs found under configs/",
              file=sys.stderr)
        return 1
    failed = False
    for path in paths:
        rel = os.path.relpath(path, REPO)
        try:
            spec = RunSpec.load(path)
        except SpecError as e:
            print(f"FAIL {rel}: {e}", file=sys.stderr)
            failed = True
            continue
        name = os.path.splitext(os.path.basename(path))[0]
        if (os.path.basename(os.path.dirname(path)) == "scenarios"
                and spec != SCENARIOS.get(name)):
            print(f"FAIL {rel}: drifted from repro_torch.api.scenarios "
                  f"preset {name!r}", file=sys.stderr)
            failed = True
            continue
        print(f"ok   {rel}")
    scenario_files = {os.path.splitext(os.path.basename(p))[0]
                      for p in paths
                      if os.path.basename(os.path.dirname(p)) == "scenarios"}
    missing = sorted(set(SCENARIOS) - scenario_files)
    if missing:
        print(f"FAIL configs/scenarios/ missing presets {missing}",
              file=sys.stderr)
        failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
