"""Write the PyTorch port's scenario presets as JSON, one file each.

    PYTHONPATH=src python scripts/torch_gen_scenarios.py --out DIR

Each file is the preset serialized at the current schema (v5), byte for
byte what the reference's ``SCENARIOS[name].save`` writes
(``tests/test_torch_api_specs.py`` holds the two equal).  The checked-in
``configs/scenarios/*.json`` were written at schema v3 and load through
the upgraders to the same specs in both packages; this script does not
rewrite them (``--out`` is required).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.api.scenarios import SCENARIOS  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory to write <scenario>.json into")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name, spec in sorted(SCENARIOS.items()):
        path = os.path.join(args.out, f"{name}.json")
        spec.save(path)
        print(f"wrote {os.path.relpath(path)}")


if __name__ == "__main__":
    main()
