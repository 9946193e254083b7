"""Run a cell with the control in the program's place and print whether
the check caught it. The control is the reference with one guarantee of
the configuration broken (each loop's ``control_patches``); a run with it
must come out ``correct`` false, or the check could not fail.

    python3 bench/control.py --workload <name> --seeds 1,2,3 --seconds 30

prints one JSON line per seed: ``correct`` and the numbers compared
beside their limits, from the same run and check as ``bench/run.py``.
The benchmark's own runs do not run it.
"""

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import torch  # noqa: E402

from harness import runner, spec  # noqa: E402


@contextlib.contextmanager
def planted(cell: spec.Cell, seed: int, device):
    """The control set in the program's place for the duration."""
    kind = importlib.import_module(f"loops.{cell.mix['kind']}")
    patches = kind.control_patches(cell, seed, device)
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    try:
        for owner, name, value in patches:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def run(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    """One run of ``cell`` with the control planted: its result line."""
    with planted(cell, seed, device):
        return runner.run(cell, seed, seconds, False, device,
                          time.monotonic())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run(cell, seed, args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": str(device), "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
