"""The readings that a cell's limits are set from: the program's on many
seeds, and the control's, the plain reference computed in the precision
below the configuration's, put in the program's place.

    python3 -m portbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 10] [--json FILE]

In one process on the card: the program is set up once and driven for
--seconds with each seed, and each window is checked as a benchmark run
checks it; then the control (the traffic driver's "float32-reference"
program) is driven with each control seed for one runner call, its check
sampling about as many epochs as a benchmark run compares. Prints one JSON
object: each compared number's readings per seed, the lower reading (the
largest the program gave) and the upper (the smallest the control gave). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from portbench.run import ROOT, cell, load_spec


def readings(workload: str, seeds: list, control_seeds: list,
             seconds: float, device=None, root=ROOT,
             control_stride: int = 75) -> dict:
    import torch

    _, cfg, traffic = cell(load_spec(root), workload, root)
    if device is None:
        device = torch.device("cuda", 0)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")

    def one(prog, seed, traffic, seconds):
        win = driver.window(prog, traffic, seconds, seed)
        chk = driver.check(cfg, traffic, root, win, device)
        return {"seed": seed, "failed": chk.failed,
                "epochs_compared": len(win.kept),
                **{k: v for k, (v, _) in chk.numbers.items()}}

    prog = driver.setup(cfg, traffic, root, device, "port")
    program = [one(prog, s, traffic, seconds) for s in seeds]
    driver.free(prog)
    dense = dict(traffic, check_stride_epochs=control_stride)
    ctrl = driver.setup(cfg, traffic, root, device, "float32-reference")
    control = [one(ctrl, s, dense, 0.0) for s in control_seeds]
    names = list(driver.LIMITS)
    return {
        "workload": workload, "program": program, "control": control,
        "lower": {n: max(r[n] for r in program) for n in names},
        "upper": {n: min(r[n] for r in control) for n in names},
        "limits": dict(driver.LIMITS),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    out = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                   [int(s) for s in args.control_seeds.split(",")],
                   args.seconds)
    text = json.dumps(out)
    if args.json:
        with open(args.json, "w") as fp:
            fp.write(text + "\n")
    print(json.dumps({k: out[k] for k in ("workload", "lower", "upper",
                                          "limits")}), file=sys.stderr)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
