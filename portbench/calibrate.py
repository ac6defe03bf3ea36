#!/usr/bin/env python3
"""The readings a cell's limit is set from, in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --seconds <s> [--control-seeds 7,8,9] [--control-seconds <s>]

For each of ``--seeds``, one run of the program as the benchmark runs it
(without printing a result): its ``out_gap`` is a lower reading. For each
of ``--control-seeds``, the same run with the control in the program's
place: the plain reference computed in TF32 (``reference/common.py``
``Precision``), the nearest precision below the configurations' float32
with TF32 off; its ``out_gap`` is an upper reading. One JSON line per run
on standard output. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import run  # noqa: E402
from portbench.reference.common import Precision  # noqa: E402


def control(node: str):
    """What ``run_cell`` puts in the program's place for the control."""
    import importlib
    mod = importlib.import_module(f"portbench.reference.{node}")

    def serve(cfg, thetas, hop, fs, dev):
        return mod.Serve(mod.Reference(cfg, thetas, hop, fs, dev,
                                       Precision("tf32")))
    return serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    node = run.load_cell(args.workload)["cfg"]["node"]
    plan = ([("program", int(s), args.seconds, None)
             for s in args.seeds.split(",") if s]
            + [("control", int(s), args.control_seconds, control(node))
               for s in args.control_seeds.split(",") if s])
    for side, seed, seconds, serve in plan:
        t0 = time.perf_counter()
        out = run.run_cell(args.workload, seed, seconds, False, serve=serve,
                           t_start=t0)
        print(json.dumps({"workload": args.workload, "side": side,
                          "seed": seed, "out_gap": out["checks"]["out_gap"],
                          "attempted": out["attempted"],
                          "metrics": out["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
