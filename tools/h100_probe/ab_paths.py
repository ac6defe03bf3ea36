#!/usr/bin/env python3
"""Device time per call of the port's main paths, and of the WOLA analysis
kernel, for two checkouts of the repo, in turns, on one NVIDIA GPU.

    python3 tools/h100_probe/ab_paths.py PARENT_ROOT [CHANGE_ROOT] [--pairs N]

Both checkouts first build their kernels from their own sources, side by
side. Then each checkout's package and chip_smoke.py run in processes of
their own, N pairs (default 10) in the order parent, change, change,
parent, ... Each process drives, on chip_smoke.py's noise input (aira16's
16 mics, 48 kHz, 30 s), the device-resident call ``model.process`` of DAS,
MVDR ``auto`` and LCMV ``auto`` (one slot), phase, phasempf and mcra under
the launch presets, and GSC ``sample``, ``block`` and ``blocklms`` (l =
128): the time of one call is CUDA events around it, median of 10 after 3
warm-ups (GSC: of 3 after 1). It
also times ``kernels.wola.wola_analysis`` (C = 16, T = 1407 and T = 64,
with and without the gate statistic, seeded noise) and ``torch.stft``
on the same frames as chip_smoke.py's ``cuda_ms`` does (one call between
two events, median of 20). CHANGE_ROOT defaults to this checkout. Prints
one line per process, then per metric both sides' medians and ranges;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# (label, node, parameters over the launch preset, timed calls)
PATHS = (("das", "das", None, 10), ("mvdr", "mvdr", {}, 10),
         ("lcmv", "lcmv", {}, 10), ("phase", "phase", {}, 10),
         ("phasempf", "phasempf", {}, 10), ("mcra", "mcra", {}, 10),
         ("gsc", "gsc", {"write_mu": False}, 3),
         ("gsc block", "gsc", {"write_mu": False, "solver": "block"}, 3),
         ("gsc blocklms", "gsc", {"write_mu": False, "solver": "blocklms"},
          3))
ANALYSIS_T = (1407, 64)


def worker(root: str) -> dict:
    """The device time per call (ms) of each path and analysis shape, in
    this process."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from beamform_tpu_torch.dsp.wola import sqrt_hann
    from beamform_tpu_torch.kernels import wola as kw
    from beamform_tpu_torch.models import get_model
    x = torch.as_tensor(cs.make_input(16, cs.SECONDS), device="cuda")
    out = {}
    for label, node, over, reps in PATHS:
        params = None if over is None else cs.preset(node, **over)
        model = get_model(node, cs.engine(), cs.aira16(), params,
                          device="cuda")
        for _ in range(3 if reps > 3 else 1):
            model.process(x, cs.THETA)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            model.process(x, cs.THETA)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[label] = float(np.median(times))
        del model
    hop = cs.HOP
    win = torch.as_tensor(sqrt_hann(2 * hop), dtype=torch.float32,
                          device="cuda")
    rng = np.random.default_rng(1)
    for t in ANALYSIS_T:
        xt = torch.as_tensor(0.1 * rng.standard_normal((16, t * hop)),
                             dtype=torch.float32, device="cuda")
        tail = torch.as_tensor(0.1 * rng.standard_normal((16, hop)),
                               dtype=torch.float32, device="cuda")
        for with_mag in (False, True):
            out[f"analysis T={t}{' mag' if with_mag else ''}"] = cs.cuda_ms(
                lambda: kw.wola_analysis(xt, tail, with_mag))
        ext = torch.cat([tail, xt], dim=-1)
        out[f"torch.stft T={t}"] = cs.cuda_ms(
            lambda: torch.stft(ext, n_fft=2 * hop, hop_length=hop,
                               window=win, center=False,
                               return_complex=True))
    return out


def build(roots) -> None:
    """Build each checkout's kernel library, all at once."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from beamform_tpu_torch.kernels._build "
         "import build; build()"], cwd=root) for root in roots]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("a kernel build failed")


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    roots = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build(roots.values())
    order = [("parent", "change") if i % 2 == 0 else ("change", "parent")
             for i in range(args.pairs)]
    runs = {"parent": [], "change": []}
    for label in (lab for pair in order for lab in pair):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", roots[label]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(res)
        print(f"{label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                       res.items()), flush=True)
    print(f"{args.pairs} pairs of processes on {card}; per metric: median "
          "[min, max] over the processes of each side, ms")
    for key in runs["parent"][0]:
        p = np.array([r[key] for r in runs["parent"]])
        c = np.array([r[key] for r in runs["change"]])
        print(f"{key}: parent {np.median(p):.4f} [{p.min():.4f}, "
              f"{p.max():.4f}] -> change {np.median(c):.4f} [{c.min():.4f},"
              f" {c.max():.4f}]; change < parent in "
              f"{int((c[:, None] < p[None, :]).sum())} of {p.size * c.size}"
              " cross pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
