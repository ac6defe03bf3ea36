#!/usr/bin/env python3
"""Kernel time of the phase-mask front end, ``phase_mask_kernel<16, true>``
and ``mpf_beams_kernel<16, true>``, for two checkouts of the repo, in
turns, on one NVIDIA GPU.

    python3 tools/h100_probe/front_end_times.py PARENT_ROOT [CHANGE_ROOT] [--pairs N]

Both checkouts first build their kernels from their own sources, side by
side. Then each checkout's package runs in processes of its own, N pairs
(default 4) in the order parent, change, change, parent, ... Each process
makes seeded spectra at the main shape (16 mics, 1,026 bins, 1,407
frames; one steering of unit phases), calls ``kernels.phase_mask``
``phase_mask`` (the phase preset) and ``mpf_march`` (the phasempf
preset, zero state) 50 times each under ``torch.profiler`` and prints
each kernel's mean device time a launch and its launch count, and the
time a call of 200 back-to-back ``phase_mask`` calls between two CUDA
events (device-bound: the kernel takes longer than the wrapper's host
work). ``tools/h100_probe/ab_paths.py`` times the same wrappers one call
at a time, host work included. CHANGE_ROOT defaults to this checkout.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("phase_mask_kernel<16, true>", "mpf_beams_kernel<16, true>")


def worker(root: str) -> dict:
    """The front end's kernel times in the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from beamform_tpu_torch.config import load_launch_params, make_params
    from beamform_tpu_torch.kernels import phase_mask as kpm

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    t, m, nb = 1407, 16, 1026
    spec = torch.randn(t, m, nb, dtype=torch.complex64, device=dev,
                       generator=g)
    ang = torch.rand(1, m, nb, device=dev, generator=g) * 6.2831853
    w = torch.polar(torch.ones_like(ang), ang)
    idx = torch.zeros(t, dtype=torch.int64, device=dev)
    pp = make_params("phase", load_launch_params("phase"))
    mp = make_params("phasempf", load_launch_params("phasempf"))
    st = kpm.init_state(kpm.MpfState, nb, torch.float32, dev)

    def mask():
        return kpm.phase_mask(spec, w, idx, pp.min_phase * math.pi / 180,
                              pp.mag_threshold, pp.mag_mult, 2048)

    def mpf():
        return kpm.mpf_march(spec, w, idx, st, mp, True)

    mask()
    mpf()
    torch.cuda.synchronize()
    out = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            mask()
            mpf()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        for key in KERNELS:
            if key in e.key:
                dt = getattr(e, "device_time", None) or e.cuda_time
                out[key] = [round(dt / 1000, 5), e.count]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        mask()
    end.record()
    torch.cuda.synchronize()
    out["phase_mask back-to-back ms a call"] = round(
        start.elapsed_time(end) / 200, 5)
    return out


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(os.path.abspath(sys.argv[2]))), flush=True)
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args()
    roots = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from beamform_tpu_torch.kernels._build "
         "import build; build()"], cwd=root) for root in roots.values()]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("a kernel build failed")
    order = []
    for i in range(args.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    for side in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             roots[side]], cwd=roots[side], capture_output=True, text=True,
            check=True)
        print(side, res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
