#!/usr/bin/env python3
"""Device time per call of the port's main paths, and of the WOLA kernels
and the others through their wrappers, for two checkouts of the repo, in
turns, on one NVIDIA GPU.

    python3 tools/h100_probe/ab_paths.py PARENT_ROOT [CHANGE_ROOT] [--pairs N]
        [--only TEXT]

Both checkouts first build their kernels from their own sources, side by
side. Then each checkout's package and chip_smoke.py run in processes of
their own, N pairs (default 10) in the order parent, change, change,
parent, ... Each process drives, on chip_smoke.py's noise input (aira16's
16 mics, 48 kHz, 30 s), the device-resident call ``model.process`` of DAS,
MVDR ``auto``, ``mega`` and ``dense``, LCMV ``auto`` (one slot, and
chip_smoke.py's two static interferers: three), ``dense`` (one slot) and
``mega`` (one slot and three), phase,
phasempf and mcra under the launch presets, GSC ``sample``, ``xmu``,
``block`` and ``blocklms`` (l = 128), and GSS (one slot, and chip_smoke.py's two
static interferers: three): the time of one call is CUDA events around
it, median of 10 after 3 warm-ups (GSC: of 3 after 1). It also times, as
chip_smoke.py's ``cuda_ms`` does (one call through the wrapper between
two events, median of 20), ``kernels.wola.wola_analysis`` (C = 16, T =
1407 and T = 64, with and without the gate statistic, seeded noise) and
``torch.stft`` on the same frames, ``kernels.wola.wola_synthesis`` (C =
1 and 16, T = 1407 and 64, seeded spectra),
``kernels.mvdr_stream.mvdr_stream``
and ``kernels.lcmv_stream.lcmv_stream`` on chip_smoke.py's operands (the
analysis of the noise input under the LCMV preset, whose solve settings
are MVDR's; LCMV at S = 1, 3 and 16 with 13 slots inactive),
``kernels.mega_stream.mega_stream`` (MVDR, and LCMV at S = 3),
``kernels.gss_stream.gss_mega`` (the gss preset, zero state, S = 1, 3
and 16 with 13 slots inactive), ``kernels.phase_mask.phase_mask`` (the
phase preset, one steering) and the marches
``kernels.phase_mask.mpf_march`` and ``mcra_march`` (the presets, one
steering, zero state), and ``kernels.linalg.gj_inverse``, unpolished and
polished, on chip_smoke.py's dense block (the windowed covariances of 82
frames at 678 bins: 55,596 matrices of 16 x 16). A checkout with the
batched runner (``beamform_tpu_torch/runtime/batch.py``) also times one
``BatchRunner.process`` of a 2 s chunk of chip_smoke.py's batched input
(8 streams of 16 mics, thetas linspace(-60, 60, 8)) for MVDR ``auto``,
LCMV ``auto``, MVDR ``mega``, GSS, phase, phasempf, mcra and MVDR
``dense``, CUDA events, median of 10 after 3 warm-ups; a checkout without
it reports none of these (one whose nodes lack a native batched step runs
the protocol's default, a loop over the streams). A checkout with the
multi-device layer (``beamform_tpu_torch/parallel``) also times the MVDR
``auto`` chunk through ``sharded_batched_step`` in a 1-rank NCCL world,
mesh (1, 1): the sharding layer's host work and all-gather at world size
1, beside the ``B=8`` runner's. Last, one
``StreamingSession.process`` of a live chunk of 1 and 4 hops from host
numpy for DAS, MVDR and LCMV ``auto`` (``cuda_ms``), and one call of
``kernels.gsc.gsc_sample`` and ``gsc_xmu`` at the live size (2 streams of
48 hops, seeded audio, zero state, the gsc preset; ``cuda_ms``). With
``--only TEXT`` each process times only the model paths whose label holds
TEXT and, where TEXT is in "gsc", the two GSC kernel calls.
CHANGE_ROOT defaults to this checkout. Prints one line per process, then
per metric both sides' medians and ranges; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# (label, node, parameters over the launch preset, timed calls, whether
# the array carries chip_smoke.py's two static interferers)
PATHS = (("das", "das", None, 10, False), ("mvdr", "mvdr", {}, 10, False),
         ("mvdr mega", "mvdr", {"solver": "mega"}, 10, False),
         ("mvdr dense", "mvdr", {"solver": "dense"}, 10, False),
         ("lcmv", "lcmv", {}, 10, False),
         ("lcmv dense", "lcmv", {"solver": "dense"}, 10, False),
         ("lcmv S=3", "lcmv", {}, 10, True),
         ("lcmv mega", "lcmv", {"solver": "mega"}, 10, False),
         ("lcmv mega S=3", "lcmv", {"solver": "mega"}, 10, True),
         ("phase", "phase", {}, 10, False),
         ("phasempf", "phasempf", {}, 10, False),
         ("mcra", "mcra", {}, 10, False),
         ("gsc", "gsc", {"write_mu": False}, 3, False),
         ("gsc xmu", "gsc", {"write_mu": False, "solver": "xmu"}, 3, False),
         ("gsc block", "gsc", {"write_mu": False, "solver": "block"}, 3,
          False),
         ("gsc blocklms", "gsc", {"write_mu": False, "solver": "blocklms"},
          3, False),
         ("gss", "gss", {}, 10, False),
         ("gss S=3", "gss", {}, 10, True))
# (label, node, parameters over the launch preset) of the batched paths
BATCHED = (("mvdr B=8", "mvdr", {}), ("lcmv B=8", "lcmv", {}),
           ("mvdr mega B=8", "mvdr", {"solver": "mega"}),
           ("gss B=8", "gss", {}), ("phase B=8", "phase", {}),
           ("phasempf B=8", "phasempf", {}), ("mcra B=8", "mcra", {}),
           ("mvdr dense B=8", "mvdr", {"solver": "dense"}))
ANALYSIS_T = (1407, 64)
SYNTHESIS_C = (1, 16)


def worker(root: str, only: str | None = None) -> dict:
    """The device time per call (ms) of each path and analysis shape, in
    this process; with ``only`` the model paths whose label holds it and,
    where it is in "gsc", the GSC kernel calls."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from beamform_tpu_torch.dsp.wola import sqrt_hann
    from beamform_tpu_torch.kernels import wola as kw
    from beamform_tpu_torch.models import get_model
    x = torch.as_tensor(cs.make_input(16, cs.SECONDS), device="cuda")
    out = {}
    for label, node, over, reps, interf in PATHS:
        if only is not None and only not in label:
            continue
        params = None if over is None else cs.preset(node, **over)
        cfg = cs.aira16(cs.INTERFERERS if interf else ())
        model = get_model(node, cs.engine(), cfg, params, device="cuda")
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
    if only is not None:
        if only in "gsc":
            out.update(gsc_kernels(cs))
        return out
    out.update(gsc_kernels(cs))
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
    for c in SYNTHESIS_C:
        for t in ANALYSIS_T:
            y = torch.complex(*(torch.as_tensor(
                rng.standard_normal((c, t, hop + 2)), dtype=torch.float32,
                device="cuda") for _ in range(2)))
            prev = torch.as_tensor(rng.standard_normal((c, hop)),
                                   dtype=torch.float32, device="cuda")
            out[f"synthesis C={c} T={t}"] = cs.cuda_ms(
                lambda: kw.wola_synthesis(y, prev))
    out.update(solve_kernels(cs, x))
    out.update(gj_kernels(cs, x))
    if os.path.exists(os.path.join(root, "beamform_tpu_torch", "runtime",
                                   "batch.py")):
        out.update(batched_paths(cs, root))
    out.update(live_chunks(cs))
    return out


def gsc_kernels(cs) -> dict:
    """One call of ``kernels.gsc.gsc_sample`` and ``gsc_xmu`` (ms) at the
    live size: 2 streams of 48 hops of 16 mics, seeded audio of 0.1 rms,
    zero state, the gsc preset."""
    import torch
    from beamform_tpu_torch.config import make_params
    from beamform_tpu_torch.kernels import gsc as kg
    rng = np.random.default_rng(7)
    a = torch.as_tensor(0.1 * rng.standard_normal((2, 16, 48 * cs.HOP)),
                        dtype=torch.float32, device="cuda")
    z = torch.zeros((2, 15, 128), device="cuda")
    lo = torch.zeros((2, 128), device="cuda")
    p = make_params("gsc", cs.preset("gsc", write_mu=False))
    return {f"{fn.__name__} B=2 48 hops": cs.cuda_ms(
        lambda: fn(a, z, z, lo, p)) for fn in (kg.gsc_sample, kg.gsc_xmu)}


def live_chunks(cs) -> dict:
    """One StreamingSession.process of a live chunk (ms), 1 and 4 hops of
    chip_smoke.py's noise input from host numpy, as the live loop feeds
    it, for DAS, MVDR and LCMV ``auto``."""
    from beamform_tpu_torch.models import get_model
    from beamform_tpu_torch.runtime.streaming import StreamingSession
    x = cs.make_input(16, cs.SECONDS)[:, 40 * cs.HOP:44 * cs.HOP]
    out = {}
    for node in ("das", "mvdr", "lcmv"):
        params = None if node == "das" else cs.preset(node)
        sess = StreamingSession(get_model(node, cs.engine(), cs.aira16(),
                                          params, device="cuda"))
        for hops in (1, 4):
            xc = np.ascontiguousarray(x[:, :hops * cs.HOP])
            out[f"{node} live {hops} hop"] = cs.cuda_ms(
                lambda: sess.process(xc, cs.THETA))
    return out


def batched_paths(cs, root: str) -> dict:
    """One BatchRunner.process of the first 2 s chunk of chip_smoke.py's
    batched input (ms), per path of BATCHED; in a checkout with the
    multi-device layer (``beamform_tpu_torch/parallel``), also the same
    chunk of MVDR ``auto`` through ``sharded_batched_step`` in a 1-rank
    NCCL world on a (1, 1) mesh, from ``sharded_state_init``."""
    import torch
    from beamform_tpu_torch.runtime.batch import BatchRunner
    xb = torch.as_tensor(cs.make_batch_input(cs.BATCH)[..., :cs.BATCH_CHUNK],
                         device="cuda")
    thetas = np.linspace(-60.0, 60.0, cs.BATCH)
    out = {}
    for label, node, over in BATCHED:
        runner = BatchRunner(node, cs.engine(), cs.aira16(),
                             cs.preset(node, **over), batch=cs.BATCH,
                             device="cuda")
        for _ in range(2):
            runner.process(xb, thetas)
        out[label] = cs.cuda_ms(lambda: runner.process(xb, thetas), reps=10)
    if os.path.isdir(os.path.join(root, "beamform_tpu_torch", "parallel")):
        import torch.distributed as dist
        from beamform_tpu_torch.models import get_model
        from beamform_tpu_torch.parallel.mesh import make_mesh
        from beamform_tpu_torch.parallel.multihost import init_multihost
        from beamform_tpu_torch.parallel.sharded import (
            sharded_batched_step, sharded_state_init)
        init_multihost(f"tcp://127.0.0.1:{cs.free_port()}", world_size=1,
                       rank=0)
        try:
            mesh = make_mesh(shape=(1, 1))
            model = get_model("mvdr", cs.engine(), cs.aira16(),
                              cs.preset("mvdr"), device="cuda")
            state = sharded_state_init(mesh, model, cs.BATCH)
            for _ in range(2):
                sharded_batched_step(mesh, model, xb, thetas, state)
            out["mvdr sharded 1-rank B=8"] = cs.cuda_ms(
                lambda: sharded_batched_step(mesh, model, xb, thetas, state),
                reps=10)
        finally:
            dist.destroy_process_group()
    return out


def gj_kernels(cs, x) -> dict:
    """One call of ``kernels.linalg.gj_inverse`` through its wrapper (ms),
    unpolished and polished, on chip_smoke.py's dense block: the windowed
    covariances of 82 frames past the quiet lead-in at the 678 in-band
    bins of the MVDR preset, loaded as MvdrModel._solve_dense loads them
    (55,596 matrices of 16 x 16)."""
    import torch
    from beamform_tpu_torch.kernels import linalg as kl
    from beamform_tpu_torch.kernels.mvdr_stream import white_r
    from beamform_tpu_torch.kernels.wola import wola_analysis
    from beamform_tpu_torch.models import common, get_model
    dev = torch.device("cuda")
    params = cs.preset("mvdr")
    model = get_model("mvdr", cs.engine(), cs.aira16(), params, device=dev)
    xp = common.prepare_input(x, cs.engine(), torch.float32, dev)
    spec, _, _ = wola_analysis(xp, torch.zeros((16, cs.HOP), device=dev))
    t, m, _ = spec.shape
    w = params["past_windows"]
    cb = model._block_frames(t)
    c0 = max(w, min(4 * cb, t - cb))
    e = spec[c0 - w:c0 + cb].index_select(2, model.ib)
    o = torch.einsum("tmn,tkn->tnmk", e, e.conj())
    ones = torch.ones((cb, cb + w), device=dev)
    band = (ones.tril(w - 1) - ones.tril(-1)).to(torch.complex64)
    r = (torch.einsum("ct,tnmk->cnmk", band, o)
         * white_r(m, torch.float32, dev)).reshape(-1, m, m).contiguous()
    return {f"gj_inverse{' polish' if polish else ''}": cs.cuda_ms(
        lambda: kl.gj_inverse(r, polish=polish)) for polish in (False, True)}


def solve_kernels(cs, x) -> dict:
    """One call of the MVDR and LCMV stream kernels, the fused MVDR/LCMV
    kernel, the fused GSS kernel, the phase mask and the MPF and MCRA
    marches through their wrappers (ms), on
    chip_smoke.py's operands: the analysis of ``x`` under the LCMV preset
    (678 in-band bins, 1407 frames, W = 10, zero history), MVDR at one
    steering and LCMV at S = 1, 3 and 16 (two interferers, 13 slots
    inactive); the fused kernels on ``x`` with zero carries, MVDR and LCMV
    at S = 3, and GSS under the gss preset (zero state, W <- A^H at frame
    0) at S = 1, 3 and 16 (two interferers, 13 slots inactive); the phase
    mask on the analysis under the phase preset and the MPF front end and
    march under the phasempf preset (one steering, zero state), the MCRA
    march on its mic 0 under the mcra preset (zero state)."""
    import torch
    from beamform_tpu_torch.config import make_params
    from beamform_tpu_torch.kernels import gss_stream as kgss
    from beamform_tpu_torch.kernels import lcmv_stream as kl
    from beamform_tpu_torch.kernels import mega_stream as kmega
    from beamform_tpu_torch.kernels import mvdr_stream as km
    from beamform_tpu_torch.kernels import phase_mask as kpm
    from beamform_tpu_torch.kernels.wola import wola_analysis
    from beamform_tpu_torch.models import common, get_model
    from beamform_tpu_torch.models.mcra import freq_smooth
    dev = torch.device("cuda")
    params = cs.preset("lcmv")
    model = get_model("lcmv", cs.engine(), cs.aira16(), params, device=dev)
    xp = common.prepare_input(x, cs.engine(), torch.float32, dev)
    spec, mag, _ = wola_analysis(xp, torch.zeros((16, cs.HOP), device=dev),
                                 with_mag=True)
    t, m, _ = spec.shape
    ib, w = model.ib, params["past_windows"]
    thr = params["freq_mag_threshold"]
    gate = mag.index_select(1, ib) > thr
    hist = torch.zeros((w, m, len(ib)), dtype=torch.complex64, device=dev)
    idx = torch.zeros(t, dtype=torch.int64, device=dev)
    out = {}
    d = common.weights_for_thetas(model.geom, model.freqs,
                                  torch.full((1,), cs.THETA, device=dev),
                                  torch.float32, torch.complex64)
    d_ib = d.index_select(2, ib).contiguous()
    out["mvdr_stream"] = cs.cuda_ms(
        lambda: km.mvdr_stream(spec, hist, d_ib, idx, gate, ib))
    for n_interf, capacity in ((0, 0), (2, 2), (2, 15)):
        c = cs.lcmv_constraints(model, n_interf, capacity)
        out[f"lcmv_stream S={c.shape[1]}"] = cs.cuda_ms(
            lambda: kl.lcmv_stream(spec, hist, c, idx, gate, ib))
    xm, tail, prev, _ = cs.fused_inputs(x)
    for label, ctrl, lcmv in (
            ("MVDR", d_ib[:, None].contiguous(), False),
            ("LCMV S=3", cs.lcmv_constraints(model, 2, 2), True)):
        out[f"mega_stream {label}"] = cs.cuda_ms(
            lambda: kmega.mega_stream(xm, tail, prev, hist, ctrl, idx, ib,
                                      thr, lcmv=lcmv))
    for interf, capacity in (((), 0), (cs.INTERFERERS, 2),
                             (cs.INTERFERERS, 15)):
        gss = get_model("gss", cs.engine(), cs.aira16(interf),
                        cs.preset("gss"), device=dev)
        gss.capacity = capacity
        gp = gss.params
        # the static set at the state's capacity, one stream
        (ah, _, _, bits), gidx, _ = gss.batch_controls(np.full((1, t),
                                                               cs.THETA))
        gidx = gidx[0]
        w0 = torch.zeros((len(gss.ib), ah.shape[1], m),
                         dtype=torch.complex64, device=dev)
        reset = torch.zeros(t, dtype=torch.bool, device=dev)
        reset[0] = True
        out[f"gss_mega S={ah.shape[1]}"] = cs.cuda_ms(
            lambda: kgss.gss_mega(xm, tail, prev, w0, ah, gidx, reset,
                                  gss.ib, 2 * cs.HOP, gp.freq_mag_threshold,
                                  gp.mu, gp.lam, act_bits=bits))
    nb = spec.shape[2]
    phase = get_model("phase", cs.engine(), cs.aira16(), cs.preset("phase"),
                      device=dev)
    uniq, w_idx = phase.batch_controls(np.full((1, t), cs.THETA))
    w_idx = w_idx[0]
    wts = common.weights_for_thetas(phase.geom, phase.freqs, uniq,
                                    torch.float32, torch.complex64)
    pp = phase.params
    out["phase_mask"] = cs.cuda_ms(
        lambda: kpm.phase_mask(spec, wts, w_idx, pp.min_phase * np.pi / 180,
                               pp.mag_threshold, pp.mag_mult, 2 * cs.HOP))
    mp = make_params("phasempf", cs.preset("phasempf"))
    st = kpm.init_state(kpm.MpfState, nb, torch.float32, dev)
    out["mpf_march"] = cs.cuda_ms(
        lambda: kpm.mpf_march(spec, wts, w_idx, st, mp, True))
    x0 = spec[:, 0].contiguous()
    sq = x0.abs() ** 2
    s_f = freq_smooth(sq, x0[:, 0].abs())
    cp = make_params("mcra", cs.preset("mcra"))
    mst = kpm.init_state(kpm.McraState, nb, torch.float32, dev)
    out["mcra_march"] = cs.cuda_ms(
        lambda: kpm.mcra_march(s_f, sq, x0, mst, cp, True))
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
        only = sys.argv[3] if len(sys.argv) > 3 else None
        print(json.dumps(worker(os.path.abspath(sys.argv[2]), only)),
              flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--only", default=None,
                    help="time only the model paths whose label holds this")
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
                               "--worker", roots[label]]
                              + ([args.only] if args.only else []),
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
    for key in runs["change"][0]:
        c = np.array([r[key] for r in runs["change"]])
        if key not in runs["parent"][0]:
            print(f"{key}: parent none -> change {np.median(c):.4f} "
                  f"[{c.min():.4f}, {c.max():.4f}]")
            continue
        p = np.array([r[key] for r in runs["parent"]])
        print(f"{key}: parent {np.median(p):.4f} [{p.min():.4f}, "
              f"{p.max():.4f}] -> change {np.median(c):.4f} [{c.min():.4f},"
              f" {c.max():.4f}]; change < parent in "
              f"{int((c[:, None] < p[None, :]).sum())} of {p.size * c.size}"
              " cross pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
