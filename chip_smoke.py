#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``beamform_tpu_torch/csrc``, checks
each of the five kernels (WOLA analysis and synthesis, the MVDR and LCMV
streaming solves, the Gauss-Jordan inverse) against its plain-torch
version at the main paths' shapes, and drives three main paths at full
width (16 mics of the aira16 array, 48 kHz, 30 s, hop 1024) through
``run_offline``, ``StreamingSession`` and the CLI: delay-and-sum, and MVDR
and LCMV under the reference's launch presets with the ``auto`` (streaming
solve) and ``dense`` (Gauss-Jordan) solvers, on noise and on a speech-like
input; LCMV also with two static interferers and with an interference
event timeline. It checks each output against the float64 CPU path and
measures each path's xRT. Every phase raises on failure, so the script
exits non-zero without its final line; it also fails without a CUDA
device. It imports no JAX.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
FS = 48000
SECONDS = 30.0           # the headline input of bench.py (xrt_das_16ch_48kHz)
HOP = 1024               # EngineConfig's default window_size
THETA = 20.0
KERNEL_REL_TOL = 1e-5    # kernel vs plain torch, max error / max |ref|
# the MVDR kernels vs their plain versions, max error / max |ref|: float32
# solves and inverses of 1.001-loaded rank-10 covariances of 16 mics, whose
# condition reaches ~1e4, so float32 round-off is amplified up to that much
# (measured on an H100: mvdr_stream 1.9e-4, gj_inverse 4.9e-5 and 1.2e-4
# with the polish). Each kernel is also held to F64_FACTOR times its plain
# float32 version's own error against the plain version in complex128.
MVDR_STREAM_REL_TOL = 5e-4
GJ_REL_TOL = 2e-4
# lcmv_stream vs its plain version, max error / max |ref|, at the main
# shapes with interferers: the MVDR solve's conditioning, compounded by the
# inner system (measured on an H100: 1.7e-3 at S = 3 and S = 16); with one
# constraint the algebra is MVDR's, and so is the bar
LCMV_STREAM_REL_TOL = 3e-3
F64_FACTOR = 2.0
DAS_ABS_TOL = 1e-3       # float32 on the card vs float64 CPU (BASELINE.md)
STREAM_TOL = 1e-5        # chunked vs offline, both on the card
# LCMV with one constraint vs MVDR, both float32 on the card, absolute
# (measured on an H100: 3.0e-8 at a peak of 0.14)
LCMV_MVDR_TOL = 1e-6
# the LCMV scenes: two static interferers, and an event timeline over one
# (an add with the row-0 quirk at 10 s, a proximity removal at 20 s under
# the preset's threshold 1.0, replayed at capacity 15)
INTERFERERS = (70.0, -60.0)
EVENTS = ((70.0,), "10:2:-60,20:2:70.5")
REPS = 20


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def make_input(num_mics: int, seconds: float) -> np.ndarray:
    """bench.py's make_input: seeded noise with a quiet lead-in."""
    rng = np.random.default_rng(0)
    x = 0.1 * rng.standard_normal((num_mics, int(seconds * FS)),
                                  dtype=np.float32)
    x[:, :12 * HOP] *= 1e-4
    return x


def make_speech_input(num_mics: int, seconds: float) -> np.ndarray:
    """bench.py's make_speech_input: pink-ish noise under a ~4 Hz syllabic
    envelope and ~0.4 Hz phrase pauses, with a quiet lead-in, so the energy
    gate passes a minority of (frame, bin) pairs."""
    rng = np.random.default_rng(7)
    n = int(seconds * FS)
    w = rng.standard_normal((num_mics, n), dtype=np.float32)
    spec = np.fft.rfft(w, axis=-1)
    f = np.fft.rfftfreq(n, 1.0 / FS)
    spec *= 1.0 / np.sqrt(1.0 + f / 300.0)
    x = np.fft.irfft(spec, n=n, axis=-1)
    x /= np.std(x)
    t = np.arange(n) / FS
    syllab = np.clip(np.sin(2 * np.pi * 3.7 * t) + 0.2, 0.0, 1.0)
    phrase = (np.sin(2 * np.pi * 0.37 * t + 1.0) > -0.2).astype(np.float64)
    x = 0.15 * x * (syllab * phrase)[None, :]
    x[:, :12 * HOP] *= 1e-3
    return x.astype(np.float32)


def mvdr_preset(**kw) -> dict:
    """The reference's launch preset for mvdr, plus overrides."""
    from beamform_tpu_torch.config import load_launch_params
    return dict(load_launch_params("mvdr"), **kw)


def lcmv_preset(**kw) -> dict:
    """The reference's launch preset for lcmv, plus overrides."""
    from beamform_tpu_torch.config import load_launch_params
    return dict(load_launch_params("lcmv"), **kw)


def aira16(interference=()):
    """The aira16 array, with ``interference`` as its static set."""
    import dataclasses
    from beamform_tpu_torch.config import load_array_config
    cfg = load_array_config(
        os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira16.yaml"))
    return dataclasses.replace(cfg, interference_angles=tuple(interference))


def event_timeline(num_frames: int, spec: str = EVENTS[1]):
    """The CLI's replay of ``spec`` over EVENTS' initial set, with the lcmv
    preset's threshold."""
    from beamform_tpu_torch.runtime.cli import interference_from_spec
    return interference_from_spec(
        spec, num_frames, HOP, FS, EVENTS[0],
        lcmv_preset()["interf_angle_threshold"])


def engine(dtype="float32"):
    from beamform_tpu_torch.config import EngineConfig
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)


def counters():
    """Every kernel wrapper of the port, by the name the kernels line
    uses."""
    from beamform_tpu_torch.kernels import (lcmv_stream, linalg,
                                            mvdr_stream, wola)
    return {"wola_analysis": wola.wola_analysis,
            "wola_synthesis": wola.wola_synthesis,
            "mvdr_stream": mvdr_stream.mvdr_stream,
            "gj_inverse": linalg.gj_inverse,
            "lcmv_stream": lcmv_stream.lcmv_stream}


def reset_launches():
    for fn in counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def cuda_ms(fn, reps=REPS) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _err(got, ref):
    """(max abs error, max abs error / max |ref|) over paired tensors."""
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return abs_err, abs_err / scale


def check_solve_kernel(label, got, ref, f64, bar, ms, plain_ms) -> float:
    """Hold a float32 solve kernel's output (MVDR, LCMV, Gauss-Jordan) to
    its plain float32 version (``bar`` of peak) and, against the plain
    version in complex128 on the same operands, to F64_FACTOR times the
    plain float32 version's own error. Logs the numbers; returns the max
    abs error against plain."""
    import torch
    abs_err, rel_err = _err([got], [ref])
    k64 = _err([got.cdouble()], [f64])[1]
    p64 = _err([ref.cdouble()], [f64])[1]
    log(f"kernel {label}: max_abs_err {abs_err:.3e} rel {rel_err:.3e} (bar "
        f"{bar:g}); vs complex128 kernel {k64:.3e}, plain {p64:.3e} (bar "
        f"{F64_FACTOR:g}x plain); {ms:.4f} ms vs plain torch "
        f"{plain_ms:.4f} ms")
    if not (rel_err <= bar and k64 <= F64_FACTOR * p64
            and torch.isfinite(torch.view_as_real(got)).all()):
        raise AssertionError(f"{label}: rel err {rel_err}, vs complex128 "
                             f"{k64} (plain {p64})")
    return abs_err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from beamform_tpu_torch.kernels._build import build
    info = build()
    log(f"build: {info['seconds']:.1f} s -> {os.path.relpath(info['path'], ROOT)}")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(t_main: int) -> dict:
    """Each kernel against its plain version on the card. Returns the
    main-path shape's numbers per kernel."""
    import torch
    from beamform_tpu_torch.kernels import wola as kw
    rng = np.random.default_rng(1)
    dev = torch.device(DEVICE)
    results = {}

    cases = [("analysis", 16, t_main, False), ("analysis", 16, 256, False),
             ("analysis", 16, 256, True), ("synthesis", 1, t_main, None),
             ("synthesis", 1, 256, None), ("synthesis", 8, 256, None)]
    for kind, c, t, with_mag in cases:
        if kind == "analysis":
            x = torch.as_tensor(0.1 * rng.standard_normal((c, t * HOP)),
                                dtype=torch.float32, device=dev)
            tail = torch.as_tensor(0.1 * rng.standard_normal((c, HOP)),
                                   dtype=torch.float32, device=dev)
            got = kw.wola_analysis(x, tail, with_mag)
            ref = kw.wola_analysis_plain(x, tail, with_mag)
            pairs = [(got[0], ref[0]), (got[2], ref[2])]
            if with_mag:
                pairs.append((got[1], ref[1]))
            shadow = float((got[0][..., HOP + 1]
                            - got[0][..., HOP - 1].conj()).abs().max())
            ms = cuda_ms(lambda: kw.wola_analysis(x, tail, with_mag))
            plain_ms = cuda_ms(lambda: kw.wola_analysis_plain(x, tail,
                                                              with_mag))
            label = f"analysis C={c} T={t} mag={with_mag}"
        else:
            y = torch.complex(
                torch.as_tensor(rng.standard_normal((c, t, HOP + 2)),
                                dtype=torch.float32),
                torch.as_tensor(rng.standard_normal((c, t, HOP + 2)),
                                dtype=torch.float32)).to(dev)
            prev = torch.as_tensor(rng.standard_normal((c, HOP)),
                                   dtype=torch.float32, device=dev)
            got = kw.wola_synthesis(y, prev)
            ref = kw.wola_synthesis_plain(y, prev)
            pairs = list(zip(got, ref))
            shadow = None
            ms = cuda_ms(lambda: kw.wola_synthesis(y, prev))
            plain_ms = cuda_ms(lambda: kw.wola_synthesis_plain(y, prev))
            label = f"synthesis C={c} T={t}"
        torch.cuda.synchronize()
        abs_err, rel_err = _err(*zip(*pairs))
        log(f"kernel {label}: max_abs_err {abs_err:.3e} rel {rel_err:.3e} "
            f"(bar {KERNEL_REL_TOL:g}); {ms:.4f} ms vs plain torch "
            f"{plain_ms:.4f} ms"
            + ("" if shadow is None else f"; shadow-bin err {shadow:.3e}"))
        if not rel_err <= KERNEL_REL_TOL:
            raise AssertionError(f"{label}: rel err {rel_err} > "
                                 f"{KERNEL_REL_TOL}")
        if (t, c) in ((t_main, 16), (t_main, 1)) and not with_mag:
            results[kind] = dict(max_abs_err=abs_err, ms=ms,
                                 plain_ms=plain_ms)
    return results


def phase_das(x: np.ndarray):
    """The main path: run_offline on the card, counted launches, checked
    against the float64 CPU path. Returns (output, launch counts)."""
    from beamform_tpu_torch import run_offline
    cfg = aira16()
    reset_launches()
    y = run_offline("das", x, engine=engine(), array_cfg=cfg, theta=THETA,
                    device=DEVICE)
    launches = read_launches()
    log(f"das main path launches: {launches}")
    if min(launches["wola_analysis"], launches["wola_synthesis"]) < 1:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    n_out = -(-x.shape[1] // HOP) * HOP
    if y.shape != (n_out,) or not np.isfinite(y).all():
        raise AssertionError(f"das output shape {y.shape} / non-finite")
    ref = run_offline("das", x, engine=engine("float64"), array_cfg=cfg,
                      theta=THETA, device="cpu")
    dev = float(np.abs(y - ref).max())
    log(f"das {DEVICE} float32 vs cpu float64: max sample deviation "
        f"{dev:.3e} (bar {DAS_ABS_TOL:g}, peak {np.abs(ref).max():.3e})")
    if not dev <= DAS_ABS_TOL:
        raise AssertionError(f"das deviation {dev} > {DAS_ABS_TOL}")

    t = n_out // HOP
    th = np.full(t, 10.0)
    th[t // 2:] = -40.0
    y_tl = run_offline("das", x, engine=engine(), array_cfg=cfg, theta=th,
                       device=DEVICE)
    ref_tl = run_offline("das", x, engine=engine("float64"), array_cfg=cfg,
                         theta=th, device="cpu")
    dev_tl = float(np.abs(y_tl - ref_tl).max())
    log(f"das theta timeline (10 -> -40 deg at frame {t // 2}): max sample "
        f"deviation {dev_tl:.3e} (bar {DAS_ABS_TOL:g})")
    if not dev_tl <= DAS_ABS_TOL:
        raise AssertionError(f"das timeline deviation {dev_tl}")
    return y, launches


def phase_streaming(x: np.ndarray, y_offline: np.ndarray, tmp: str,
                    node: str = "das", params=None, tol=STREAM_TOL):
    """StreamingSession in 64-frame chunks == offline; a save/load in the
    middle resumes identically (within ``tol``; 0 is bit for bit)."""
    from beamform_tpu_torch.models import get_model
    from beamform_tpu_torch.runtime.streaming import StreamingSession
    cfg = aira16()
    chunk = 64 * HOP
    xp = np.pad(x, ((0, 0), (0, (-x.shape[1]) % chunk)))
    starts = list(range(0, xp.shape[1], chunk))
    half = len(starts) // 2

    def session():
        return StreamingSession(get_model(node, engine(), cfg, params,
                                          device=DEVICE))

    sess = session()
    outs = [sess.process(xp[:, i:i + chunk], THETA).cpu().numpy()
            for i in starts]
    got = np.concatenate(outs)[:len(y_offline)]
    err = float(np.abs(got - y_offline).max())
    log(f"{node} streaming 64-frame chunks vs offline: max abs err "
        f"{err:.3e} (bar {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{node} streaming err {err}")

    first = session()
    outs2 = [first.process(xp[:, i:i + chunk], THETA).cpu().numpy()
             for i in starts[:half]]
    ckpt = os.path.join(tmp, f"{node}_state.npz")
    first.save(ckpt)
    second = session()
    second.load(ckpt)
    outs2 += [second.process(xp[:, i:i + chunk]).cpu().numpy()
              for i in starts[half:]]
    resumed = np.concatenate(outs2)[:len(y_offline)]
    err2 = float(np.abs(resumed - got).max())
    log(f"{node} streaming save/load at chunk {half}: max abs err vs "
        f"uninterrupted {err2:.3e}")
    if not err2 <= tol or second.frames_done != len(starts) * 64:
        raise AssertionError(f"resume err {err2}, frames "
                             f"{second.frames_done}")


def phase_cli(x: np.ndarray, tmp: str, node: str = "das", params=None,
              extra=(), seconds: float = 2.0, interference=(), events=None,
              tol=1e-6):
    """``beamform-tpu-torch <node> --device cuda [extra]`` on a ``seconds``
    16-ch WAV == run_offline on the same samples with ``params`` (the
    node's launch preset, which the CLI applies by default), the config's
    static ``interference`` and the CLI's replay of ``events``."""
    from beamform_tpu_torch import run_offline
    from beamform_tpu_torch.runtime import cli, wav
    src = os.path.join(tmp, f"{node}_in.wav")
    dst = os.path.join(tmp, f"{node}_out.wav")
    wav.write_wav(src, x[:, :int(seconds * FS)], FS, fmt="float32")
    cfg_path = os.path.join(tmp, f"{node}_array.yaml")
    with open(os.path.join(ROOT, "beamform_tpu_torch", "configs",
                           "aira16.yaml")) as f, open(cfg_path, "w") as g:
        g.write(f.read() + "".join(f"\nangle_interf{k + 1}: {a}"
                                   for k, a in enumerate(interference)))
    argv = [node, "--in", src, "--out", dst, "--array-config", cfg_path,
            "--theta", str(THETA), "--device", DEVICE, "--out-format",
            "float32", *extra]
    if events:
        argv += ["--interference-events", events]
    rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    got, fs = wav.read_wav(dst)
    xin, _ = wav.read_wav(src)
    timeline = (event_timeline(-(-xin.shape[1] // HOP), events) if events
                else None)
    ref = run_offline(node, xin, engine=engine(), array_cfg=aira16(
        interference), theta=THETA, params=params, device=DEVICE,
        interference=timeline)
    err = float(np.abs(got[0] - ref).max())
    log(f"cli {' '.join([node, *extra])}"
        f"{' --interference-events ' + events if events else ''} --device "
        f"{DEVICE} ({seconds:g} s) vs run_offline: max abs err {err:.3e} "
        f"(bar {tol:g})")
    if fs != FS or got.shape != (1, ref.shape[0]) or not err <= tol:
        raise AssertionError(f"cli output mismatch: {got.shape} err {err}")


def phase_xrt(x: np.ndarray, card: str, node: str = "das", params=None,
              label: str = "noise", interference=()):
    """xRT of a node's path after warm-up, each run synchronised: with the
    input already on the card (model.process) and end to end from host
    numpy to host numpy (run_offline); then a torch.profiler breakdown of
    one device-resident call."""
    import torch
    from beamform_tpu_torch import run_offline
    from beamform_tpu_torch.models import get_model
    cfg = aira16(interference)
    seconds = x.shape[1] / FS
    model = get_model(node, engine(), cfg, params, device=DEVICE)
    xd = torch.as_tensor(x, device=DEVICE)

    def on_device():
        model.process(xd, THETA)
        torch.cuda.synchronize()

    def host_to_host():
        run_offline(node, x, engine=engine(), array_cfg=cfg, theta=THETA,
                    params=params, device=DEVICE)

    for name, fn in (("device-resident", on_device),
                     ("host-to-host run_offline", host_to_host)):
        for _ in range(3):
            fn()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        log(f"{node} xRT ({name}, {label}, 16 ch, 48 kHz, {seconds:g} s): "
            f"{seconds / med:.1f}x real time (median {med * 1e3:.3f} ms of "
            f"10, min {min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}) "
            f"on {card}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on_device()
    rows = sorted(prof.key_averages(),
                  key=lambda e: getattr(e, "device_time_total", 0.0),
                  reverse=True)
    total = sum(getattr(e, "device_time_total", 0.0) for e in rows
                if not e.key.startswith(("aten::", "cuda")))
    log(f"profile of one device-resident {node} call ({label}; device "
        f"kernel time {total / 1e3:.3f} ms):")
    for e in rows[:12]:
        log(f"  {getattr(e, 'device_time_total', 0.0) / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def phase_mvdr_kernels(x: np.ndarray) -> dict:
    """The MVDR kernels against their plain versions on the card, on the
    main path's real operands: the analysis of the 30 s input under the
    launch preset (678 in-band bins, 1407 frames, W = 10) for mvdr_stream,
    with one steering and with a theta timeline; one dense block of
    covariances (82 frames x 678 bins = 55,596 16 x 16 matrices) for
    gj_inverse. Returns the numbers per kernel."""
    import torch
    from beamform_tpu_torch.kernels import linalg as kl
    from beamform_tpu_torch.kernels import mvdr_stream as km
    from beamform_tpu_torch.kernels.wola import wola_analysis
    from beamform_tpu_torch.models import common, get_model
    from beamform_tpu_torch.models.mvdr import white_r
    dev = torch.device(DEVICE)
    params = mvdr_preset()
    model = get_model("mvdr", engine(), aira16(), params, device=dev)
    xp = common.prepare_input(x, engine(), torch.float32, dev)
    spec, mag, _ = wola_analysis(xp, torch.zeros((16, HOP), device=dev),
                                 with_mag=True)
    t, m, _ = spec.shape
    ib, w = model.ib, params["past_windows"]
    gate = mag.index_select(1, ib) > params["freq_mag_threshold"]
    hist = torch.zeros((w, m, len(ib)), dtype=torch.complex64, device=dev)
    results = {}

    th = np.full(t, 10.0)
    th[t // 2:] = -40.0
    for label, theta in (("one steering", THETA), ("theta timeline", th)):
        uniq, w_idx = model._theta_ctrl(theta, t)
        d = common.weights_for_thetas(model.geom, model.freqs, uniq,
                                      torch.float32, torch.complex64)
        d = d.index_select(2, ib)
        args = (spec, hist, d, w_idx, gate, ib)
        got = km.mvdr_stream(*args)
        ref = km.mvdr_stream_plain(*args)
        f64 = km.mvdr_stream_plain(spec.cdouble(), hist.cdouble(),
                                   d.cdouble(), w_idx, gate, ib)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: km.mvdr_stream(*args))
        plain_ms = cuda_ms(lambda: km.mvdr_stream_plain(*args), reps=3)
        abs_err = check_solve_kernel(
            f"mvdr_stream M={m} NIB={len(ib)} T={t} W={w} U={d.shape[0]} "
            f"({label}; gate passes {float(gate.float().mean()):.4f} of "
            "(frame, bin) pairs)", got, ref, f64, MVDR_STREAM_REL_TOL, ms,
            plain_ms)
        del f64
        results.setdefault("mvdr_stream", dict(max_abs_err=abs_err, ms=ms,
                                               plain_ms=plain_ms))

    # one dense block, as MvdrModel._solve_dense builds it
    cb = model._block_frames(t)
    c0 = max(w, min(4 * cb, t - cb))              # past the quiet lead-in
    e = spec[c0 - w:c0 + cb].index_select(2, ib)
    o = torch.einsum("tmn,tkn->tnmk", e, e.conj())
    ones = torch.ones((cb, cb + w), device=dev)
    band = (ones.tril(w - 1) - ones.tril(-1)).to(torch.complex64)
    r = (torch.einsum("ct,tnmk->cnmk", band, o)
         * white_r(m, torch.float32, dev)).reshape(-1, m, m).contiguous()
    for polish in (False, True):
        got = kl.gj_inverse(r, polish=polish)
        ref = kl.gj_inverse_plain(r, polish=polish)
        f64 = kl.gj_inverse_plain(r.cdouble(), polish=polish)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kl.gj_inverse(r, polish=polish))
        plain_ms = cuda_ms(lambda: kl.gj_inverse_plain(r, polish=polish),
                           reps=5)
        abs_err = check_solve_kernel(
            f"gj_inverse B={r.shape[0]} M={m} polish={polish}", got, ref,
            f64, GJ_REL_TOL, ms, plain_ms)
        del f64
        if not polish:
            results["gj_inverse"] = dict(max_abs_err=abs_err, ms=ms,
                                         plain_ms=plain_ms)
    return results


def phase_mvdr(x: np.ndarray, xs: np.ndarray) -> tuple:
    """The MVDR main path under the launch preset: run_offline with the
    ``auto`` (streaming solve) and ``dense`` (Gauss-Jordan) solvers, on the
    noise input and the speech-like input, with counted launches, checked
    against the float64 CPU path and against each other. Returns (auto
    output on noise, {solver: that path's own launch counts})."""
    import torch
    from beamform_tpu_torch import run_offline
    from beamform_tpu_torch.models import common, get_model
    cfg = aira16()
    t = -(-x.shape[1] // HOP)
    th = np.full(t, 10.0)
    th[t // 2:] = -40.0

    def run(sig, solver, theta=THETA, dtype="float32", device=DEVICE):
        return run_offline("mvdr", sig, engine=engine(dtype), array_cfg=cfg,
                           theta=theta, params=mvdr_preset(solver=solver),
                           device=device)

    # each path's own launches: one analysis, one synthesis, and one stream
    # solve (auto) or one Gauss-Jordan inverse per dense block (dense)
    expect = {"auto": dict(wola_analysis=1, wola_synthesis=1, mvdr_stream=1,
                           gj_inverse=0),
              "dense": dict(wola_analysis=1, wola_synthesis=1, mvdr_stream=0)}
    outs, launches = {}, {}
    for solver in ("auto", "dense"):
        reset_launches()
        outs[("noise", solver)] = run(x, solver)
        launches[solver] = got = read_launches()
        log(f"mvdr {solver} main path launches (noise): {got}")
        if (any(got[k] != n for k, n in expect[solver].items())
                or (solver == "dense" and got["gj_inverse"] < 1)):
            raise AssertionError(f"mvdr {solver} launches {got}, expected "
                                 f"{expect[solver]}")
    outs.update({("noise timeline", "auto"): run(x, "auto", th),
                 ("speech", "auto"): run(xs, "auto"),
                 ("speech", "dense"): run(xs, "dense")})
    t0 = time.perf_counter()
    refs = {"noise": run(x, "stream", dtype="float64", device="cpu"),
            "noise timeline": run(x, "stream", th, "float64", "cpu"),
            "speech": run(xs, "stream", dtype="float64", device="cpu")}
    log(f"mvdr float64 CPU references (plain stream solver, full 30 s): "
        f"{time.perf_counter() - t0:.1f} s")
    # The speech input's phrase pauses hold more than W frames of exact
    # zeros, so the first frame after each pause that passes the gate sees
    # a zero covariance: the reference's Eigen inverse, and every path
    # here, gives non-finite output for that frame's two hops. The card
    # must be non-finite exactly where the float64 path is, and within the
    # bar everywhere else; the noise input must be finite throughout.
    n_out = t * HOP
    for (inp, solver), y in outs.items():
        finite = np.isfinite(refs[inp])
        if (y.shape != (n_out,) or not np.array_equal(np.isfinite(y), finite)
                or (inp != "speech" and not finite.all())):
            raise AssertionError(f"mvdr {inp} {solver}: shape {y.shape} / "
                                 "non-finite samples differ")
        dev = float(np.abs(y[finite] - refs[inp][finite]).max())
        log(f"mvdr {inp} {solver} {DEVICE} float32 vs cpu float64: max "
            f"sample deviation {dev:.3e} (bar {DAS_ABS_TOL:g}, peak "
            f"{np.abs(refs[inp][finite]).max():.3e}; non-finite samples "
            f"{int((~finite).sum())} on both)")
        if not dev <= DAS_ABS_TOL:
            raise AssertionError(f"mvdr {inp} {solver} deviation {dev}")
    for inp in ("noise", "speech"):
        finite = np.isfinite(refs[inp])
        diff = float(np.abs(outs[(inp, "auto")][finite]
                            - outs[(inp, "dense")][finite]).max())
        log(f"mvdr {inp}: auto (stream kernel) vs dense (GJ kernel) on the "
            f"card: max sample difference {diff:.3e}")
        if not diff <= DAS_ABS_TOL:
            raise AssertionError(f"mvdr {inp} auto vs dense {diff}")

    model = get_model("mvdr", engine(), cfg, mvdr_preset(), device=DEVICE)
    for inp, sig in (("noise", x), ("speech", xs)):
        xp = common.prepare_input(sig, engine(), torch.float32, DEVICE)
        _, mag, _ = common.stft_ext_carry_mag(
            xp, engine(), model.window, torch.complex64,
            torch.zeros((16, HOP), device=DEVICE))
        share = float((mag.index_select(1, model.ib)
                       > model.params.freq_mag_threshold).float().mean())
        log(f"mvdr {inp}: the energy gate passes {share:.4f} of "
            f"{mag.shape[0]} x {len(model.ib)} (frame, bin) pairs")
    return outs[("noise", "auto")], launches


def lcmv_constraints(model, n_interf: int, capacity: int):
    """(U=1, S, M, NIB) constraints for theta THETA and the first
    ``n_interf`` of INTERFERERS active in ``capacity`` slots (S = capacity
    + 1; the other slots inactive), as LcmvModel builds them untrimmed."""
    import torch
    from beamform_tpu_torch.models.lcmv import build_constraints_masked
    dev = model.device
    ang = torch.zeros((1, capacity), dtype=torch.float32, device=dev)
    act = torch.zeros((1, capacity), dtype=torch.float32, device=dev)
    ang[0, :n_interf] = torch.as_tensor(INTERFERERS[:n_interf])
    act[0, :n_interf] = 1.0
    c = build_constraints_masked(
        model.geom, model.freqs, torch.full((1,), THETA, device=dev), ang,
        act, torch.ones(1, device=dev), torch.float32, torch.complex64,
        model.ib)
    return c.permute(0, 3, 2, 1).contiguous()


def phase_lcmv_kernels(x: np.ndarray) -> dict:
    """lcmv_stream against its plain version on the card, on the main
    path's operands (the analysis of the 30 s noise input under the lcmv
    launch preset: 678 in-band bins, 1407 frames, W = 10) for S = 1 (as
    bench.py runs it: aira16 ships no interferers), S = 3 (two static
    interferers) and S = 16 with 13 inactive slots (the CLI's capacity,
    untrimmed). Returns the S = 1 numbers."""
    import torch
    from beamform_tpu_torch.kernels import lcmv_stream as kl
    from beamform_tpu_torch.kernels.wola import wola_analysis
    from beamform_tpu_torch.models import common, get_model
    dev = torch.device(DEVICE)
    params = lcmv_preset()
    model = get_model("lcmv", engine(), aira16(), params, device=dev)
    xp = common.prepare_input(x, engine(), torch.float32, dev)
    spec, mag, _ = wola_analysis(xp, torch.zeros((16, HOP), device=dev),
                                 with_mag=True)
    t, m, _ = spec.shape
    ib, w = model.ib, params["past_windows"]
    gate = mag.index_select(1, ib) > params["freq_mag_threshold"]
    hist = torch.zeros((w, m, len(ib)), dtype=torch.complex64, device=dev)
    idx = torch.zeros(t, dtype=torch.int64, device=dev)
    results = {}
    for n_interf, capacity in ((0, 0), (2, 2), (2, 15)):
        c = lcmv_constraints(model, n_interf, capacity)
        args = (spec, hist, c, idx, gate, ib)
        got = kl.lcmv_stream(*args)
        ref = kl.lcmv_stream_plain(*args)
        f64 = kl.lcmv_stream_plain(spec.cdouble(), hist.cdouble(),
                                   c.cdouble(), idx, gate, ib)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kl.lcmv_stream(*args))
        plain_ms = cuda_ms(lambda: kl.lcmv_stream_plain(*args), reps=3)
        abs_err = check_solve_kernel(
            f"lcmv_stream M={m} NIB={len(ib)} T={t} W={w} S={c.shape[1]} "
            f"({n_interf} interferers active, {capacity - n_interf} slots "
            "inactive)", got, ref, f64,
            LCMV_STREAM_REL_TOL if n_interf else MVDR_STREAM_REL_TOL, ms,
            plain_ms)
        del f64
        results.setdefault("lcmv_stream", dict(max_abs_err=abs_err, ms=ms,
                                               plain_ms=plain_ms))
    return results


def phase_lcmv(x: np.ndarray, xs: np.ndarray, y_mvdr: np.ndarray) -> tuple:
    """The LCMV main path under the launch preset: run_offline with the
    ``auto`` (streaming solve) and ``dense`` (Gauss-Jordan) solvers, each
    path's launches counted alone, on noise (S = 1), on noise with two
    static interferers (S = 3), on the speech-like input (S = 1) and on
    noise under EVENTS' timeline; each checked against the float64 CPU
    path, and S = 1 against MVDR ``auto`` (``y_mvdr``). Returns (auto
    output on noise, {solver: that path's own launch counts})."""
    from beamform_tpu_torch import run_offline
    t = -(-x.shape[1] // HOP)
    timeline = event_timeline(t)

    def run(sig, solver, scene, dtype="float32", device=DEVICE):
        interf = {"static": INTERFERERS, "events": EVENTS[0]}.get(scene, ())
        return run_offline(
            "lcmv", sig, engine=engine(dtype), array_cfg=aira16(interf),
            theta=THETA, params=lcmv_preset(solver=solver), device=device,
            interference=timeline if scene == "events" else None)

    # each path's own launches: one analysis, one synthesis, and one LCMV
    # stream solve (auto) or two Gauss-Jordan inverses per dense block
    expect = {"auto": dict(wola_analysis=1, wola_synthesis=1, lcmv_stream=1,
                           mvdr_stream=0, gj_inverse=0),
              "dense": dict(wola_analysis=1, wola_synthesis=1,
                            lcmv_stream=0, mvdr_stream=0)}
    scenes = {"noise": x, "static": x, "speech": xs, "events": x}
    outs, launches = {}, {}
    for scene, sig in scenes.items():
        for solver in ("auto", "dense"):
            reset_launches()
            outs[(scene, solver)] = run(sig, solver, scene)
            got = read_launches()
            launches.setdefault(solver, got)
            log(f"lcmv {solver} main path launches ({scene}): {got}")
            if (any(got[k] != n for k, n in expect[solver].items())
                    or (solver == "dense" and got["gj_inverse"] < 1)):
                raise AssertionError(f"lcmv {solver} launches {got}, "
                                     f"expected {expect[solver]}")
    t0 = time.perf_counter()
    refs = {scene: run(sig, "stream", scene, "float64", "cpu")
            for scene, sig in scenes.items()}
    log(f"lcmv float64 CPU references (plain stream solver, full 30 s, 4 "
        f"scenes): {time.perf_counter() - t0:.1f} s")
    n_out = t * HOP
    for (scene, solver), y in outs.items():
        finite = np.isfinite(refs[scene])
        if (y.shape != (n_out,) or not np.array_equal(np.isfinite(y), finite)
                or (scene != "speech" and not finite.all())):
            raise AssertionError(f"lcmv {scene} {solver}: shape {y.shape} / "
                                 "non-finite samples differ")
        dev = float(np.abs(y[finite] - refs[scene][finite]).max())
        log(f"lcmv {scene} {solver} {DEVICE} float32 vs cpu float64: max "
            f"sample deviation {dev:.3e} (bar {DAS_ABS_TOL:g}, peak "
            f"{np.abs(refs[scene][finite]).max():.3e}; non-finite samples "
            f"{int((~finite).sum())} on both)")
        if not dev <= DAS_ABS_TOL:
            raise AssertionError(f"lcmv {scene} {solver} deviation {dev}")
    diff = float(np.abs(outs[("noise", "auto")] - y_mvdr).max())
    log(f"lcmv S=1 vs mvdr, auto on the card (noise): max sample difference "
        f"{diff:.3e} (bar {LCMV_MVDR_TOL:g})")
    if not diff <= LCMV_MVDR_TOL:
        raise AssertionError(f"lcmv S=1 vs mvdr {diff}")
    return outs[("noise", "auto")], launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(card)                # name, power limit: as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    x = make_input(16, SECONDS)
    xs = make_speech_input(16, SECONDS)
    t_main = -(-x.shape[1] // HOP)
    kern = phase_kernels(t_main)
    kern = {"wola_analysis": kern["analysis"],
            "wola_synthesis": kern["synthesis"], **phase_mvdr_kernels(x),
            **phase_lcmv_kernels(x)}
    y, das_launches = phase_das(x)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phase_streaming(x, y, tmp)
        phase_cli(x, tmp)
    phase_xrt(x, card)
    y_mvdr, mvdr_launches = phase_mvdr(x, xs)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phase_streaming(x, y_mvdr, tmp, "mvdr", mvdr_preset())
        phase_cli(x, tmp, "mvdr", mvdr_preset())
    phase_xrt(x, card, "mvdr", mvdr_preset(), "noise")
    phase_xrt(xs, card, "mvdr", mvdr_preset(), "speech")
    phase_xrt(x, card, "mvdr", mvdr_preset(solver="dense"), "noise, dense")
    y_lcmv, lcmv_launches = phase_lcmv(x, xs, y_mvdr)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phase_streaming(x, y_lcmv, tmp, "lcmv", lcmv_preset(), tol=0.0)
        phase_cli(x, tmp, "lcmv", lcmv_preset(), ["--stream", "64"],
                  seconds=4.0, interference=EVENTS[0],
                  events="1.5:2:-60,3:2:70.5", tol=0.0)
    phase_xrt(x, card, "lcmv", lcmv_preset(), "noise, S=1")
    phase_xrt(xs, card, "lcmv", lcmv_preset(), "speech, S=1")
    phase_xrt(x, card, "lcmv", lcmv_preset(), "noise, S=3", INTERFERERS)
    phase_xrt(x, card, "lcmv", lcmv_preset(solver="dense"), "noise, dense")

    launches = {"wola_analysis": das_launches["wola_analysis"],
                "wola_synthesis": das_launches["wola_synthesis"],
                "mvdr_stream": mvdr_launches["auto"]["mvdr_stream"],
                "gj_inverse": mvdr_launches["dense"]["gj_inverse"],
                "lcmv_stream": lcmv_launches["auto"]["lcmv_stream"]}
    csrc = "beamform_tpu_torch/csrc/"
    meta = {"wola_analysis": ("wola.cu",
                              "beamform_tpu/kernels/wola_pallas.py:120"),
            "wola_synthesis": ("wola.cu",
                               "beamform_tpu/kernels/wola_pallas.py:280"),
            "mvdr_stream": ("mvdr_stream.cu",
                            "beamform_tpu/kernels/mvdr_stream.py:209"),
            "gj_inverse": ("linalg.cu", "beamform_tpu/kernels/linalg.py:70"),
            "lcmv_stream": ("lcmv_stream.cu",
                            "beamform_tpu/kernels/lcmv_stream.py:151")}
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": csrc + meta[k][0],
         "replaces": meta[k][1], "launches": launches[k], **kern[k]}
        for k in meta]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
