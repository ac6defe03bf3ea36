#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``beamform_tpu_torch/csrc``, checks
each kernel against its plain-torch version at the main paths' shapes,
and drives two main paths at full width (16 mics of the aira16 array,
48 kHz, 30 s, hop 1024) through ``run_offline``, ``StreamingSession`` and
the CLI: delay-and-sum, and MVDR under the reference's launch preset with
the ``auto`` (streaming solve) and ``dense`` (Gauss-Jordan) solvers, on
noise and on a speech-like input. It checks each output against the
float64 CPU path and measures each path's xRT. Every phase raises on
failure, so the script exits non-zero without its final line; it also
fails without a CUDA device. It imports no JAX.

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
F64_FACTOR = 2.0
DAS_ABS_TOL = 1e-3       # float32 on the card vs float64 CPU (BASELINE.md)
STREAM_TOL = 1e-5        # chunked vs offline, both on the card
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


def aira16():
    from beamform_tpu_torch.config import load_array_config
    return load_array_config(
        os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira16.yaml"))


def engine(dtype="float32"):
    from beamform_tpu_torch.config import EngineConfig
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)


def counters():
    """Every kernel wrapper of the port, by the name the kernels line
    uses."""
    from beamform_tpu_torch.kernels import linalg, mvdr_stream, wola
    return {"wola_analysis": wola.wola_analysis,
            "wola_synthesis": wola.wola_synthesis,
            "mvdr_stream": mvdr_stream.mvdr_stream,
            "gj_inverse": linalg.gj_inverse}


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


def check_mvdr_kernel(label, got, ref, f64, bar, ms, plain_ms) -> float:
    """Hold a float32 MVDR kernel's output to its plain float32 version
    (``bar`` of peak) and, against the plain version in complex128 on the
    same operands, to F64_FACTOR times the plain float32 version's own
    error. Logs the numbers; returns the max abs error against plain."""
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
                    node: str = "das", params=None):
    """StreamingSession in 64-frame chunks == offline; a save/load in the
    middle resumes identically."""
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
        f"{err:.3e} (bar {STREAM_TOL:g})")
    if not err <= STREAM_TOL:
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
    if not err2 <= STREAM_TOL or second.frames_done != len(starts) * 64:
        raise AssertionError(f"resume err {err2}, frames "
                             f"{second.frames_done}")


def phase_cli(x: np.ndarray, tmp: str, node: str = "das", params=None):
    """``beamform-tpu-torch <node> --device cuda`` on a 2 s 16-ch WAV ==
    run_offline on the same samples with ``params`` (the node's launch
    preset, which the CLI applies by default)."""
    from beamform_tpu_torch import run_offline
    from beamform_tpu_torch.runtime import cli, wav
    src = os.path.join(tmp, f"{node}_in.wav")
    dst = os.path.join(tmp, f"{node}_out.wav")
    wav.write_wav(src, x[:, :2 * FS], FS, fmt="float32")
    cfg_path = os.path.join(ROOT, "beamform_tpu_torch", "configs",
                            "aira16.yaml")
    rc = cli.main([node, "--in", src, "--out", dst, "--array-config",
                   cfg_path, "--theta", str(THETA), "--device", DEVICE,
                   "--out-format", "float32"])
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    got, fs = wav.read_wav(dst)
    xin, _ = wav.read_wav(src)
    ref = run_offline(node, xin, engine=engine(), array_cfg=aira16(),
                      theta=THETA, params=params, device=DEVICE)
    err = float(np.abs(got[0] - ref).max())
    log(f"cli {node} --device {DEVICE} vs run_offline: max abs err "
        f"{err:.3e}")
    if fs != FS or got.shape != (1, ref.shape[0]) or not err <= 1e-6:
        raise AssertionError(f"cli output mismatch: {got.shape} err {err}")


def phase_xrt(x: np.ndarray, card: str, node: str = "das", params=None,
              label: str = "noise"):
    """xRT of a node's path after warm-up, each run synchronised: with the
    input already on the card (model.process) and end to end from host
    numpy to host numpy (run_offline); then a torch.profiler breakdown of
    one device-resident call."""
    import torch
    from beamform_tpu_torch import run_offline
    from beamform_tpu_torch.models import get_model
    cfg = aira16()
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
        abs_err = check_mvdr_kernel(
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
        abs_err = check_mvdr_kernel(
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
            "wola_synthesis": kern["synthesis"], **phase_mvdr_kernels(x)}
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

    launches = {"wola_analysis": das_launches["wola_analysis"],
                "wola_synthesis": das_launches["wola_synthesis"],
                "mvdr_stream": mvdr_launches["auto"]["mvdr_stream"],
                "gj_inverse": mvdr_launches["dense"]["gj_inverse"]}
    csrc = "beamform_tpu_torch/csrc/"
    meta = {"wola_analysis": ("wola.cu",
                              "beamform_tpu/kernels/wola_pallas.py:120"),
            "wola_synthesis": ("wola.cu",
                               "beamform_tpu/kernels/wola_pallas.py:280"),
            "mvdr_stream": ("mvdr_stream.cu",
                            "beamform_tpu/kernels/mvdr_stream.py:209"),
            "gj_inverse": ("linalg.cu", "beamform_tpu/kernels/linalg.py:70")}
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
