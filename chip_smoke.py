#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``beamform_tpu_torch/csrc``, checks
each kernel against its plain-torch version at the main path's shapes,
drives the delay-and-sum main path (16 mics of the aira16 array, 48 kHz,
30 s, hop 1024) through ``run_offline``, ``StreamingSession`` and the CLI,
checks the output against the float64 CPU path, and measures the DAS path's
xRT. Every phase raises on failure, so the script exits non-zero without
its final line; it also fails without a CUDA device. It imports no JAX.

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


def aira16():
    from beamform_tpu_torch.config import load_array_config
    return load_array_config(
        os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira16.yaml"))


def engine(dtype="float32"):
    from beamform_tpu_torch.config import EngineConfig
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)


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
    from beamform_tpu_torch.kernels import wola as kw
    cfg = aira16()
    kw.wola_analysis.launches = 0
    kw.wola_synthesis.launches = 0
    y = run_offline("das", x, engine=engine(), array_cfg=cfg, theta=THETA,
                    device=DEVICE)
    launches = {"analysis": kw.wola_analysis.launches,
                "synthesis": kw.wola_synthesis.launches}
    log(f"das main path launches: {launches}")
    if min(launches.values()) < 1:
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


def phase_streaming(x: np.ndarray, y_offline: np.ndarray, tmp: str):
    """StreamingSession in 64-frame chunks == offline; a save/load in the
    middle resumes identically."""
    from beamform_tpu_torch.models import get_model
    from beamform_tpu_torch.runtime.streaming import StreamingSession
    cfg = aira16()
    chunk = 64 * HOP
    xp = np.pad(x, ((0, 0), (0, (-x.shape[1]) % chunk)))
    starts = list(range(0, xp.shape[1], chunk))
    half = len(starts) // 2

    sess = StreamingSession(get_model("das", engine(), cfg, device=DEVICE))
    outs = [sess.process(xp[:, i:i + chunk], THETA).cpu().numpy()
            for i in starts]
    got = np.concatenate(outs)[:len(y_offline)]
    err = float(np.abs(got - y_offline).max())
    log(f"streaming 64-frame chunks vs offline: max abs err {err:.3e} "
        f"(bar {STREAM_TOL:g})")
    if not err <= STREAM_TOL:
        raise AssertionError(f"streaming err {err}")

    first = StreamingSession(get_model("das", engine(), cfg, device=DEVICE))
    outs2 = [first.process(xp[:, i:i + chunk], THETA).cpu().numpy()
             for i in starts[:half]]
    ckpt = os.path.join(tmp, "state.npz")
    first.save(ckpt)
    second = StreamingSession(get_model("das", engine(), cfg, device=DEVICE))
    second.load(ckpt)
    outs2 += [second.process(xp[:, i:i + chunk]).cpu().numpy()
              for i in starts[half:]]
    resumed = np.concatenate(outs2)[:len(y_offline)]
    err2 = float(np.abs(resumed - got).max())
    log(f"streaming save/load at chunk {half}: max abs err vs uninterrupted "
        f"{err2:.3e}")
    if not err2 <= STREAM_TOL or second.frames_done != len(starts) * 64:
        raise AssertionError(f"resume err {err2}, frames "
                             f"{second.frames_done}")


def phase_cli(x: np.ndarray, tmp: str):
    """``beamform-tpu-torch das --device cuda`` on a 2 s 16-ch WAV ==
    run_offline on the same samples."""
    from beamform_tpu_torch import run_offline
    from beamform_tpu_torch.runtime import cli, wav
    src = os.path.join(tmp, "in.wav")
    dst = os.path.join(tmp, "out.wav")
    wav.write_wav(src, x[:, :2 * FS], FS, fmt="float32")
    cfg_path = os.path.join(ROOT, "beamform_tpu_torch", "configs",
                            "aira16.yaml")
    rc = cli.main(["das", "--in", src, "--out", dst, "--array-config",
                   cfg_path, "--theta", str(THETA), "--device", DEVICE,
                   "--out-format", "float32"])
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    got, fs = wav.read_wav(dst)
    xin, _ = wav.read_wav(src)
    ref = run_offline("das", xin, engine=engine(), array_cfg=aira16(),
                      theta=THETA, device=DEVICE)
    err = float(np.abs(got[0] - ref).max())
    log(f"cli das --device {DEVICE} vs run_offline: max abs err {err:.3e}")
    if fs != FS or got.shape != (1, ref.shape[0]) or not err <= 1e-6:
        raise AssertionError(f"cli output mismatch: {got.shape} err {err}")


def phase_xrt(x: np.ndarray, card: str):
    """xRT of the DAS path after warm-up, each run synchronised: with the
    input already on the card (model.process) and end to end from host
    numpy to host numpy (run_offline)."""
    import torch
    from beamform_tpu_torch import run_offline
    from beamform_tpu_torch.models import get_model
    cfg = aira16()
    seconds = x.shape[1] / FS
    model = get_model("das", engine(), cfg, device=DEVICE)
    xd = torch.as_tensor(x, device=DEVICE)

    def on_device():
        model.process(xd, THETA)
        torch.cuda.synchronize()

    def host_to_host():
        run_offline("das", x, engine=engine(), array_cfg=cfg, theta=THETA,
                    device=DEVICE)

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
        log(f"das xRT ({name}, 16 ch, 48 kHz, {seconds:g} s): "
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
    log(f"profile of one device-resident das call (device kernel time "
        f"{total / 1e3:.3f} ms):")
    for e in rows[:12]:
        log(f"  {getattr(e, 'device_time_total', 0.0) / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


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
    t_main = -(-x.shape[1] // HOP)
    kern = phase_kernels(t_main)
    y, launches = phase_das(x)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phase_streaming(x, y, tmp)
        phase_cli(x, tmp)
    phase_xrt(x, card)

    src = "beamform_tpu_torch/csrc/wola.cu"
    replaces = {"analysis": "beamform_tpu/kernels/wola_pallas.py:120",
                "synthesis": "beamform_tpu/kernels/wola_pallas.py:280"}
    log(json.dumps({"kernels": [
        {"name": f"wola_{k}", "route": "cuda", "source": src,
         "replaces": replaces[k], "launches": launches[k], **kern[k]}
        for k in ("analysis", "synthesis")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
