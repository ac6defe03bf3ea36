#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``beamform_tpu_torch/csrc``, checks
each of the fourteen kernels (WOLA analysis and synthesis, the MVDR and
LCMV streaming solves, the Gauss-Jordan inverse, the fused MVDR/LCMV
kernel, the fused GSS kernel, the phase mask, the MPF beams and march, the
MCRA march, and GSC's per-sample, xmu, block-LMS and lookahead-8 adaptive
stages)
against its plain-torch version at the main paths' shapes (the analysis
and the synthesis also at every nfft they take, the analysis with and
without its fused gate statistic, the synthesis split into calls that
must equal one call bit for bit),
with its time beside its bound (the least time the card could take for
the same work) and, where one PyTorch call computes the same function,
that call's time. It drives the main paths at full width (16 mics of the
aira16 array, 48 kHz, 30 s, hop 1024) through ``run_offline``,
``StreamingSession`` and the CLI: delay-and-sum; MVDR and LCMV under the
reference's launch presets with the ``auto`` (streaming solve), ``dense``
(Gauss-Jordan) and ``mega`` (fused) solvers, on noise and on a speech-like
input, LCMV also with two static interferers and with an interference
event timeline; the GSS node on the same scenes; the phase, phasempf and
mcra nodes on noise and on a steered source; the GSC node's
``sample``, ``xmu``, ``blocklms``, ``block`` and ``write_mu`` paths on
noise and speech; and the ``ref`` and ``read`` nodes on noise (with DAS
against ``ref`` on the steered source). Last, batched serving through
``BatchRunner`` at bench.py's bench_batched shape (8 streams, GSC 32, of
10 s in 2 s chunks: DAS, MVDR and LCMV ``auto`` and ``mega``, GSS, GSC
``sample`` and ``blocklms``), each stream against its single-stream run
on the card, one launch of each kernel a chunk; then the live serving
path through ``beamform-tpu-torch <node> --live``: DAS through a
subprocess's pipe at 4 hops a chunk and at one hop a chunk fed at the
audio rate (no xrun), MVDR and LCMV (``--interf-control``) through OS
pipes, the JACK loop over the repository's fake server, each equal to
the card's ``StreamingSession`` bit for bit; last, the multi-device layer
(``beamform_tpu_torch/parallel``): a 2-rank gloo world on the one card
splits MVDR and LCMV over bin groups and DAS, GSS and phase over streams,
and a 1-rank NCCL world runs the same, each rank's shards equal to
``BatchRunner``'s bit for bit, then ``evaluate_separation`` on the card
against float64 and ``examples/torch_demo.py``. It checks each output
against the float64 CPU path, counts each path's own kernel launches, and
measures each path's xRT and device time per call (CUDA events). Each
phase logs ``phase <name>: start`` and ``phase <name>: ok`` and raises on
failure, so the script exits non-zero without its final line; it also
fails without a CUDA device. It imports no JAX.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import multiprocessing
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
# (measured on an H100: mvdr_stream 1.9e-4, gj_inverse 7.4e-5 and 1.4e-4
# with the polish). Each kernel is also held to F64_FACTOR times its plain
# float32 version's own error against the plain version in complex128.
MVDR_STREAM_REL_TOL = 5e-4
# the sparse-gate case of the MVDR stream kernel: the share of (frame, bin)
# pairs that pass, the quiet mix's (portbench's mvdr-quiet-b32: 17.4%)
SPARSE_GATE = 0.174
GJ_REL_TOL = 2e-4
# lcmv_stream vs its plain version, max error / max |ref|, at the main
# shapes with interferers: the MVDR solve's conditioning, compounded by the
# inner system (measured on an H100: 1.7e-3 at S = 3 and S = 16); with one
# constraint the algebra is MVDR's, and so is the bar
LCMV_STREAM_REL_TOL = 3e-3
F64_FACTOR = 2.0
DAS_ABS_TOL = 1e-3       # float32 on the card vs float64 CPU (BASELINE.md)
STREAM_TOL = 1e-5        # chunked vs offline, both on the card
# LCMV with one constraint vs MVDR, both float32 on the card, on the same
# input, absolute: the two stream kernels share tri_solve.cuh's refined
# solve and differ only in the final division (LCMV's scalar inner system)
LCMV_MVDR_TOL = 1e-6
# the LCMV scenes: two static interferers, and an event timeline over one
# (an add with the row-0 quirk at 10 s, a proximity removal at 20 s under
# the preset's threshold 1.0, replayed at capacity 15)
INTERFERERS = (70.0, -60.0)
EVENTS = ((70.0,), "10:2:-60,20:2:70.5")
# the fused MVDR/LCMV kernel vs its plain version (max error / max |ref|
# of the audio): unrefined float32 solves, as the TPU kernel's default;
# with interferers the inner system compounds R's conditioning, as for
# lcmv_stream. Each is also held to F64_FACTOR times the plain float32
# version's own error against the plain version in complex128.
MEGA_REL_TOL = 5e-4
MEGA_LCMV_REL_TOL = 3e-3
# the fused GSS kernel vs its plain version: the same march in another
# summation order, no solve (no conditioning to amplify round-off)
GSS_REL_TOL = 1e-5
# the phase masks' contract (the JAX package's tests/test_phase_mask.py
# assert_close_mod_flips), relative to the reference's peak: the 99.9th
# percentile of the deviation under FLIP_TIGHT, at most FLIP_FRAC of the
# values over it (the bins that a rounding difference moves across a
# binary mask's threshold), none over FLIP_CEIL
FLIP_TIGHT, FLIP_FRAC, FLIP_CEIL = 5e-5, 1e-3, 5e-2
# the JAX package's own float32 error against its float64 path, max sample
# deviation, on the first 10 s of this script's noise and source inputs
# under the launch presets (its float32 path on the CPU is the batched
# formulation; measured on an x86 CPU and printed by
# tests/test_torch_phase.py, test_torch_phasempf.py and test_torch_mcra.py,
# test_*_float32_error_is_the_jax_packages; GSC's, its mu trace's too, on
# the first GSC_REF_HOPS hops of the 30 s noise and speech inputs, printed
# by tests/test_torch_gsc.py). A node's float32 output on the card is held
# to F64_FACTOR times it, or to the flip contract (GSC: 1e-3) against the
# float64 CPU path, whichever is looser.
JAX_F32_DEV = {("gsc sample", "noise"): 4.319052691048597e-07,
               ("gsc sample", "speech"): 5.778214488827427e-07,
               ("gsc blocklms128", "noise"): 4.210896216716442e-07,
               ("gsc blocklms128", "speech"): 3.2633158316211497e-07,
               ("gsc blocklms512", "noise"): 4.214430540452896e-07,
               ("gsc blocklms512", "speech"): 3.239743388630534e-07,
               ("gsc mu trace", "noise"): 3.792054392526411e-05,
               ("gsc mu trace", "speech"): 0.001019976902577537,
               ("phase", "noise"): 3.391656192182346e-08,
               ("phase", "source"): 2.038878882615336e-06,
               ("phasempf", "noise"): 4.8331931596572e-11,
               ("phasempf", "source"): 5.040598329841828e-06,
               ("mcra", "noise"): 4.082204300426273e-07,
               ("mcra", "source"): 1.65012677477705e-05}
# the write_mu trace against the float64 CPU trace: each line's relative
# deviation (mu_trace_dev) within this, or within F64_FACTOR times the JAX
# package's own float32 error on the same lines, whichever is looser (the
# lead-in's lines divide by powers near float32's resolution)
MU_TRACE_TOL = 1e-3
# GSC's per-sample paths are held to the float64 CPU recurrence over their
# first GSC_REF_HOPS hops (98,304 samples): the chain is causal, so that
# prefix is the same computation, and the float64 loop over all 30 s would
# take minutes
GSC_REF_HOPS = 96
# the GSC kernels against their plain versions: two streams of this many
# hops (the plain per-sample loop takes ~0.1 ms a sample on the card), with
# the VAD gate at GSC_VAD, where it holds the filters over part of the
# noise and speech inputs (their outputs' power is ~0.025 past the
# lead-in)
GSC_CHECK_HOPS = 48
GSC_VAD = 0.025
# the lookahead-8 kernel against its plain version over the first this
# many of those hops: the plain version's chain is ~200 small launches a
# group of 8 samples (20 s in float32 for 48 hops on the card), and it
# runs in float32 and float64 for each VAD setting
GSC_BLOCK_CHECK_HOPS = 24
# worker processes for the GSC float64 CPU references, which run beside the
# card's phases (the per-sample recurrence's loop is serial: the six took
# 72 s one after the other on the H100's host)
REF_WORKERS = 3
# operations counted for one float32 atan2 (the JAX package's atan2f: two
# abs, max, min, the fold test, one division, the degree-4 odd polynomial
# and the octant and quadrant selects)
ATAN2_OPS = 20
REPS = 20
# the least time of a call (the H100 SXM's published peaks, at 700 W):
# HBM bytes, and float32 operations outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the marches' serial chain, one frame of the noise update (csrc/march.cuh
# lam_step): a multiply, an add and a select, each dependent on the last,
# at ~4 cycles each
CHAIN_CYCLES = 12
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def log(*a):
    print(*a, flush=True)


def phase(name, fn, *args, **kwargs):
    """Run one phase, logging its start, its end and its seconds, so that
    a failure names its phase."""
    log(f"phase {name}: start")
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    return out


def bound(nbytes: float, flops: float) -> dict:
    """The least time of a call that moves ``nbytes`` (each input read
    once, each output written once) and does ``flops`` float32
    operations, and which of the two bounds it."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOP_PER_S * 1e3
    log(f"  bound: {nbytes / 1e6:.1f} MB -> {t_b:.4f} ms, {flops / 1e9:.2f} "
        f"Gflop -> {t_f:.4f} ms")
    return dict(bound_ms=max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations")


def fft_flops(n: int) -> float:
    """Operations of one complex n-point FFT, the usual 5 n log2 n."""
    return 5.0 * n * np.log2(n)


def solve_flops(pairs: int, m: int, t: int, w: int, nib: int,
                slots: int = 1, refine: bool = True, inner: int = 0) -> float:
    """Operations of the MVDR and LCMV solves over ``t`` frames after
    ``w`` history frames at ``nib`` bins, as few as the function needs.
    The window covariance slides, gate or not: each frame's outer product
    goes into the window sum and the epoch accumulator (10 operations per
    entry of the Hermitian triangle, M (M + 1) / 2 entries), and leaves
    the window W frames later (8). Each of the ``pairs`` gated (frame, bin)
    problems then takes the complex Cholesky factor (8/3 M^3), per
    constraint slot a forward and a backward solve (4 M^2 each; refinement
    adds a residual, 8 M^2, and a second pair), for LCMV the S x S inner
    system (the Hermitian G = C^H X, 4 S (S + 1) M; its Cholesky factor,
    4/3 S^3, and two solves, 8 S^2; w = X v, 8 S M), and y = w^H x."""
    tri = m * (m + 1) / 2
    cov = ((t + w) * 10 + t * 8) * nib * tri
    per = 8 / 3 * m ** 3 + slots * (3 if refine else 1) * 8 * m * m + 8 * m
    if inner:
        per += (4 * inner * (inner + 1) * m + 4 / 3 * inner ** 3
                + 8 * inner ** 2 + 8 * inner * m)
    return cov + pairs * per


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


def make_source_input(num_mics: int, seconds: float) -> np.ndarray:
    """A far-field source at THETA over the aira16 array (its delays
    applied exactly in the frequency domain), pink-ish like
    make_speech_input and under its envelope, at a level where the phase
    node's magnitude gate passes in the loud low bins, plus weak noise: the
    phase masks see bins on both sides of their thresholds."""
    import torch
    from beamform_tpu_torch.geometry import ArrayGeometry, steering_delays
    rng = np.random.default_rng(11)
    n = int(seconds * FS)
    tau = steering_delays(ArrayGeometry.from_config(aira16()),
                          torch.tensor(THETA, dtype=torch.float64)).numpy()
    f = np.fft.rfftfreq(n, 1.0 / FS)
    src = np.fft.rfft(rng.standard_normal(n)) / np.sqrt(1.0 + f / 300.0)
    x = np.fft.irfft(src[None] * np.exp(-2j * np.pi * f[None]
                                        * tau[:num_mics, None]), n=n)
    x /= np.std(x)
    t = np.arange(n) / FS
    syllab = np.clip(np.sin(2 * np.pi * 3.7 * t) + 0.2, 0.0, 1.0)
    phrase = (np.sin(2 * np.pi * 0.37 * t + 1.0) > -0.2).astype(np.float64)
    x = 3.0 * x * (syllab * phrase)[None, :]
    x += 0.01 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def preset(node: str, **kw) -> dict:
    """The reference's launch preset for ``node``, plus overrides."""
    from beamform_tpu_torch.config import load_launch_params
    return dict(load_launch_params(node), **kw)


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
        preset("lcmv")["interf_angle_threshold"])


def engine(dtype="float32"):
    from beamform_tpu_torch.config import EngineConfig
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)


def counters():
    """Every kernel wrapper of the port, by the name the kernels line
    uses."""
    from beamform_tpu_torch.kernels import (gsc, gsc_block, gsc_blocklms,
                                            gss_stream, lcmv_stream, linalg,
                                            mega_stream, mvdr_stream,
                                            phase_mask, wola)
    return {"wola_analysis": wola.wola_analysis,
            "wola_synthesis": wola.wola_synthesis,
            "mvdr_stream": mvdr_stream.mvdr_stream,
            "gj_inverse": linalg.gj_inverse,
            "lcmv_stream": lcmv_stream.lcmv_stream,
            "mega_stream": mega_stream.mega_stream,
            "gss_stream": gss_stream.gss_mega,
            "phase_mask": phase_mask.phase_mask,
            "mpf_march": phase_mask.mpf_march,
            "mcra_march": phase_mask.mcra_march,
            "gsc_sample": gsc.gsc_sample,
            "gsc_xmu": gsc.gsc_xmu,
            "gsc_blocklms": gsc_blocklms.gsc_blocklms,
            "gsc_block": gsc_block.gsc_block}


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


class SmClocks:
    """nvidia-smi's clocks.sm (MHz) every 50 ms while open, beside a
    timed call, of the card that torch's current device is."""

    def __enter__(self):
        import torch
        uuid = str(torch.cuda.get_device_properties(
            torch.cuda.current_device()).uuid)
        gpu = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", gpu, "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        # the first sample before the timed calls, so that a window shorter
        # than nvidia-smi's start has one
        self.first = self.proc.stdout.readline()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.first + self.proc.communicate(timeout=30)[0]
        self.mhz = [float(v) for v in out.split() if v.replace(".", "", 1)
                    .isdigit()]
        return False

    def summary(self) -> str:
        if not self.mhz:
            return "clocks.sm not read"
        return (f"clocks.sm median {np.median(self.mhz):.0f} MHz (min "
                f"{min(self.mhz):.0f}, max {max(self.mhz):.0f}, "
                f"{len(self.mhz)} samples)")


def chain_cycles(ms: float, clk: "SmClocks", samples: int) -> str:
    """A serial chain's SM-cycles per sample: ms x clocks.sm (the median
    nvidia-smi read during the timed calls) / the samples of one chain."""
    if not clk.mhz:
        return "cycles per sample not measured (clocks.sm not read)"
    mhz = float(np.median(clk.mhz))
    return (f"{ms * 1e3 * mhz / samples:.1f} SM-cycles per sample at "
            f"{mhz:.0f} MHz")


def gsc_group_counts(fn) -> str:
    """fn() run once between two reads of the per-sample kernel's group
    counts: the groups it ran factorised and those it replayed."""
    from beamform_tpu_torch.kernels import gsc as kg
    f0, r0 = kg.gsc_sample.group_counts()
    fn()
    f1, r1 = kg.gsc_sample.group_counts()
    return f"groups factorised {f1 - f0}, replayed {r1 - r0}"


def solve_cycles(ms: float, clk: "SmClocks", pairs: int) -> str:
    """A solve kernel's SM-cycles per solved (frame, bin) problem: ms x
    clocks.sm (the median nvidia-smi read during the timed calls) x the
    card's SMs / the passing pairs."""
    import torch
    if not clk.mhz:
        return "cycles per solved problem not measured (clocks.sm not read)"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(np.median(clk.mhz))
    cyc = ms * 1e-3 * mhz * 1e6 * sms / pairs
    return (f"{cyc:.1f} SM-cycles per solved problem ({ms:.4f} ms x "
            f"{mhz:.0f} MHz x {sms} SMs / {pairs} pairs)")


def _err(got, ref):
    """(max abs error, max abs error / max |ref|) over paired tensors."""
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return abs_err, abs_err / scale


def check_solve_kernel(label, got, ref, f64, bar, ms, plain_ms) -> float:
    """Hold a float32 solve kernel's output (MVDR, LCMV, Gauss-Jordan, or
    the audio of a fused kernel) to its plain float32 version (``bar`` of
    peak) and, against the plain version in double precision (``f64``,
    complex128 or float64) on the same operands, to F64_FACTOR times the
    plain float32 version's own error. Logs the numbers; returns the max
    abs error against plain."""
    import torch
    abs_err, rel_err = _err([got], [ref])
    k64 = _err([got.to(f64.dtype)], [f64])[1]
    p64 = _err([ref.to(f64.dtype)], [f64])[1]
    log(f"kernel {label}: max_abs_err {abs_err:.3e} rel {rel_err:.3e} (bar "
        f"{bar:g}); vs {str(f64.dtype)[6:]} kernel {k64:.3e}, plain "
        f"{p64:.3e} (bar {F64_FACTOR:g}x plain); {ms:.4f} ms vs plain torch "
        f"{plain_ms:.4f} ms")
    finite = torch.isfinite(torch.view_as_real(got) if got.is_complex()
                            else got).all()
    if not (rel_err <= bar and k64 <= F64_FACTOR * p64 and finite):
        raise AssertionError(f"{label}: rel err {rel_err}, vs "
                             f"{f64.dtype} {k64} (plain {p64})")
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

    # the analysis at every nfft it takes (each its own pass plan), odd and
    # even channel counts, one frame to a streaming chunk, with and without
    # the fused gate statistic: one launch each, checked, not timed
    worst, n_cases = 0.0, 0
    for hop in (128, 256, 512, 1024, 2048):
        for c in (1, 5, 16):
            for t in (1, 7, 64):
                for with_mag in (False, True):
                    x = torch.as_tensor(
                        0.1 * rng.standard_normal((c, t * hop)),
                        dtype=torch.float32, device=dev)
                    tail = torch.as_tensor(
                        0.1 * rng.standard_normal((c, hop)),
                        dtype=torch.float32, device=dev)
                    before = kw.wola_analysis.launches
                    got = kw.wola_analysis(x, tail, with_mag)
                    ref = kw.wola_analysis_plain(x, tail, with_mag)
                    pairs = [(got[0], ref[0]), (got[2], ref[2])]
                    if with_mag:
                        pairs.append((got[1], ref[1]))
                    rel = _err(*zip(*pairs))[1]
                    worst, n_cases = max(worst, rel), n_cases + 1
                    if not (rel <= KERNEL_REL_TOL and
                            kw.wola_analysis.launches == before + 1):
                        raise AssertionError(
                            f"analysis nfft={2 * hop} C={c} T={t} "
                            f"mag={with_mag}: rel err {rel}")
    log(f"kernel analysis at nfft 256..4096, C 1/5/16, T 1/7/64, with and "
        f"without mag ({n_cases} cases): worst rel err {worst:.3e} (bar "
        f"{KERNEL_REL_TOL:g}), one launch each")

    # the synthesis at every nfft (256 on the full-length inverse, the
    # others on the half-length one), C 1/5/16, T 1/2/7: one launch each,
    # checked, not timed
    worst, n_cases = 0.0, 0
    for hop in (128, 256, 512, 1024, 2048):
        for c in (1, 5, 16):
            for t in (1, 2, 7):
                y = torch.complex(*(torch.as_tensor(
                    rng.standard_normal((c, t, hop + 2)),
                    dtype=torch.float32, device=dev) for _ in range(2)))
                prev = torch.as_tensor(rng.standard_normal((c, hop)),
                                       dtype=torch.float32, device=dev)
                before = kw.wola_synthesis.launches
                got = kw.wola_synthesis(y, prev)
                rel = _err(got, kw.wola_synthesis_plain(y, prev))[1]
                worst, n_cases = max(worst, rel), n_cases + 1
                if not (rel <= KERNEL_REL_TOL and
                        kw.wola_synthesis.launches == before + 1):
                    raise AssertionError(
                        f"synthesis nfft={2 * hop} C={c} T={t}: rel err "
                        f"{rel}")
    log(f"kernel synthesis at nfft 256..4096, C 1/5/16, T 1/2/7 ({n_cases} "
        f"cases): worst rel err {worst:.3e} (bar {KERNEL_REL_TOL:g}), one "
        "launch each")
    # blocks own whole hops: calls split at frames 1, 63, 64 and 700 equal
    # one call bit for bit
    y = torch.complex(*(torch.as_tensor(
        rng.standard_normal((16, t_main, HOP + 2)), dtype=torch.float32,
        device=dev) for _ in range(2)))
    prev = torch.as_tensor(rng.standard_normal((16, HOP)),
                           dtype=torch.float32, device=dev)
    whole = kw.wola_synthesis(y, prev)
    edges = [0, 1, 63, 64, 700, t_main]
    parts, carry = [], prev
    for a, b in zip(edges[:-1], edges[1:]):
        out, carry = kw.wola_synthesis(y[:, a:b].contiguous(), carry)
        parts.append(out)
    if not (torch.equal(torch.cat(parts, 1), whole[0])
            and torch.equal(carry, whole[1])):
        raise AssertionError("synthesis chunks differ from one call")
    log(f"kernel synthesis C=16 T={t_main} split at frames {edges[1:-1]}: "
        "equal to one call bit for bit")

    cases = [("analysis", 16, t_main, False), ("analysis", 16, t_main, True),
             ("analysis", 16, 256, False), ("analysis", 16, 256, True),
             ("synthesis", 1, t_main, None), ("synthesis", 16, t_main, None),
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
        if kind == "synthesis" and t == t_main:
            # the kernel's own time beside the call through the wrapper
            log_launch_split(lambda: kw.wola_synthesis(y, prev), "wola_inv")
        # the kernels line: the analysis at 16 channels, the synthesis at
        # one (DAS and the other one-channel paths; GSC's 16 logged)
        if t == t_main and not with_mag:
            yard = wola_yardsticks(kind, c, t, x if kind == "analysis"
                                   else y, tail if kind == "analysis"
                                   else prev)
            if c == (16 if kind == "analysis" else 1):
                results[kind] = dict(max_abs_err=abs_err, ms=ms,
                                     plain_ms=plain_ms, **yard)
    return results


def wola_yardsticks(kind: str, c: int, t: int, a, b) -> dict:
    """The bound and the PyTorch library call of a WOLA kernel at (C, T):
    ``torch.stft`` (center=False, the sqrt-Hann window) of [tail | x] for
    the analysis, ``torch.istft`` of the one-sided spectra for the
    synthesis."""
    import torch
    from beamform_tpu_torch.dsp.wola import sqrt_hann
    n = 2 * HOP
    win = torch.as_tensor(sqrt_hann(n), dtype=torch.float32, device=a.device)
    if kind == "analysis":
        nbytes = 4 * c * t * HOP + 4 * c * HOP + 8 * t * c * (HOP + 2)
        flops = -(-c // 2) * t * fft_flops(n) + c * t * n
        ext = torch.cat([b, a], dim=-1)
        lib_ms = cuda_ms(lambda: torch.stft(ext, n_fft=n, hop_length=HOP,
                                            window=win, center=False,
                                            return_complex=True))
        log(f"  library: torch.stft {lib_ms:.4f} ms (one-sided bins "
            "0..nfft/2: no shadow bin, no gate statistic)")
    else:
        nbytes = 8 * c * t * (HOP + 2) + 8 * c * HOP + 4 * c * t * HOP
        flops = c * t * fft_flops(n) + c * t * n
        ys = a[..., :HOP + 1].transpose(1, 2).contiguous()
        env = float(((win[:HOP] ** 2 + win[HOP:] ** 2) - 1).abs().max())
        # center=False fails torch's NOLA check (the first sample's window
        # envelope is 0); center=True trims the edges and divides the rest
        # by the envelope, which is 1 at 50% overlap
        lib_ms = cuda_ms(lambda: torch.istft(ys, n_fft=n, hop_length=HOP,
                                             window=win, center=True))
        log(f"  library: torch.istft {lib_ms:.4f} ms (center=True; window "
            f"envelope sum w^2 at 50% overlap = 1 within {env:.1e}; no "
            "shadow-bin fold, no carry)")
    return dict(**bound(nbytes, flops), library_ms=lib_ms)


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
              label: str = "noise", interference=(), reps: int = 10,
              warmups: int = 3):
    """xRT of a node's path after ``warmups`` calls, median of ``reps``
    runs, each synchronised: with the input already on the card
    (model.process) and end to end from host numpy to host numpy
    (run_offline); the device time of one call by CUDA events; then a
    torch.profiler breakdown of one device-resident call. Returns the
    device time per call in ms."""
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
        for _ in range(warmups):
            fn()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        log(f"{node} xRT ({name}, {label}, 16 ch, 48 kHz, {seconds:g} s): "
            f"{seconds / med:.1f}x real time (median {med * 1e3:.3f} ms of "
            f"{reps}, min {min(walls) * 1e3:.3f}, max "
            f"{max(walls) * 1e3:.3f}) on {card}")

    # the device time of one call: CUDA events around the device-resident
    # call; the profiler below only breaks it down
    event_ms = cuda_ms(lambda: model.process(xd, THETA), reps=reps)
    log(f"{node} device time per call ({label}, CUDA events, median of "
        f"{reps}): {event_ms:.3f} ms on {card}")

    # one warm-up call inside the profiler before the recorded one: without
    # it the trace lost most of a call's kernels in some profiles
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for _ in range(2):
            on_device()
            prof.step()
    # host-side rows (operators, runtime calls, the step marker) carry the
    # device time of the kernels they launched: only kernel rows are summed
    rows = sorted((e for e in prof.key_averages()
                   if not e.key.startswith("ProfilerStep")),
                  key=lambda e: getattr(e, "device_time_total", 0.0),
                  reverse=True)
    total = sum(getattr(e, "device_time_total", 0.0) for e in rows
                if not e.key.startswith(("aten::", "cuda")))
    log(f"profile of one device-resident {node} call ({label}; kernels sum "
        f"{total / 1e3:.3f} ms, {100 * total / 1e3 / event_ms:.1f}% of the "
        f"event total {event_ms:.3f} ms"
        + ("" if total / 1e3 >= 0.9 * event_ms else
           "; the profiler misses device time or the stream idles")
        + "):")
    for e in rows[:12]:
        log(f"  {getattr(e, 'device_time_total', 0.0) / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    return event_ms


def phase_mvdr_kernels(x: np.ndarray, xs: np.ndarray) -> dict:
    """The MVDR kernels against their plain versions on the card, on the
    main path's real operands: the analysis of the 30 s input under the
    launch preset (678 in-band bins, 1407 frames, W = 10) for mvdr_stream,
    with one steering and with a theta timeline, then under a sparse gate
    (the pairs where the speech-like input's gate statistic passes its
    quantile that keeps SPARSE_GATE of them, clustered by its envelope and
    spectrum like the quiet mix's), each with its fill share
    (``slot_counts``: pairs solved over slots issued); one dense block of
    covariances (82 frames x 678 bins = 55,596 16 x 16 matrices) for
    gj_inverse, unpolished and polished, then LCMV's inner matrices over
    that block (S = 1 and 3, polished) and a seeded 32-mic block. Returns
    the numbers per kernel."""
    import torch
    from beamform_tpu_torch.kernels import linalg as kl
    from beamform_tpu_torch.kernels import mvdr_stream as km
    from beamform_tpu_torch.kernels.wola import wola_analysis
    from beamform_tpu_torch.models import common, get_model
    from beamform_tpu_torch.models.mvdr import white_r
    dev = torch.device(DEVICE)
    params = preset("mvdr")
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
    # the sparse gate's pattern is the speech-like input's; its operands
    # are the noise input's, whose every window has full rank (a pair the
    # speech passes right after a pause has a silent window: NaN in every
    # version)
    sp_mag = wola_analysis(
        common.prepare_input(xs, engine(), torch.float32, dev),
        torch.zeros((16, HOP), device=dev), with_mag=True)[1]
    sp_stat = sp_mag.index_select(1, ib)
    sp_gate = sp_stat > torch.quantile(sp_stat.flatten(), 1 - SPARSE_GATE)
    for label, theta, gx in (
            ("one steering", THETA, gate),
            ("theta timeline", th, gate),
            ("sparse gate", THETA, sp_gate)):
        uniq, w_idx = model.batch_controls(np.broadcast_to(theta, (1, t)))
        w_idx = w_idx[0]
        d = common.weights_for_thetas(model.geom, model.freqs, uniq,
                                      torch.float32, torch.complex64)
        d = d.index_select(2, ib)
        args = (spec, hist, d, w_idx, gx, ib)
        before = km.mvdr_stream.slot_counts()
        got = km.mvdr_stream(*args)
        pairs, slots = (a - b for a, b in zip(km.mvdr_stream.slot_counts(),
                                             before))
        if pairs != int(gx.sum()):
            raise AssertionError(f"mvdr_stream ({label}): slot_counts saw "
                                 f"{pairs} pairs, the gate holds "
                                 f"{int(gx.sum())}")
        ref = km.mvdr_stream_plain(*args)
        f64 = km.mvdr_stream_plain(spec.cdouble(), hist.cdouble(),
                                   d.cdouble(), w_idx, gx, ib)
        torch.cuda.synchronize()
        with SmClocks() as clk:
            ms = cuda_ms(lambda: km.mvdr_stream(*args))
        plain_ms = cuda_ms(lambda: km.mvdr_stream_plain(*args), reps=3)
        abs_err = check_solve_kernel(
            f"mvdr_stream M={m} NIB={len(ib)} T={t} W={w} U={d.shape[0]} "
            f"({label}; gate passes {float(gx.float().mean()):.4f} of "
            "(frame, bin) pairs)", got, ref, f64, MVDR_STREAM_REL_TOL, ms,
            plain_ms)
        log(f"  mvdr_stream ({label}): "
            f"{solve_cycles(ms, clk, int(gx.sum()))}; fill share "
            f"{pairs / slots:.4f} ({pairs} pairs solved / {slots} slots "
            "issued)")
        del f64
        if "mvdr_stream" not in results:
            nib = len(ib)
            results["mvdr_stream"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                **bound(8 * (t + w + d.shape[0]) * m * nib + 9 * t * nib,
                        solve_flops(pairs, m, t, w, nib)), library_ms=None)

    # one dense block, as MvdrModel._solve_dense builds it
    cb = model._block_frames(t)
    c0 = max(w, min(4 * cb, t - cb))              # past the quiet lead-in
    e = spec[c0 - w:c0 + cb].index_select(2, ib)
    o = torch.einsum("tmn,tkn->tnmk", e, e.conj())
    ones = torch.ones((cb, cb + w), device=dev)
    band = (ones.tril(w - 1) - ones.tril(-1)).to(torch.complex64)
    r = (torch.einsum("ct,tnmk->cnmk", band, o)
         * white_r(m, torch.float32, dev)).reshape(-1, m, m).contiguous()
    b = r.shape[0]
    for polish in (False, True):
        abs_err, ms, plain_ms = check_gj("dense block", r, polish)
        log_launch_split(lambda: kl.gj_inverse(r, polish=polish),
                         "gj_inverse_kernel", calls=20)
        # the elimination's 8 M^3 operations a matrix; the polish's two
        # products 16 M^3 more
        nb = bound(2 * 8 * b * m * m, (24 if polish else 8) * b * m ** 3)
        if not polish:
            lib_ms = cuda_ms(lambda: torch.linalg.inv(r))
            log(f"  library: torch.linalg.inv {lib_ms:.4f} ms")
            results["gj_inverse"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **nb,
                library_ms=lib_ms)

    # LCMV's inner S x S matrices, C^H R^-1 C, over the same block at S = 1
    # (the preset) and S = 3 (two static interferers), polished as
    # lcmv_solve inverts them; and 32 mics, at a fifth of the block's
    # matrices: seeded rank-16 covariances under MVDR's loading, whose
    # condition (~1e4) is the 16-mic block's, for which GJ_REL_TOL is set
    # (at rank 10 it reaches ~3e4, and the two float32 versions then part
    # by more than the bar while both stay as far from complex128)
    lcmv = get_model("lcmv", engine(), aira16(), preset("lcmv"), device=dev)
    x_r = kl.gj_inverse_plain(r, polish=False)
    for n_interf, cap in ((0, 0), (2, 2)):
        c = lcmv_constraints(lcmv, n_interf, cap)[0]       # (S, M, NIB)
        cm = c.permute(2, 1, 0).expand(cb, -1, -1, -1).reshape(b, m, -1)
        inner = (cm.conj().transpose(1, 2) @ (x_r @ cm)).contiguous()
        check_gj(f"LCMV inner S={inner.shape[1]}", inner, True)
    rng = np.random.default_rng(32)
    k32 = torch.complex(*(torch.as_tensor(
        rng.standard_normal((b // 5, 32, 16)), dtype=torch.float32,
        device=dev) for _ in range(2)))
    r32 = ((k32 @ k32.conj().transpose(1, 2))
           * white_r(32, torch.float32, dev)).contiguous()
    for polish in (False, True):
        check_gj("rank-16, 32 mics", r32, polish)
    return results


def check_gj(label: str, a, polish: bool) -> tuple:
    """gj_inverse on ``a`` against its plain version: GJ_REL_TOL of peak,
    and F64_FACTOR times the plain version's own error against complex128.
    Returns (max abs error, ms, the plain version's ms)."""
    from beamform_tpu_torch.kernels import linalg as kl
    got = kl.gj_inverse(a, polish=polish)
    ref = kl.gj_inverse_plain(a, polish=polish)
    f64 = kl.gj_inverse_plain(a.cdouble(), polish=polish)
    ms = cuda_ms(lambda: kl.gj_inverse(a, polish=polish))
    plain_ms = cuda_ms(lambda: kl.gj_inverse_plain(a, polish=polish), reps=5)
    abs_err = check_solve_kernel(
        f"gj_inverse {label} B={a.shape[0]} M={a.shape[1]} polish={polish}",
        got, ref, f64, GJ_REL_TOL, ms, plain_ms)
    return abs_err, ms, plain_ms


def phase_mvdr(x: np.ndarray, xs: np.ndarray) -> tuple:
    """The MVDR main path under the launch preset: run_offline with the
    ``auto`` (streaming solve) and ``dense`` (Gauss-Jordan) solvers, on the
    noise input and the speech-like input, with counted launches, checked
    against the float64 CPU path and against each other. Returns ({(input,
    solver): output}, {input: float64 CPU output}, {solver: that path's
    own launch counts})."""
    import torch
    from beamform_tpu_torch import run_offline
    from beamform_tpu_torch.models import common, get_model
    cfg = aira16()
    t = -(-x.shape[1] // HOP)
    th = np.full(t, 10.0)
    th[t // 2:] = -40.0

    def run(sig, solver, theta=THETA, dtype="float32", device=DEVICE):
        return run_offline("mvdr", sig, engine=engine(dtype), array_cfg=cfg,
                           theta=theta, params=preset("mvdr", solver=solver),
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

    model = get_model("mvdr", engine(), cfg, preset("mvdr"), device=DEVICE)
    for inp, sig in (("noise", x), ("speech", xs)):
        xp = common.prepare_input(sig, engine(), torch.float32, DEVICE)
        _, mag, _ = common.stft_streams_carry(
            xp[None], engine(), model.window, torch.complex64,
            torch.zeros((1, 16, HOP), device=DEVICE), with_mag=True)
        mag = mag[:, 0]
        share = float((mag.index_select(1, model.ib)
                       > model.params.freq_mag_threshold).float().mean())
        log(f"mvdr {inp}: the energy gate passes {share:.4f} of "
            f"{mag.shape[0]} x {len(model.ib)} (frame, bin) pairs")
    return outs, refs, launches


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
    params = preset("lcmv")
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
        with SmClocks() as clk:
            ms = cuda_ms(lambda: kl.lcmv_stream(*args))
        plain_ms = cuda_ms(lambda: kl.lcmv_stream_plain(*args), reps=3)
        abs_err = check_solve_kernel(
            f"lcmv_stream M={m} NIB={len(ib)} T={t} W={w} S={c.shape[1]} "
            f"({n_interf} interferers active, {capacity - n_interf} slots "
            "inactive)", got, ref, f64,
            LCMV_STREAM_REL_TOL if n_interf else MVDR_STREAM_REL_TOL, ms,
            plain_ms)
        log(f"  lcmv_stream S={c.shape[1]}: "
            f"{solve_cycles(ms, clk, int(gate.sum()))}")
        del f64
        if "lcmv_stream" not in results:
            nib, s_cap = len(ib), c.shape[1]
            results["lcmv_stream"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                **bound(8 * (t + w + s_cap) * m * nib + 9 * t * nib,
                        solve_flops(int(gate.sum()), m, t, w, nib, s_cap,
                                    inner=s_cap)), library_ms=None)
    return results


def phase_lcmv(x: np.ndarray, xs: np.ndarray, y_mvdr: np.ndarray,
               y_mvdr64: np.ndarray) -> tuple:
    """The LCMV main path under the launch preset: run_offline with the
    ``auto`` (streaming solve) and ``dense`` (Gauss-Jordan) solvers, each
    path's launches counted alone, on noise (S = 1), on noise with two
    static interferers (S = 3), on the speech-like input (S = 1) and on
    noise under EVENTS' timeline; each checked against the float64 CPU
    path, and S = 1 ``auto`` against MVDR ``auto`` on the card (``y_mvdr``;
    the difference from MVDR's float64 CPU output, ``y_mvdr64``, is
    logged). Returns ({(scene, solver): output}, {scene: float64 CPU
    output}, {solver: that path's own launch counts})."""
    from beamform_tpu_torch import run_offline
    t = -(-x.shape[1] // HOP)
    timeline = event_timeline(t)

    def run(sig, solver, scene, dtype="float32", device=DEVICE):
        interf = {"static": INTERFERERS, "events": EVENTS[0]}.get(scene, ())
        return run_offline(
            "lcmv", sig, engine=engine(dtype), array_cfg=aira16(interf),
            theta=THETA, params=preset("lcmv", solver=solver), device=device,
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
    y1 = outs[("noise", "auto")]
    diff = float(np.abs(y1 - y_mvdr).max())
    log(f"lcmv S=1 auto vs mvdr auto, both on the card (noise): max sample "
        f"difference {diff:.3e} (bar {LCMV_MVDR_TOL:g})")
    log(f"lcmv S=1 auto on the card vs mvdr float64 on the cpu (noise): max "
        f"sample difference {float(np.abs(y1 - y_mvdr64).max()):.3e}")
    if not diff <= LCMV_MVDR_TOL:
        raise AssertionError(f"lcmv S=1 vs mvdr {diff}")
    return outs, refs, launches


def fused_inputs(x: np.ndarray):
    """The 30 s input on the card with zero carries, and the gate of its
    analysis under the launch preset's threshold (for the bound's count
    of solved pairs)."""
    import torch
    from beamform_tpu_torch.kernels.wola import wola_analysis
    from beamform_tpu_torch.models import common
    dev = torch.device(DEVICE)
    xp = common.prepare_input(x, engine(), torch.float32, dev)
    tail = torch.zeros((xp.shape[0], HOP), device=dev)
    prev = torch.zeros(HOP, device=dev)
    _, mag, _ = wola_analysis(xp, tail, with_mag=True)
    return xp, tail, prev, mag


def fused_bytes(m: int, t: int, ctrl_elems: int, state_elems: int) -> int:
    """Bytes a fused call must move: the audio in (and its tail), the
    audio out (and the carry), the control planes, the complex state in
    and out, the per-frame indices."""
    return (4 * m * t * HOP + 4 * m * HOP + 4 * t * HOP + 8 * HOP
            + 8 * ctrl_elems + 16 * state_elems + 9 * t)


def fused_fft_flops(m: int, t: int) -> float:
    """The analysis (one complex FFT per channel pair and frame, the
    window) and the synthesis (one FFT per frame, the window)."""
    n = 2 * HOP
    return (-(-m // 2) + 1) * t * fft_flops(n) + (m + 1) * t * n


def phase_mega_kernels(x: np.ndarray) -> dict:
    """The fused MVDR/LCMV kernel against its plain version on the card,
    on the main path's operands: the 30 s noise input under the launch
    presets (678 in-band bins, 1407 frames, W = 10, zero carries); MVDR,
    and LCMV at S = 1 (its MVDR form) and S = 3 (two static interferers).
    Returns the MVDR numbers."""
    import torch
    from beamform_tpu_torch.kernels import mega_stream as kmega
    from beamform_tpu_torch.models import common, get_model
    dev = torch.device(DEVICE)
    xp, tail, prev, mag = fused_inputs(x)
    params = preset("mvdr")
    model = get_model("mvdr", engine(), aira16(), params, device=dev)
    ib, w, thr = model.ib, params["past_windows"], params["freq_mag_threshold"]
    m, t, nib = xp.shape[0], xp.shape[1] // HOP, len(ib)
    pairs = int((mag.index_select(1, ib) > thr).sum())
    hist = torch.zeros((w, m, nib), dtype=torch.complex64, device=dev)
    idx = torch.zeros(t, dtype=torch.int64, device=dev)
    d = common.weights_for_thetas(model.geom, model.freqs,
                                  torch.full((1,), THETA, device=dev),
                                  torch.float32, torch.complex64)
    lmodel = get_model("lcmv", engine(), aira16(), preset("lcmv"), device=dev)
    cases = [("MVDR", d.index_select(2, ib)[:, None].contiguous(), False,
              MEGA_REL_TOL),
             ("LCMV S=1", lcmv_constraints(lmodel, 0, 0), True, MEGA_REL_TOL),
             ("LCMV S=3", lcmv_constraints(lmodel, 2, 2), True,
              MEGA_LCMV_REL_TOL)]
    results = {}
    for label, ctrl, lcmv, bar in cases:
        def kernel():
            return kmega.mega_stream(xp, tail, prev, hist, ctrl, idx, ib,
                                     thr, lcmv=lcmv)

        def plain():
            return kmega.mega_plain(xp, tail, prev, hist, ctrl, idx, ib, thr)

        got, ref = kernel(), plain()
        f64 = kmega.mega_plain(xp.double(), tail.double(), prev.double(),
                               hist.cdouble(), ctrl.cdouble(), idx, ib, thr)
        torch.cuda.synchronize()
        hist_err = _err([got[1]], [ref[1]])[1]
        log(f"  {label}: history vs plain {hist_err:.3e} of peak, carry "
            f"{_err([got[2]], [ref[2]])[0]:.3e}")
        if not hist_err <= KERNEL_REL_TOL:
            raise AssertionError(f"mega {label} history {hist_err}")
        with SmClocks() as clk:
            ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, reps=3)
        s_cap = ctrl.shape[1]
        abs_err = check_solve_kernel(
            f"mega_stream {label} M={m} NIB={nib} T={t} W={w} (gate passes "
            f"{pairs / (t * nib):.4f} of (frame, bin) pairs)", got[0], ref[0],
            f64[0], bar, ms, plain_ms)
        log(f"  mega_stream {label}: {solve_cycles(ms, clk, pairs)}")
        del f64
        if "mega_stream" not in results:
            flops = (fused_fft_flops(m, t)
                     + solve_flops(pairs, m, t, w, nib, s_cap, refine=False,
                                   inner=s_cap if lcmv else 0))
            results["mega_stream"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                **bound(fused_bytes(m, t, ctrl.numel(), w * m * nib), flops),
                library_ms=None)
    return results


def phase_gss_kernels(x: np.ndarray) -> dict:
    """The fused GSS kernel against its plain version on the card, on the
    main path's operands: the 30 s noise input under the gss launch preset
    (678 in-band bins, 1407 frames, zero state, W <- A^H at frame 0), with
    one source slot (aira16 ships no interferers), two static interferers
    (S = 3) and the CLI's capacity with two of 15 interference slots
    active (S = 16). Returns the S = 1 numbers."""
    import torch
    from beamform_tpu_torch.kernels import gss_stream as kgss
    from beamform_tpu_torch.models import get_model
    dev = torch.device(DEVICE)
    xp, tail, prev, mag = fused_inputs(x)
    results = {}
    for interf, capacity in (((), 0), (INTERFERERS, 2), (INTERFERERS, 15)):
        model = get_model("gss", engine(), aira16(interf), preset("gss"),
                          device=dev)
        model.capacity = capacity
        p = model.params
        ib = model.ib
        m, t, nib = xp.shape[0], xp.shape[1] // HOP, len(ib)
        # the static set at the state's capacity
        (ah, _, _, bits), idx, _ = model.batch_controls(np.full((1, t),
                                                                THETA))
        idx = idx[0]
        s_cap = ah.shape[1]
        w0 = torch.zeros((nib, s_cap, m), dtype=torch.complex64, device=dev)
        reset = torch.zeros(t, dtype=torch.bool, device=dev)
        reset[0] = True
        args = (xp, tail, prev, w0, ah, idx, reset, ib)
        consts = (p.freq_mag_threshold, p.mu, p.lam)

        def kernel():
            return kgss.gss_mega(*args, 2 * HOP, *consts, act_bits=bits)

        def plain():
            return kgss.gss_mega_plain(*args, *consts, act_bits=bits)

        got, ref = kernel(), plain()
        f64 = kgss.gss_mega_plain(*(a.double() for a in args[:3]),
                                  *(a.cdouble() for a in args[3:5]),
                                  *args[5:], *consts, act_bits=bits)
        torch.cuda.synchronize()
        w_err = _err([got[1]], [ref[1]])[1]
        log(f"  S={s_cap}: W vs plain {w_err:.3e} of peak, carry "
            f"{_err([got[2]], [ref[2]])[0]:.3e}; inactive rows of W zero: "
            f"{not bool(got[1][:, 1 + len(interf):].abs().sum())}")
        if not (w_err <= GSS_REL_TOL
                and not got[1][:, 1 + len(interf):].abs().sum()):
            raise AssertionError(f"gss S={s_cap}: W err {w_err}")
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, reps=3)
        pairs = int((mag.index_select(1, ib) > p.freq_mag_threshold).sum())
        abs_err = check_solve_kernel(
            f"gss_stream M={m} NIB={nib} T={t} S={s_cap} ({len(interf)} "
            f"interferers active; gate passes {pairs / (t * nib):.4f} of "
            "(frame, bin) pairs)", got[0], ref[0], f64[0], GSS_REL_TOL, ms,
            plain_ms)
        del f64
        if "gss_stream" not in results:
            s_act = 1 + len(interf)
            flops = (fused_fft_flops(m, t)
                     + pairs * (8 * m * (3 * s_act + 2 * s_act ** 2) + 4 * m))
            results["gss_stream"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                **bound(fused_bytes(m, t, ah.numel(), w0.numel()), flops),
                library_ms=None)
    return results


FUSED_EXPECT = {k: 0 for k in ("wola_analysis", "wola_synthesis",
                               "mvdr_stream", "gj_inverse", "lcmv_stream",
                               "mega_stream", "gss_stream", "phase_mask",
                               "mpf_march", "mcra_march", "gsc_sample",
                               "gsc_xmu", "gsc_blocklms", "gsc_block")}
GSC_EXPECT = FUSED_EXPECT


def check_scene(label, y, ref, n_out, may_be_nonfinite, tol=DAS_ABS_TOL):
    """Shape, non-finite samples exactly where the float64 CPU path has
    them (none unless ``may_be_nonfinite``), and the max deviation of the
    rest within ``tol``."""
    finite = np.isfinite(ref)
    if (y.shape != (n_out,) or not np.array_equal(np.isfinite(y), finite)
            or (not may_be_nonfinite and not finite.all())):
        raise AssertionError(f"{label}: shape {y.shape} / non-finite "
                             "samples differ")
    dev = float(np.abs(y[finite] - ref[finite]).max())
    log(f"{label}: max sample deviation {dev:.3e} (bar {tol:g}, peak "
        f"{np.abs(ref[finite]).max():.3e}; non-finite samples "
        f"{int((~finite).sum())} on both)")
    if not dev <= tol:
        raise AssertionError(f"{label} deviation {dev}")
    return dev


def phase_mega(x: np.ndarray, xs: np.ndarray, mvdr_outs, mvdr_refs,
               lcmv_outs, lcmv_refs) -> dict:
    """MVDR and LCMV ``solver=mega`` through run_offline under the launch
    presets: MVDR on noise and speech, LCMV on noise (S = 1), speech, two
    static interferers (S = 3) and the event timeline; each path's launches
    counted alone (the fused kernel once, no other kernel), each output
    checked against the float64 CPU path of phase_mvdr / phase_lcmv (the
    plain stream solve in float64, which equals mega's semantics) with
    matching non-finite masks, and against the same scene's ``auto``
    output on the card. Returns (MVDR's output on noise, that path's
    launch counts)."""
    from beamform_tpu_torch import run_offline
    t = -(-x.shape[1] // HOP)
    timeline = event_timeline(t)
    runs = [("mvdr", "noise", x), ("mvdr", "speech", xs),
            ("lcmv", "noise", x), ("lcmv", "speech", xs),
            ("lcmv", "static", x), ("lcmv", "events", x)]
    y_mvdr = first = None
    for node, scene, sig in runs:
        interf = {"static": INTERFERERS, "events": EVENTS[0]}.get(scene, ())
        reset_launches()
        y = run_offline(node, sig, engine=engine(),
                        array_cfg=aira16(interf), theta=THETA,
                        params=preset(node, solver="mega"), device=DEVICE,
                        interference=timeline if scene == "events" else None)
        got = read_launches()
        log(f"{node} mega main path launches ({scene}): {got}")
        if got != dict(FUSED_EXPECT, mega_stream=1):
            raise AssertionError(f"{node} mega launches {got}")
        if y_mvdr is None:
            y_mvdr, first = y, got
        outs, refs = ((mvdr_outs, mvdr_refs) if node == "mvdr"
                      else (lcmv_outs, lcmv_refs))
        check_scene(f"{node} {scene} mega {DEVICE} float32 vs cpu float64",
                    y, refs[scene], t * HOP, scene == "speech")
        check_scene(f"{node} {scene} mega vs auto on the card", y,
                    outs[(scene, "auto")], t * HOP, scene == "speech")
    return y_mvdr, first


def phase_gss(x: np.ndarray, xs: np.ndarray) -> tuple:
    """The GSS node (``auto``: the fused kernel on the card) through
    run_offline under its launch preset, on noise (S = 1), speech, two
    static interferers (S = 3) and EVENTS' timeline (capacity 15, S = 16);
    each path's launches counted alone, each output checked against the
    float64 CPU path (the plain march) with matching non-finite masks.
    Returns (output on noise, the noise path's launch counts)."""
    from beamform_tpu_torch import run_offline
    t = -(-x.shape[1] // HOP)
    timeline = event_timeline(t)
    scenes = {"noise": x, "speech": xs, "static": x, "events": x}

    def run(sig, scene, dtype="float32", device=DEVICE, solver="auto"):
        interf = {"static": INTERFERERS, "events": EVENTS[0]}.get(scene, ())
        return run_offline(
            "gss", sig, engine=engine(dtype), array_cfg=aira16(interf),
            theta=THETA, params=preset("gss", solver=solver), device=device,
            interference=timeline if scene == "events" else None)

    outs, launches = {}, None
    for scene, sig in scenes.items():
        reset_launches()
        outs[scene] = run(sig, scene)
        got = read_launches()
        log(f"gss auto main path launches ({scene}): {got}")
        if got != dict(FUSED_EXPECT, gss_stream=1):
            raise AssertionError(f"gss launches {got}")
        launches = launches or got
    t0 = time.perf_counter()
    refs = {scene: run(sig, scene, "float64", "cpu", "scan")
            for scene, sig in scenes.items()}
    log(f"gss float64 CPU references (plain march, full 30 s, 4 scenes): "
        f"{time.perf_counter() - t0:.1f} s")
    for scene in scenes:
        check_scene(f"gss {scene} {DEVICE} float32 vs cpu float64",
                    outs[scene], refs[scene], t * HOP, scene == "speech")
    return outs["noise"], launches


def flip_stats(got, ref) -> tuple:
    """(99.9th percentile, share over FLIP_TIGHT, max) of |got - ref| /
    max |ref|, over tensors or arrays."""
    got, ref = (np.asarray(a.cpu()) if hasattr(a, "cpu") else np.asarray(a)
                for a in (got, ref))
    dev = np.abs(got - ref) / max(float(np.abs(ref).max()), 1e-12)
    return (float(np.percentile(dev, 99.9)), float(np.mean(dev > FLIP_TIGHT)),
            float(dev.max()))


def flips_ok(stats) -> bool:
    return (stats[0] < FLIP_TIGHT and stats[1] <= FLIP_FRAC
            and stats[2] < FLIP_CEIL)


def fmt_flips(stats) -> str:
    return (f"p99.9 {stats[0]:.3e}, share over {FLIP_TIGHT:g} "
            f"{stats[1]:.2e}, max {stats[2]:.3e} of peak")


def log_launch_split(fn, prefix, calls: int = 5):
    """The device time of each kernel whose name holds ``prefix`` (a
    string, or a tuple of them) in one call of ``fn``: torch.profiler over
    ``calls`` calls after one warm-up, the mean per launch it recorded (a
    profile that lost a launch shows as a count below ``calls``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    prefixes = (prefix,) if isinstance(prefix, str) else prefix
    for e in prof.key_averages():
        if (any(p in e.key for p in prefixes)
                and not e.key.startswith("aten::")):
            log(f"  launch {e.key[:70]}: "
                f"{getattr(e, 'device_time_total', 0.0) / 1e3 / e.count:.4f}"
                f" ms per launch (x{e.count} in {calls} calls, profiler)")


def serial_floor(frames: int, clk: "SmClocks") -> str:
    """A march's serial floor: ``frames`` x CHAIN_CYCLES at clocks.sm (the
    median nvidia-smi read during the timed calls)."""
    if not clk.mhz:
        return "serial floor not measured (clocks.sm not read)"
    mhz = float(np.median(clk.mhz))
    return (f"serial floor {frames * CHAIN_CYCLES / mhz / 1e3:.4f} ms "
            f"({frames} frames x {CHAIN_CYCLES} cycles at {mhz:.0f} MHz)")


def front_flops(m: int) -> float:
    """Operations of the phase masks' front end per (frame, bin): per mic
    conj(w) x (6), |x| (4) and one atan2; per pair the wrapped distance
    and its sum (4); the two means (2)."""
    return m * (10 + ATAN2_OPS) + 4 * m * (m - 1) / 2 + 2


def phase_phase_kernels(x: np.ndarray, xsrc: np.ndarray) -> dict:
    """The phase-mask, MPF and MCRA march kernels against their plain
    versions on the card, on the main paths' operands: the analysis of the
    30 s noise input (timed) and of the steered-source input (16 mics,
    1026 bins, 1407 frames) under the launch presets; the phase mask and
    the MPF kernels with one steering and with a theta timeline (two
    rows), the MPF state and the MCRA march from a zero state. Outputs and
    states are held to their plain versions under the flip contract,
    current_L and first_L exactly. Beside the timed marches it logs their
    launches by profiler, clocks.sm and each march's serial floor (frames
    x CHAIN_CYCLES). Returns the noise input's numbers."""
    import torch
    from beamform_tpu_torch.config import make_params
    from beamform_tpu_torch.kernels import phase_mask as kpm
    from beamform_tpu_torch.kernels.wola import wola_analysis
    from beamform_tpu_torch.models import common, get_model
    from beamform_tpu_torch.models.mcra import freq_smooth
    dev = torch.device(DEVICE)
    model = get_model("phase", engine(), aira16(), preset("phase"),
                      device=dev)
    pp = model.params
    mp = make_params("phasempf", preset("phasempf"))
    cp = make_params("mcra", preset("mcra"))
    results = {}

    def check(label, got, ref, ms=None, plain_ms=None):
        stats = flip_stats(got, ref)
        log(f"kernel {label}: {fmt_flips(stats)} (flip contract)"
            + ("" if ms is None else
               f"; {ms:.4f} ms vs plain torch {plain_ms:.4f} ms"))
        if not flips_ok(stats):
            raise AssertionError(f"{label}: {stats}")
        return float((got - ref).abs().max())

    def check_state(label, got, ref):
        if (int(got.current_l) != int(ref.current_l)
                or bool(got.first_l) != bool(ref.first_l)):
            raise AssertionError(f"{label}: current_L / first_L differ")
        for name, a, b in zip(got._fields, got[:-2], ref[:-2]):
            check(f"{label} state {name}", a, b)

    for scene, sig in (("noise", x), ("source", xsrc)):
        xp = common.prepare_input(sig, engine(), torch.float32, dev)
        spec, _, _ = wola_analysis(xp, torch.zeros((16, HOP), device=dev))
        t, m, nb = spec.shape
        th = np.full(t, THETA)
        th[t // 2:] = -40.0
        for steer, theta in (("one steering", THETA),
                             ("theta timeline", th)):
            uniq, w_idx = model.batch_controls(
                np.broadcast_to(theta, (1, t)))
            w_idx = w_idx[0]
            w = common.weights_for_thetas(model.geom, model.freqs, uniq,
                                          torch.float32, torch.complex64)
            u = w.shape[0]
            timed = scene == "noise" and u == 1
            pm = (spec, w, w_idx, pp.min_phase * np.pi / 180.0,
                  pp.mag_threshold, pp.mag_mult, 2 * HOP)
            st0 = kpm.init_state(kpm.MpfState, nb, torch.float32, dev)
            mpf = (spec, w, w_idx, st0, mp, True)
            label = f"M={m} NB={nb} T={t} U={u} ({scene}, {steer})"
            got, ref = kpm.phase_mask(*pm), kpm.phase_mask_plain(*pm)
            torch.cuda.synchronize()
            times = ((cuda_ms(lambda: kpm.phase_mask(*pm)),
                      cuda_ms(lambda: kpm.phase_mask_plain(*pm), reps=3))
                     if timed else ())
            err = check(f"phase_mask {label}", got, ref, *times)
            if timed:
                log_launch_split(lambda: kpm.phase_mask(*pm),
                                 "phase_mask_kernel")
                results["phase_mask"] = dict(
                    max_abs_err=err, ms=times[0], plain_ms=times[1],
                    **bound(8 * (t + u) * m * nb + 8 * t + 8 * t * nb,
                            t * nb * (front_flops(m) + 14)),
                    library_ms=None)
            (y, st), (y_ref, st_ref) = (kpm.mpf_march(*mpf),
                                        kpm.mpf_march_plain(*mpf))
            torch.cuda.synchronize()
            times = ()
            if timed:
                with SmClocks() as clk:
                    ms = cuda_ms(lambda: kpm.mpf_march(*mpf))
                times = (ms, cuda_ms(lambda: kpm.mpf_march_plain(*mpf),
                                     reps=3))
            err = check(f"mpf_march {label}", y, y_ref, *times)
            check_state(f"mpf_march {label}", st, st_ref)
            if timed:
                log_launch_split(lambda: kpm.mpf_march(*mpf),
                                 ("mpf_beams", "MpfNode"))
                # the march's share per (frame, bin): the MCRA step (20),
                # leakage, reverberation and lambda (14), the output (8)
                results["mpf_march"] = dict(
                    max_abs_err=err, ms=times[0], plain_ms=times[1],
                    **bound(8 * (t + u) * m * nb + 8 * t + 8 * t * nb
                            + 2 * 4 * 9 * nb,
                            t * nb * (front_flops(m) + 16 + 42)),
                    library_ms=None)
                log(f"  {clk.summary()}; {serial_floor(t, clk)}")
        x0 = spec[:, 0].contiguous()
        sq = x0.abs() ** 2
        s_f = freq_smooth(sq, x0[:, 0].abs())
        mst0 = kpm.init_state(kpm.McraState, nb, torch.float32, dev)
        mc = (s_f, sq, x0, mst0, cp, True)
        (y, st), (y_ref, st_ref) = (kpm.mcra_march(*mc),
                                    kpm.mcra_march_plain(*mc))
        torch.cuda.synchronize()
        timed = scene == "noise"
        times = ()
        if timed:
            with SmClocks() as clk:
                ms = cuda_ms(lambda: kpm.mcra_march(*mc))
            times = (ms, cuda_ms(lambda: kpm.mcra_march_plain(*mc), reps=3))
        label = f"mcra_march NB={nb} T={t} ({scene}, mic 0)"
        err = check(label, y, y_ref, *times)
        check_state(label, st, st_ref)
        if timed:
            log_launch_split(lambda: kpm.mcra_march(*mc), "McraNode")
            # per (frame, bin): the MCRA step (20), the output (14)
            results["mcra_march"] = dict(
                max_abs_err=err, ms=times[0], plain_ms=times[1],
                **bound(24 * t * nb + 2 * 4 * 6 * nb, 34 * t * nb),
                library_ms=None)
            log(f"  {clk.summary()}; {serial_floor(t, clk)}")
    return results


PHASE_KERNEL = {"phase": "phase_mask", "phasempf": "mpf_march",
                "mcra": "mcra_march"}


def phase_phase_node(node: str, x: np.ndarray, xsrc: np.ndarray) -> tuple:
    """A phase-mask node (``phase``, ``phasempf`` or ``mcra``) through
    run_offline under its launch preset: on the noise input with this
    path's launches counted alone (one analysis, the node's kernel, one
    synthesis, nothing else), on the steered-source input and, but for
    mcra (no steering), on the source under a theta timeline. Each output
    against the float64 CPU path: within F64_FACTOR times the JAX
    package's own float32 error or under the flip contract, whichever is
    looser (the line says which held), with the max sample deviation
    beside PERF.md's 1e-3 budget. Returns (output on noise, launches)."""
    from beamform_tpu_torch import run_offline
    t = -(-x.shape[1] // HOP)
    th = np.full(t, THETA)
    th[t // 2:] = -40.0

    def run(sig, theta=THETA, dtype="float32", device=DEVICE):
        return run_offline(node, sig, engine=engine(dtype),
                           array_cfg=aira16(), theta=theta,
                           params=preset(node), device=device)

    reset_launches()
    outs = {"noise": run(x)}
    launches = read_launches()
    log(f"{node} main path launches (noise): {launches}")
    want = dict(FUSED_EXPECT, wola_analysis=1, wola_synthesis=1,
                **{PHASE_KERNEL[node]: 1})
    if launches != want:
        raise AssertionError(f"{node} launches {launches}, expected {want}")
    scenes = {"noise": (x, THETA), "source": (xsrc, THETA)}
    if node != "mcra":
        scenes["source timeline"] = (xsrc, th)
    outs.update({s: run(sig, theta) for s, (sig, theta) in scenes.items()
                 if s != "noise"})
    t0 = time.perf_counter()
    refs = {s: run(sig, theta, "float64", "cpu")
            for s, (sig, theta) in scenes.items()}
    log(f"{node} float64 CPU references ({len(refs)} scenes, full 30 s): "
        f"{time.perf_counter() - t0:.1f} s")
    for scene, y in outs.items():
        ref = refs[scene]
        if y.shape != (t * HOP,) or not np.isfinite(y).all():
            raise AssertionError(f"{node} {scene}: shape {y.shape} / "
                                 "non-finite output")
        dev = float(np.abs(y - ref).max())
        stats = flip_stats(y, ref)
        jax_dev = JAX_F32_DEV[(node, scene.split()[0])]
        held = [name for name, ok in (
            ("flip contract", flips_ok(stats)),
            (f"{F64_FACTOR:g}x the JAX float32 error {jax_dev:.3e}",
             dev <= F64_FACTOR * jax_dev)) if ok]
        log(f"{node} {scene} {DEVICE} float32 vs cpu float64: max sample "
            f"deviation {dev:.3e} (peak {np.abs(ref).max():.3e}; budget "
            f"{DAS_ABS_TOL:g} {'met' if dev <= DAS_ABS_TOL else 'EXCEEDED'}"
            f"); {fmt_flips(stats)}; held: {', '.join(held) or 'none'}")
        if not held:
            raise AssertionError(f"{node} {scene}: deviation {dev}, {stats}")
    return outs["noise"], launches


GSC_KERNEL = {"sample": "gsc_sample", "xmu": "gsc_xmu",
              "blocklms": "gsc_blocklms", "block": "gsc_block",
              "write_mu": "gsc_sample"}


def event_ms(fn):
    """(fn(), its device time in ms by CUDA events): one call, for the
    plain per-sample loops, too slow to repeat."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def gsc_aligned(sig: np.ndarray):
    """Stage 1 of the gsc path on the card: the (16, S) phase-aligned
    streams the adaptive stage takes, at THETA from a zero carry."""
    import torch
    from beamform_tpu_torch.models import common
    model = gsc_model({})
    xp = common.prepare_input(sig, engine(), torch.float32, DEVICE)
    w_conj = common.weights_for_thetas(
        model.geom, model.freqs,
        torch.tensor([float(THETA)], dtype=torch.float32, device=DEVICE),
        torch.float32, torch.complex64).conj().resolve_conj()
    spec, _, _ = common.stft_streams_carry(
        xp[None], engine(), model.window, torch.complex64,
        torch.zeros((1, 16, HOP), device=DEVICE))
    aligned, _ = common.istft_channels_carry(
        (spec[:, 0] * w_conj).movedim(1, 0), engine(), model.window,
        torch.zeros((16, HOP), device=DEVICE))
    return aligned


def gsc_zero(b: int, dtype=None, lookahead: bool = False):
    """A zero state for B streams: block, filt, last_out, and with
    ``lookahead`` the block kernel's gram and uold too."""
    import torch
    dtype = dtype or torch.float32
    shapes = [(b, 15, 128), (b, 15, 128), (b, 128)]
    shapes += [(b, 15, 8), (b, 15, 8)] if lookahead else []
    return tuple(torch.zeros(sh, dtype=dtype, device=DEVICE)
                 for sh in shapes)


def gsc_bound(b: int, s: int, rows: int = 16,
              lookahead: bool = False) -> dict:
    """The adaptive stage's least time for B streams of S samples: the
    input rows (16 mics, or the xmu mode's 46 packed rows) read once, the
    output and the state written once (the block kernel also reads uold
    and writes gram and uold); 4 (M-1) K = 7,680 operations a sample (the
    dot product and the update, a multiply and an add per tap)."""
    state = 4 * b * (2 * 15 * 128 + 128)
    extra = 3 * 4 * b * 15 * 8 if lookahead else 0
    return bound(4 * b * rows * s + 4 * b * s + 2 * state + extra,
                 4.0 * 15 * 128 * b * s)


def mu_trace_dev(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest relative deviation of a mu trace's lines from the
    reference's, beyond the lines' 6-decimal resolution."""
    err = np.maximum(np.abs(got - ref) - 1e-6, 0.0)
    return float((err / np.maximum(np.abs(ref), 1e-12)).max())


def check_gsc_kernel(label, got, ref, ref64, ms, plain_ms) -> float:
    """Hold an adaptive-stage kernel's output to its plain float32 version
    on the same card inputs: no further from the plain version in float64
    than F64_FACTOR times the plain float32 version is. Logs the numbers;
    returns the max abs error against plain."""
    import torch
    abs_err = float((got - ref).abs().max())
    k64 = float((got.double() - ref64).abs().max())
    p64 = float((ref.double() - ref64).abs().max())
    log(f"kernel {label}: max_abs_err vs plain {abs_err:.3e} (peak "
        f"{float(ref64.abs().max()):.3e}); vs float64 kernel {k64:.3e}, "
        f"plain {p64:.3e} (bar {F64_FACTOR:g}x plain); {ms:.4f} ms vs plain "
        f"torch {plain_ms:.4f} ms")
    if not (k64 <= F64_FACTOR * p64 and torch.isfinite(got).all()):
        raise AssertionError(f"{label}: vs float64 {k64}, plain {p64}")
    return abs_err


def gsc_model(over: dict, dtype: str = "float32", device=None):
    """The GSC node under the launch preset without write_mu, with
    ``over`` on top, on ``device`` (default DEVICE)."""
    from beamform_tpu_torch.models import get_model
    return get_model("gsc", engine(dtype), aira16(),
                     preset("gsc", **dict(dict(write_mu=False), **over)),
                     device=device or DEVICE)


def gsc_reference(inp: str, path: str) -> tuple:
    """A float64 CPU reference of the gsc phase, run in a worker process
    beside the card's phases: ``"per-sample"`` the per-sample recurrence
    (write_mu on) over the first GSC_REF_HOPS hops of the input, or
    ``"blocklms<l>"`` block LMS at l over all of it. Returns (output, the
    mu trace's lines or None)."""
    import torch
    torch.set_num_threads(2)
    sig = {"noise": make_input, "speech": make_speech_input}[inp](16,
                                                                  SECONDS)
    if path == "per-sample":
        sig, over = sig[:, :GSC_REF_HOPS * HOP], {"write_mu": True}
    else:
        over = {"solver": "blocklms", "block_samples": int(path[8:])}
    model = gsc_model(over, "float64", "cpu")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        model.mu_file_path = os.path.join(tmp, "mu.txt")
        y = model.process(sig, THETA).numpy()
        trace = np.loadtxt(model.mu_file_path) if over.get("write_mu") \
            else None
    return y, trace


def gsc_plain64(a: np.ndarray, over: dict) -> np.ndarray:
    """The per-sample recurrence's plain version in float64 on the CPU from
    a zero state, on (B, 16, S) aligned streams from the card: the
    gsc_kernels phase's reference, run in a worker process."""
    import torch
    from beamform_tpu_torch.config import make_params
    from beamform_tpu_torch.kernels import gsc as kg
    torch.set_num_threads(2)
    at = torch.as_tensor(a, dtype=torch.float64)
    z = torch.zeros((at.shape[0], 15, 128), dtype=torch.float64)
    return kg.gsc_sample_plain(at, z, z.clone(), z[:, 0].clone(),
                               make_params("gsc", preset("gsc", **over)))[0]\
        .numpy()


def phase_gsc_kernels(x: np.ndarray, xs: np.ndarray, card: str,
                      pool) -> dict:
    """The GSC kernels against their plain versions on the card, on the
    main path's operands: the aligned streams of the noise and speech
    inputs (M = 16, K = 128), two streams of GSC_CHECK_HOPS hops from a
    zero state, VAD off and on (its threshold GSC_VAD gates part of the
    samples); the per-sample kernel with its mu trace and the xmu mode,
    block LMS at l = 128 and 512, and the lookahead-8 kernel over the
    first GSC_BLOCK_CHECK_HOPS hops (its plain version in float64 on the
    card as the third point; its deviation from
    the per-sample kernel's output, the same function up to round-off and
    the NaN scrub's timing, logged). The per-sample recurrence's float64
    reference runs on the CPU in ``pool`` meanwhile. Then each kernel's
    time by CUDA events at the main shape (one stream, 30 s; block LMS also
    at l = 512, and the lookahead-8 kernel's time against the per-sample
    kernel's), and the per-sample, block-LMS and lookahead-8 kernels'
    aggregate rate at bench.py's batch of 32 streams over 10 s. Returns the
    main shape's numbers per kernel."""
    import torch
    from beamform_tpu_torch.config import make_params
    from beamform_tpu_torch.kernels import gsc as kg
    from beamform_tpu_torch.kernels import gsc_block as kbk
    from beamform_tpu_torch.kernels import gsc_blocklms as kb
    full = {"noise": gsc_aligned(x), "speech": gsc_aligned(xs)}
    n = GSC_CHECK_HOPS * HOP
    a2 = torch.stack([full["noise"][:, :n], full["speech"][:, :n]])
    a2 = a2.contiguous()
    overs = {v: dict(write_mu=False, use_vad=v, vad_threshold=GSC_VAD)
             for v in (False, True)}
    refs64 = {v: pool.apply_async(gsc_plain64, (a2.cpu().numpy(), over))
              for v, over in overs.items()}
    errs, plain_ms, sample_out = {}, {}, {}
    for use_vad, over in overs.items():
        p = make_params("gsc", preset("gsc", **over))
        ref, p_ms = event_ms(lambda: kg.gsc_sample_plain(
            a2, *gsc_zero(2), p, with_mu=True))
        ref64 = [torch.as_tensor(refs64[use_vad].get(), device=a2.device)]
        share = float(ref[4][1].float().mean())
        for name, fn in (("gsc_sample", kg.gsc_sample),
                         ("gsc_xmu", kg.gsc_xmu)):
            got, ms = event_ms(lambda: fn(a2, *gsc_zero(2), p, with_mu=True))
            err = check_gsc_kernel(
                f"{name} B=2 M=16 S={n} vad={use_vad} (updates in "
                f"{share:.3f} of samples)", got[0], ref[0], ref64[0], ms,
                p_ms)
            log(f"  {name} B=2 S={n} vad={use_vad}: "
                f"{gsc_group_counts(lambda: fn(a2, *gsc_zero(2), p))}")
            mu, mu_ref = got[4][0], ref[4][0]
            off = float(((mu - mu_ref).abs()
                         > 1e-3 * mu_ref.abs()).float().mean())
            flips = float((got[4][1] != ref[4][1]).float().mean())
            log(f"  mu trace vs plain: share off by more than 1e-3 "
                f"relative {off:.2e}, update flags differing {flips:.2e}")
            if not (off <= 1e-3 and flips <= 1e-3):
                raise AssertionError(f"{name} trace: {off}, {flips}")
            errs[name] = max(errs.get(name, 0.0), err)
            plain_ms[name] = p_ms
            if name == "gsc_sample":
                sample_out[use_vad] = got[0]
        for l in (128, 512):
            pl = make_params("gsc", preset("gsc", solver="blocklms",
                                           block_samples=l, **over))
            ref, p_ms = event_ms(lambda: kb.gsc_blocklms_plain(
                a2, *gsc_zero(2), pl))
            ref64 = kb.gsc_blocklms_plain(a2.double(),
                                          *gsc_zero(2, torch.float64), pl)
            got, ms = event_ms(lambda: kb.gsc_blocklms(a2, *gsc_zero(2), pl))
            err = check_gsc_kernel(f"gsc_blocklms l={l} B=2 M=16 S={n} "
                                   f"vad={use_vad}", got[0], ref[0],
                                   ref64[0], ms, p_ms)
            errs["gsc_blocklms"] = max(errs.get("gsc_blocklms", 0.0), err)
            if l == 128:
                plain_ms["gsc_blocklms"] = p_ms
        pb = make_params("gsc", preset("gsc", solver="block", **over))
        nb = GSC_BLOCK_CHECK_HOPS * HOP
        ab = a2[..., :nb].contiguous()
        ref, p_ms = event_ms(lambda: kbk.gsc_block_plain(
            ab, *gsc_zero(2, lookahead=True), pb))
        ref64, p64_ms = event_ms(lambda: kbk.gsc_block_plain(
            ab.double(), *gsc_zero(2, torch.float64, True), pb))
        got, ms = event_ms(lambda: kbk.gsc_block(
            ab, *gsc_zero(2, lookahead=True), pb))
        err = check_gsc_kernel(f"gsc_block B=2 M=16 S={nb} vad={use_vad}",
                               got[0], ref[0], ref64[0], ms, p_ms)
        errs["gsc_block"] = max(errs.get("gsc_block", 0.0), err)
        plain_ms["gsc_block"] = p_ms
        vs_sample = float((got[0] - sample_out[use_vad][:, :nb]).abs().max())
        log(f"  gsc_block vs gsc_sample on the same operands: max abs "
            f"{vs_sample:.3e}; the plain block version in float64 took "
            f"{p64_ms:.1f} ms")
        del ref64

    # the main shape: one stream of 30 s, zero state, the launch preset
    p = make_params("gsc", preset("gsc", write_mu=False))
    pl = make_params("gsc", preset("gsc", write_mu=False, solver="blocklms"))
    pb = make_params("gsc", preset("gsc", write_mu=False, solver="block"))
    a1 = full["noise"][None].contiguous()
    s = a1.shape[-1]
    calls = (("gsc_sample", lambda: kg.gsc_sample(a1, *gsc_zero(1), p)),
             ("gsc_xmu", lambda: kg.gsc_xmu(a1, *gsc_zero(1), p)),
             ("gsc_blocklms", lambda: kb.gsc_blocklms(a1, *gsc_zero(1), pl)),
             ("gsc_block", lambda: kbk.gsc_block(
                 a1, *gsc_zero(1, lookahead=True), pb)))
    results = {}
    for name, fn in calls:
        with SmClocks() as clk:
            ms = cuda_ms(fn, reps=3)
        hops = GSC_BLOCK_CHECK_HOPS if name == "gsc_block" else GSC_CHECK_HOPS
        log(f"  clocks during {name}'s calls: {clk.summary()}")
        log(f"kernel {name} B=1 M=16 S={s} (30 s, noise): {ms:.4f} ms, "
            f"{ms * 1e6 / s:.1f} ns per sample of the chain, "
            f"{chain_cycles(ms, clk, s)}, "
            f"{SECONDS / ms * 1e3:.1f}x real time on {card}; plain torch "
            f"{plain_ms[name]:.4f} ms over B=2, {hops} hops")
        if name in ("gsc_sample", "gsc_xmu"):
            log(f"  {name} B=1 (30 s): {gsc_group_counts(fn)}")
        results[name] = dict(max_abs_err=errs[name], ms=ms,
                             plain_ms=plain_ms[name],
                             **gsc_bound(1, s, 46 if name == "gsc_xmu"
                                         else 16, name == "gsc_block"),
                             library_ms=None)
    log(f"  gsc_block / gsc_sample at B=1 (30 s): "
        f"{results['gsc_block']['ms'] / results['gsc_sample']['ms']:.3f}")
    pl512 = make_params("gsc", preset("gsc", write_mu=False,
                                      solver="blocklms", block_samples=512))
    with SmClocks() as clk:
        ms = cuda_ms(lambda: kb.gsc_blocklms(a1, *gsc_zero(1), pl512), reps=3)
    log(f"  clocks during gsc_blocklms l=512's calls: {clk.summary()}")
    log(f"kernel gsc_blocklms l=512 B=1 M=16 S={s} (30 s, noise): {ms:.4f} "
        f"ms, {ms * 1e6 / s:.1f} ns per sample, {SECONDS / ms * 1e3:.1f}x "
        f"real time on {card}")
    # the per-sample kernel with the VAD gate at GSC_VAD, and with the
    # write_mu trace
    pv = make_params("gsc", preset("gsc", write_mu=False, use_vad=True,
                                   vad_threshold=GSC_VAD))
    for label, fn in (
            (f"vad={GSC_VAD}", lambda: kg.gsc_sample(a1, *gsc_zero(1), pv)),
            ("with the mu trace", lambda: kg.gsc_sample(a1, *gsc_zero(1), p,
                                                        with_mu=True))):
        ms = cuda_ms(fn, reps=3)
        log(f"kernel gsc_sample B=1 M=16 S={s} {label}: {ms:.4f} ms, "
            f"{ms * 1e6 / s:.1f} ns per sample on {card}")
    # the xmu mode's packing outside the kernel, apart
    pk_ms = cuda_ms(lambda: kg.xmu_inputs(a1, gsc_zero(1)[0], p), reps=3)
    log(f"  xmu_inputs (plain torch, outside the kernel): {pk_ms:.4f} ms")

    # bench.py's gsc_batch32 shape: 32 streams of 10 s
    n10 = int(10 * FS) // HOP * HOP
    a32 = torch.stack([full["noise" if i % 2 else "speech"][
        :, 1000 * i:1000 * i + n10] for i in range(32)]).contiguous()
    batch32 = (("gsc_sample", lambda: kg.gsc_sample(a32, *gsc_zero(32), p)),
               ("gsc_blocklms", lambda: kb.gsc_blocklms(a32, *gsc_zero(32),
                                                        pl)),
               ("gsc_block", lambda: kbk.gsc_block(
                   a32, *gsc_zero(32, lookahead=True), pb)))
    cs, cpc = kb.cluster_plan(16)
    sms = torch.cuda.get_device_properties(a32.device).multi_processor_count
    for name, fn in batch32:
        with SmClocks() as clk:
            ms = cuda_ms(fn, reps=3)
        grid = (f"; {32 * cs} CTAs of {kb.smem_bytes(128, cpc)} B shared "
                f"memory in clusters of {cs} on {sms} SMs"
                if name == "gsc_blocklms" else "")
        log(f"kernel {name} B=32 M=16 S={n10} (10 s each): {ms:.4f} ms, "
            f"aggregate {32 * n10 / FS / ms * 1e3:.1f} audio-s per s, "
            f"{ms * 1e6 / n10:.1f} ns per sample of each chain, "
            f"{chain_cycles(ms, clk, n10)} on {card}{grid}")
        if name == "gsc_sample":
            log(f"  gsc_sample B=32 (10 s): {gsc_group_counts(fn)}")
    return results


def phase_gsc(x: np.ndarray, xs: np.ndarray, tmp: str, refs: dict) -> tuple:
    """The GSC node through run_offline under the launch preset without
    write_mu (bench.py's LAUNCH["gsc"]), for ``sample``, ``xmu``,
    ``blocklms`` at l = 128 and 512, ``block``, and with write_mu on (its
    trace under ``tmp``), on noise and speech; each path's launches
    counted alone (one analysis, one synthesis over the 16 mics, one
    adaptive-stage kernel).
    Against the float64 CPU path (``refs``: {(input, path): the pending
    gsc_reference}): the per-sample paths (``block`` is the same
    function) over their first GSC_REF_HOPS hops (one float64 run per
    input serves the four, the trace too), block LMS over the full 30 s.
    Returns ({(input, path): output}, {path: its launch counts})."""
    t = -(-x.shape[1] // HOP)
    paths = {"sample": {}, "xmu": {"solver": "xmu"},
             "blocklms128": {"solver": "blocklms"},
             "blocklms512": {"solver": "blocklms", "block_samples": 512},
             "block": {"solver": "block"}, "write_mu": {"write_mu": True}}
    outs, launches, traces = {}, {}, {}
    for inp, sig in (("noise", x), ("speech", xs)):
        traces[inp] = os.path.join(tmp, f"mu_{inp}.txt")
        for path, over in paths.items():
            mdl = gsc_model(over)
            mdl.mu_file_path = traces[inp]
            reset_launches()
            outs[(inp, path)] = mdl.process(sig, THETA).cpu().numpy()
            got = read_launches()
            want = dict(GSC_EXPECT, wola_analysis=1, wola_synthesis=1,
                        **{GSC_KERNEL[path.rstrip("0123456789")]: 1})
            log(f"gsc {path} main path launches ({inp}): {got}")
            if got != want:
                raise AssertionError(f"gsc {path} launches {got}, expected "
                                     f"{want}")
            launches.setdefault(path, got)
    t0 = time.perf_counter()
    refs = {key: job.get() for key, job in refs.items()}
    log(f"gsc float64 CPU references (the per-sample recurrence over "
        f"{GSC_REF_HOPS} hops, block LMS over 30 s; 2 inputs; worker "
        f"processes since the kernel checks): waited "
        f"{time.perf_counter() - t0:.1f} s for them")
    for (inp, path), y in outs.items():
        if y.shape != (t * HOP,) or not np.isfinite(y).all():
            raise AssertionError(f"gsc {inp} {path}: shape {y.shape} / "
                                 "non-finite output")
        blocks = path.startswith("blocklms")
        ref = refs[(inp, path if blocks else "per-sample")][0]
        dev = float(np.abs(y[:len(ref)] - ref).max())
        jax_dev = JAX_F32_DEV[("gsc " + (path if blocks else "sample"), inp)]
        bar = max(DAS_ABS_TOL, F64_FACTOR * jax_dev)
        log(f"gsc {inp} {path} {DEVICE} float32 vs cpu float64 "
            f"({'30 s' if blocks else f'first {GSC_REF_HOPS} hops'}): max "
            f"sample deviation {dev:.3e} (bar {bar:g}: the larger of "
            f"{DAS_ABS_TOL:g} and {F64_FACTOR:g}x the JAX float32 error "
            f"{jax_dev:.3e}; peak {np.abs(ref).max():.3e})")
        if not dev <= bar:
            raise AssertionError(f"gsc {inp} {path} deviation {dev}")
    for inp in ("noise", "speech"):
        got = np.loadtxt(traces[inp])
        ref = refs[(inp, "per-sample")][1]
        dev = mu_trace_dev(got[:len(ref)], ref)
        abs_dev = float(np.abs(got[:len(ref)] - ref).max())
        jax_dev = JAX_F32_DEV[("gsc mu trace", inp)]
        bar = max(MU_TRACE_TOL, F64_FACTOR * jax_dev)
        log(f"gsc {inp} mu trace: {len(got)} lines on the card; first "
            f"{len(ref)} vs float64 CPU: max relative deviation {dev:.3e} "
            f"beyond the 1e-6 resolution (bar {bar:.3e}: the larger of "
            f"{MU_TRACE_TOL:g} and {F64_FACTOR:g}x the JAX float32 error "
            f"{jax_dev:.3e}; max abs {abs_dev:.3e}, peak "
            f"{float(np.abs(ref).max()):.3e})")
        if len(got) != t or not dev <= bar:
            raise AssertionError(f"gsc {inp} mu trace: {len(got)} lines, "
                                 f"relative deviation {dev}")
    return outs, launches


# read's picks may differ from float64 only where the float64 energies of
# the two mics are this close (relative): below float32's resolution of a
# sum of 1024 terms
READ_TIE_REL = 1e-6


def read_picks(wins: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The mic each window of read's output (T * hop,) passes through,
    found by exact equality with the input windows (M, T, hop); raises
    where a window is no mic's input."""
    t = wins.shape[1]
    eq = (wins == y.reshape(t, -1)[None]).all(axis=-1)       # (M, T)
    if not eq.any(axis=0).all():
        raise AssertionError(f"read: {int((~eq.any(axis=0)).sum())} "
                             "output windows are no mic's input")
    return eq.argmax(axis=0)


def phase_refread(node: str, x: np.ndarray):
    """The ``ref`` or ``read`` node through run_offline on the card (no
    kernel of the port: every count stays 0) against the float64 CPU
    path. ``ref`` within DAS_ABS_TOL; ``read`` pick by pick: each output
    window is exactly its pick's input, and a pick differs from float64
    only where the two mics' float64 energies are within READ_TIE_REL.
    Returns (output, launch counts)."""
    from beamform_tpu_torch import run_offline
    cfg = aira16()
    reset_launches()
    y = run_offline(node, x, engine=engine(), array_cfg=cfg, theta=THETA,
                    device=DEVICE)
    launches = read_launches()
    log(f"{node} main path launches: {launches}")
    if launches != FUSED_EXPECT:
        raise AssertionError(f"{node} launched a kernel: {launches}")
    n_out = -(-x.shape[1] // HOP) * HOP
    if y.shape != (n_out,) or not np.isfinite(y).all():
        raise AssertionError(f"{node} output shape {y.shape} / non-finite")
    ref = run_offline(node, x, engine=engine("float64"), array_cfg=cfg,
                      theta=THETA, device="cpu")
    dev = float(np.abs(y - ref).max())
    if node == "ref":
        log(f"ref {DEVICE} float32 vs cpu float64: max sample deviation "
            f"{dev:.3e} (bar {DAS_ABS_TOL:g}, peak {np.abs(ref).max():.3e})")
        if not dev <= DAS_ABS_TOL:
            raise AssertionError(f"ref deviation {dev}")
        return y, launches
    xp = np.pad(x, ((0, 0), (0, n_out - x.shape[1])))
    wins = xp.reshape(x.shape[0], n_out // HOP, HOP)
    p32 = read_picks(wins, y)
    p64 = read_picks(wins.astype(np.float64), ref)
    e64 = np.abs(wins.astype(np.float64) * 100.0).sum(axis=-1)   # (M, T)
    cols = np.arange(wins.shape[1])
    flips = np.nonzero(p32 != p64)[0]
    rel = (np.abs(e64[p32, cols] - e64[p64, cols])
           / np.maximum(e64[p64, cols], 1e-300))[flips]
    log(f"read {DEVICE} float32 vs cpu float64: {len(flips)} of {len(cols)} "
        f"picks differ (float64 energies within "
        f"{float(rel.max()) if len(rel) else 0.0:.3e} relative at them, "
        f"bar {READ_TIE_REL:g}); max sample deviation {dev:.3e}; every "
        "output window is exactly its pick's input")
    if len(rel) and not rel.max() <= READ_TIE_REL:
        raise AssertionError(f"read flips a pick off a near-tie: {rel}")
    if not (y[np.repeat(p32 == p64, HOP)]
            == ref[np.repeat(p32 == p64, HOP)]).all():
        raise AssertionError("read output differs where the picks agree")
    return y, launches


def phase_das_vs_ref(xsrc: np.ndarray):
    """The flow of the evaluation: DAS steered at the source against the
    ``ref`` node's sample-aligned mic 0, on the card (the steered source
    input); off the source (-60 deg) for contrast."""
    from beamform_tpu_torch import run_offline
    cfg = aira16()
    y_ref = run_offline("ref", xsrc, engine=engine(), array_cfg=cfg,
                        device=DEVICE)
    corr = {}
    for th in (THETA, -60.0):
        y = run_offline("das", xsrc, engine=engine(), array_cfg=cfg,
                        theta=th, device=DEVICE)
        corr[th] = float(np.corrcoef(y, y_ref)[0, 1])
    log(f"das at the source ({THETA:g} deg) vs ref: correlation "
        f"{corr[THETA]:.6f} (bar 0.95); at -60 deg {corr[-60.0]:.6f}")
    if not corr[THETA] >= 0.95:
        raise AssertionError(f"das vs ref correlation {corr}")


# ------------------------------------------------------------ batched serving

# bench.py's bench_batched: B streams of 10 s of 0.1 N(0, 1) from seed 2 at
# thetas linspace(-60, 60, B), through the runner in 2 s chunks (93 hops)
BATCH_SECONDS = 10.0
BATCH_SEED = 2
BATCH_CHUNK = 2 * FS // HOP * HOP
# each stream of a batched path against the same model's single-stream run
# on the card: bit for bit, or, where the fused kernels' overlap-add adds
# with atomics (the first hop's three addends in another order) or
# ``dense``'s einsums sum the B streams' blocks in another order, within
# this of the stream's peak
BATCH_PEAK_TOL = 1e-6
# (label, node, preset overrides, static interferers, streams, bit for bit,
# the kernels one chunk launches: each as often as one stream's call of the
# chunk launches it)
BATCH, GSC_BATCH = 8, 32
BATCH_PATHS = (
    ("das", "das", None, (), BATCH, True, ("wola_analysis",
                                           "wola_synthesis")),
    ("mvdr auto", "mvdr", {}, (), BATCH, True,
     ("wola_analysis", "wola_synthesis", "mvdr_stream")),
    ("mvdr mega", "mvdr", {"solver": "mega"}, (), BATCH, False,
     ("mega_stream",)),
    ("lcmv auto S=1", "lcmv", {}, (), BATCH, True,
     ("wola_analysis", "wola_synthesis", "lcmv_stream")),
    ("lcmv auto S=3", "lcmv", {}, INTERFERERS, BATCH, True,
     ("wola_analysis", "wola_synthesis", "lcmv_stream")),
    ("lcmv mega S=1", "lcmv", {"solver": "mega"}, (), BATCH, False,
     ("mega_stream",)),
    ("lcmv mega S=3", "lcmv", {"solver": "mega"}, INTERFERERS, BATCH, False,
     ("mega_stream",)),
    ("gss S=1", "gss", {}, (), BATCH, False, ("gss_stream",)),
    ("gsc sample", "gsc", {"write_mu": False}, (), GSC_BATCH, True,
     ("wola_analysis", "wola_synthesis", "gsc_sample")),
    ("gsc blocklms", "gsc", {"write_mu": False, "solver": "blocklms"}, (),
     GSC_BATCH, True, ("wola_analysis", "wola_synthesis", "gsc_blocklms")),
    ("phase", "phase", {}, (), BATCH, True,
     ("wola_analysis", "wola_synthesis", "phase_mask")),
    ("phasempf", "phasempf", {}, (), BATCH, True,
     ("wola_analysis", "wola_synthesis", "mpf_march")),
    ("mcra", "mcra", {}, (), BATCH, True,
     ("wola_analysis", "wola_synthesis", "mcra_march")),
    ("ref", "ref", None, (), BATCH, True, ()),
    ("read", "read", None, (), BATCH, True, ()),
    ("mvdr dense", "mvdr", {"solver": "dense"}, (), BATCH, False,
     ("wola_analysis", "wola_synthesis", "gj_inverse")),
    ("lcmv dense S=3", "lcmv", {"solver": "dense"}, INTERFERERS, BATCH,
     False, ("wola_analysis", "wola_synthesis", "gj_inverse")))
# the batched paths held to float64 under the flip contract where their
# deviation passes DAS_ABS_TOL (the binary masks; PHASE_KERNEL's nodes)
FLIP_NODES = ("phase", "phasempf")


def make_batch_input(b: int) -> np.ndarray:
    """(B, 16, S) float32: bench_batched's streams, S the whole hops of
    BATCH_SECONDS; stream 0 is the same for every B."""
    rng = np.random.default_rng(BATCH_SEED)
    s = int(BATCH_SECONDS * FS) // HOP * HOP
    return 0.1 * rng.standard_normal((b, 16, s), dtype=np.float32)


def checked_stream(b: int, interf) -> int:
    """The stream a batched path holds to float64: stream 0, or where it
    looks where a static interferer is (stream 0's -60 deg is one of
    INTERFERERS: LCMV's constraint set is singular there and its output
    NaN, in every package), the first stream that does not."""
    return next(i for i, th in enumerate(np.linspace(-60.0, 60.0, b))
                if th not in interf)


def batch_reference(node: str, over, interf, b: int, hops: int):
    """The float64 CPU path on the first ``hops`` hops of the first chunk
    of :func:`checked_stream`, run in a worker process beside the card's
    phases."""
    import torch
    from beamform_tpu_torch.models import get_model
    torch.set_num_threads(2)
    k = checked_stream(b, interf)
    xk = make_batch_input(k + 1)[k, :, :hops * HOP]
    params = None if over is None else preset(node, **over)
    model = get_model(node, engine("float64"), aira16(interf), params,
                      device="cpu")
    return model.process(xk, np.linspace(-60.0, 60.0, b)[k]).numpy()


def batch_refs(pool) -> dict:
    """The pending float64 references of every batched path: the first
    chunk, GSC's per-sample recurrence (a serial float64 loop) over its
    first GSC_CHECK_HOPS hops."""
    refs = {}
    for label, node, over, interf, b, *_ in BATCH_PATHS:
        hops = (GSC_CHECK_HOPS if label == "gsc sample"
                else BATCH_CHUNK // HOP)
        refs[label] = pool.apply_async(batch_reference,
                                       (node, over, interf, b, hops))
    return refs


def same(a: np.ndarray, b: np.ndarray, exact: bool) -> str:
    """'' when ``a`` equals ``b`` (NaN where it has NaN) bit for bit, or
    within BATCH_PEAK_TOL of b's finite peak; else what differs."""
    if np.array_equal(a, b, equal_nan=True):
        return ""
    if exact:
        return f"differs (max {np.nanmax(np.abs(a - b)):.3e})"
    fin = np.isfinite(b)
    if not np.array_equal(np.isfinite(a), fin):
        return "non-finite samples differ"
    if not fin.any():
        return ""
    rel = peak_rel(a, b)
    return "" if rel <= BATCH_PEAK_TOL else f"{rel:.3e} of peak"


def peak_rel(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| over b's finite samples, over their peak."""
    fin = np.isfinite(b)
    if not fin.any():
        return 0.0
    return float(np.abs(a[fin] - b[fin]).max() / np.abs(b[fin]).max())


def check_batch_reference(label, node, y, ref):
    """A batched stream's first chunk against the float64 CPU path:
    within DAS_ABS_TOL, or for the binary masks (FLIP_NODES) under the
    flip contract where that bar fails (check_scene's checks
    otherwise)."""
    may_be_nonfinite = node in ("mvdr", "lcmv")
    if node in FLIP_NODES:
        dev = float(np.abs(y - ref).max())
        if dev > DAS_ABS_TOL:
            stats = flip_stats(y, ref)
            log(f"{label}: max sample deviation {dev:.3e} over "
                f"{DAS_ABS_TOL:g}; {fmt_flips(stats)}")
            if y.shape != ref.shape or not flips_ok(stats):
                raise AssertionError(f"{label}: {dev}, {stats}")
            return
    check_scene(label, y, ref, len(ref), may_be_nonfinite)


def phase_batch(card: str, refs: dict):
    """Batched multi-stream serving through BatchRunner on the card, as
    bench.py's bench_batched shapes it: for each of BATCH_PATHS, 8 streams
    (GSC 32) of 10 s in 2 s chunks. Checks: each chunk launches each
    kernel exactly as often as stream 0's single-stream call of the same
    chunk does (once for the kernels of the path, ``dense``'s Gauss-Jordan
    inverse once a block, none for ``ref`` and ``read``), and those are
    the path's declared kernels; each stream equals the same model's
    single-stream streaming run on the card over the same chunks (bit for
    bit; the fused kernels and ``dense`` within BATCH_PEAK_TOL of the
    stream's peak, the log saying which held); stream 0's first chunk
    (:func:`checked_stream`) within DAS_ABS_TOL of the float64 CPU path
    (the masks: or under the flip contract).
    Logs each path's peak device memory over its chunks, the aggregate
    audio-seconds per second of a batched chunk against B single-stream
    calls (CUDA events, median of 10 after 3 warm-ups; GSC of 3 after 1),
    then times rows 3-8 and the MCRA march at B = 8: one batched launch
    against 8 single-stream launches."""
    import torch
    from beamform_tpu_torch.models import get_model
    from beamform_tpu_torch.runtime.batch import BatchRunner
    from beamform_tpu_torch.runtime.streaming import StreamingSession
    inputs = {}
    for label, node, over, interf, b, exact, kernels in BATCH_PATHS:
        if b not in inputs:
            inputs[b] = torch.as_tensor(make_batch_input(b), device=DEVICE)
        xd = inputs[b]
        n = xd.shape[-1] // BATCH_CHUNK
        chunks = [xd[..., i * BATCH_CHUNK:(i + 1) * BATCH_CHUNK].contiguous()
                  for i in range(n)]
        thetas = np.linspace(-60.0, 60.0, b)
        params = None if over is None else preset(node, **over)
        cfg = aira16(interf)
        runner = BatchRunner(node, engine(), cfg, params, batch=b,
                             device=DEVICE)
        outs, ran = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for c in chunks:
            reset_launches()
            outs.append(runner.process(c, thetas))
            ran.append(read_launches())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        y = torch.cat(outs, dim=1).cpu().numpy()
        # each stream against its single-stream streaming run; stream 0's
        # launches a chunk are what a batched chunk must launch
        model = get_model(node, engine(), cfg, params, device=DEVICE)
        rels = []
        for i in range(b):
            sess = StreamingSession(model)
            parts = []
            for j, c in enumerate(chunks):
                reset_launches()
                parts.append(sess.process(c[i], float(thetas[i])))
                if i == 0 and read_launches() != ran[j]:
                    raise AssertionError(
                        f"batch {label}: chunk {j}'s launches {ran[j]}, one "
                        f"stream's call of it {read_launches()}")
            one = torch.cat(parts).cpu().numpy()
            why = same(y[i], one, exact)
            if why:
                raise AssertionError(f"batch {label}: stream {i} vs its "
                                     f"single-stream run: {why}")
            rels.append(0.0 if np.array_equal(y[i], one, equal_nan=True)
                        else peak_rel(y[i], one))
        counts = {k: v for k, v in ran[0].items() if v}
        if set(counts) != set(kernels):
            raise AssertionError(f"batch {label}: a chunk launches {counts}, "
                                 f"the path's kernels are {kernels}")
        ref = refs[label].get()[:y.shape[1]]
        k = checked_stream(b, interf)
        check_batch_reference(f"batch {label} stream {k}, first "
                              f"{len(ref) // HOP} hops vs float64 CPU", node,
                              y[k, :len(ref)], ref)
        # aggregate throughput: one batched chunk against B single calls
        # (cuda_ms adds the last warm-up)
        reps, warm = (3, 1) if node == "gsc" else (10, 3)
        timer = BatchRunner(node, engine(), cfg, params, batch=b,
                            device=DEVICE)
        sessions = [StreamingSession(model) for _ in range(b)]

        def singles():
            for i, s in enumerate(sessions):
                s.process(chunks[0][i], float(thetas[i]))

        for _ in range(warm - 1):
            timer.process(chunks[0], thetas)
            singles()
        t_b = cuda_ms(lambda: timer.process(chunks[0], thetas), reps)
        t_s = cuda_ms(singles, reps)
        audio = b * BATCH_CHUNK / FS
        match = ("bit for bit" if not any(rels) else
                 f"within {max(rels):.3e} of its peak (bar "
                 f"{BATCH_PEAK_TOL:g}; {sum(r == 0 for r in rels)} of {b} "
                 "bit for bit)")
        launched = (", ".join(f"{k} x{v}" for k, v in counts.items())
                    or "no counted kernel")
        log(f"batch {label}, {b} streams, 2 s chunks: "
            f"{1e3 * audio / t_b:.1f} audio-s/s batched ({t_b:.3f} ms a "
            f"chunk) vs {1e3 * audio / t_s:.1f} as {b} single-stream calls "
            f"({t_s:.3f} ms), x{t_s / t_b:.2f} (CUDA events, median of "
            f"{reps}); a chunk launches {launched}, as one stream's call; "
            f"each stream {match} of its single-stream run; peak device "
            f"memory over its chunks {peak / 2**20:.1f} MiB, "
            f"{(peak - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} "
            f"MiB allocated before them (max_memory_allocated); on {card}")
    batch_kernel_times(inputs[BATCH], card)


def batch_kernel_times(xd, card: str):
    """Rows 3-8 and the MCRA march at B = 8 on the first chunk's operands
    (zero state, the presets, thetas linspace(-60, 60, 8); LCMV with
    INTERFERERS, S = 3; the MCRA march on mic 0's analysis of the 8
    streams): one batched launch against 8 single-stream launches, each
    through its wrapper (cuda_ms), the single streams' operands made
    contiguous beforehand. Logs the marches' registers, shared memory,
    spills and resident blocks an SM as the card compiled them."""
    import torch
    from beamform_tpu_torch.config import make_params
    from beamform_tpu_torch.kernels import gss_stream as kgss
    from beamform_tpu_torch.kernels import lcmv_stream as kl
    from beamform_tpu_torch.kernels import mega_stream as kmega
    from beamform_tpu_torch.kernels import mvdr_stream as km
    from beamform_tpu_torch.kernels import phase_mask as kpm
    from beamform_tpu_torch.models import common, get_model
    from beamform_tpu_torch.models.mcra import freq_smooth
    b = xd.shape[0]
    x = xd[..., :BATCH_CHUNK].contiguous()
    t = BATCH_CHUNK // HOP
    th = np.repeat(np.linspace(-60.0, 60.0, b)[:, None], t, axis=1)
    mv = get_model("mvdr", engine(), aira16(), preset("mvdr"), device=DEVICE)
    lc = get_model("lcmv", engine(), aira16(INTERFERERS), preset("lcmv"),
                   device=DEVICE)
    gs = get_model("gss", engine(), aira16(), preset("gss"), device=DEVICE)
    m, w, ib = 16, mv.params.past_windows, mv.ib
    tail = torch.zeros((b, m, HOP), device=DEVICE)
    prev = torch.zeros((b, HOP), device=DEVICE)
    spec, mag, _ = common.stft_streams_carry(x, mv.engine, mv.window,
                                             mv.cdtype, tail, with_mag=True)
    gate = (mag.index_select(2, ib) > mv.params.freq_mag_threshold
            ).transpose(0, 1).contiguous()
    hist = torch.zeros((b, w, m, len(ib)), dtype=torch.complex64,
                       device=DEVICE)
    uniq, idx = mv.batch_controls(th)
    d_ib = common.weights_for_thetas(mv.geom, mv.freqs, uniq, torch.float32,
                                     torch.complex64).index_select(2, ib)
    c_k, _, lidx = lc.batch_controls(th)
    (ah, _, _, bits), gidx, _ = gs.batch_controls(th)
    w0 = torch.zeros((b, len(gs.ib), ah.shape[1], m), dtype=torch.complex64,
                     device=DEVICE)
    reset = torch.zeros((b, t), dtype=torch.bool, device=DEVICE)
    reset[:, 0] = True
    thr = mv.params.freq_mag_threshold
    gp = gs.params
    # rows 7 and 8 and the MCRA march: the phase preset's mask, the
    # phasempf preset's march from zero state, the mcra preset's march on
    # mic 0 of the streams (T, B, NB)
    nb = spec.shape[3]
    pp = make_params("phase", preset("phase"))
    mp = make_params("phasempf", preset("phasempf"))
    cp = make_params("mcra", preset("mcra"))
    w_all = common.weights_for_thetas(mv.geom, mv.freqs, uniq, torch.float32,
                                      torch.complex64)
    mask = (pp.min_phase * np.pi / 180.0, pp.mag_threshold, pp.mag_mult,
            2 * HOP)
    mst = kpm.init_state(kpm.MpfState, nb, torch.float32, DEVICE)
    cst = kpm.init_state(kpm.McraState, nb, torch.float32, DEVICE)
    mst_b, cst_b = (type(st)(*(torch.stack([f] * b) for f in st))
                    for st in (mst, cst))
    x0 = spec[:, :, 0].contiguous()
    sq = x0.abs() ** 2
    s_f = freq_smooth(sq, x0[..., 0].abs())
    one = [dict(spec=spec[:, i].contiguous(), x=x[i], tail=tail[i],
                prev=prev[i], hist=hist[i], idx=idx[i].contiguous(),
                lidx=lidx[i].contiguous(), gidx=gidx[i].contiguous(),
                gate=gate[i], w0=w0[i], reset=reset[i],
                x0=x0[:, i].contiguous(), sq=sq[:, i].contiguous(),
                s_f=s_f[:, i].contiguous()) for i in range(b)]
    rows = {
        "row 3 mvdr_stream": (
            lambda: km.mvdr_stream(spec, hist, d_ib, idx, gate, ib),
            lambda o: km.mvdr_stream(o["spec"], o["hist"], d_ib, o["idx"],
                                     o["gate"], ib)),
        "row 5 lcmv_stream S=3": (
            lambda: kl.lcmv_stream(spec, hist, c_k, lidx, gate, ib),
            lambda o: kl.lcmv_stream(o["spec"], o["hist"], c_k, o["lidx"],
                                     o["gate"], ib)),
        "row 4 mega_stream MVDR": (
            lambda: kmega.mvdr_mega(x, tail, prev, hist, d_ib, idx, ib,
                                    2 * HOP, w, thr),
            lambda o: kmega.mvdr_mega(o["x"], o["tail"], o["prev"],
                                      o["hist"], d_ib, o["idx"], ib,
                                      2 * HOP, w, thr)),
        "row 6 gss_stream S=1": (
            lambda: kgss.gss_mega(x, tail, prev, w0, ah, gidx, reset, gs.ib,
                                  2 * HOP, gp.freq_mag_threshold, gp.mu,
                                  gp.lam, act_bits=bits),
            lambda o: kgss.gss_mega(o["x"], o["tail"], o["prev"], o["w0"],
                                    ah, o["gidx"], o["reset"], gs.ib,
                                    2 * HOP, gp.freq_mag_threshold, gp.mu,
                                    gp.lam, act_bits=bits)),
        "row 7 phase_mask": (
            lambda: kpm.phase_mask(spec, w_all, idx, *mask),
            lambda o: kpm.phase_mask(o["spec"], w_all, o["idx"], *mask)),
        "row 8 mpf_march": (
            lambda: kpm.mpf_march(spec, w_all, idx, mst_b, mp, True),
            lambda o: kpm.mpf_march(o["spec"], w_all, o["idx"], mst, mp,
                                    True)),
        "mcra_march": (
            lambda: kpm.mcra_march(s_f, sq, x0, cst_b, cp, True),
            lambda o: kpm.mcra_march(o["s_f"], o["sq"], o["x0"], cst, cp,
                                     True))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for node in ("mpf", "mcra"):
        r = kpm.march_resources(node)
        log(f"march_kernel<{node.capitalize()}Node>: {r['registers']} "
            f"registers a thread, {r['smem_bytes']} bytes of shared memory "
            f"and {r['local_bytes']} of local memory a block of 256 threads,"
            f" {r['blocks_per_sm']} resident blocks an SM "
            f"(cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPer"
            f"Multiprocessor): {b} streams x {-(-nb // 8)} bin groups = "
            f"{b * -(-nb // 8)} blocks, "
            f"{b * -(-nb // 8) / (sms * max(r['blocks_per_sm'], 1)):.2f} "
            f"waves on {sms} SMs")
    for name, (batched, single) in rows.items():
        t_b = cuda_ms(batched)
        t_s = cuda_ms(lambda: [single(o) for o in one])
        bins = nb if name[:5] in ("row 7", "row 8", "mcra_") else len(ib)
        mics = "mic 0" if name.startswith("mcra") else "16 mics"
        log(f"{name}, {b} streams x {t} frames x {bins} bins, {mics}: "
            f"one batched launch {t_b:.4f} ms vs {b} single-stream launches "
            f"{t_s:.4f} ms (x{t_s / t_b:.2f}; CUDA events, median of "
            f"{REPS}) on {card}")


# ---------------------------------------------------------------------------
# the live serving path
# ---------------------------------------------------------------------------

LIVE_SECONDS = 10.0      # (b), (c): the first 10 s of the headline input
LIVE_CHUNK = 4           # (a), (c): hops a chunk (85.3 ms at 48 kHz)
JACK_CYCLES = 200        # (d): process cycles of the fake JACK server
# (e): device work queued after a monitored chunk's own, in SM cycles of
# torch.cuda._sleep (~50 ms at the H100's clock)
BLOCK_CYCLES = 10 ** 8
# (c): /theta_interference messages of the LCMV run, by chunk index, over
# EVENTS' initial set (70 deg): add #2, move it, then move it within the
# threshold of #1 (a proximity removal)
LIVE_MSGS = {20: "2:-60.0", 60: "2:-30.0", 90: "2:70.5"}


def aira16_yaml(tmp: str, interference=()) -> str:
    """aira16.yaml with ``interference`` as its static set, in ``tmp``."""
    path = os.path.join(tmp, f"aira16_{len(interference)}.yaml")
    with open(os.path.join(ROOT, "beamform_tpu_torch", "configs",
                           "aira16.yaml")) as f, open(path, "w") as g:
        g.write(f.read() + "".join(f"\nangle_interf{k + 1}: {a}"
                                   for k, a in enumerate(interference)))
    return path


def live_argv(node: str, cfg: str, chunk_hops: int, *extra) -> list:
    """The command line of a 16-channel ``--live`` run on the card."""
    return [node, "--live", "--live-channels", "16", "--array-config", cfg,
            "--live-chunk", str(chunk_hops), "--theta", str(THETA),
            "--device", DEVICE, *extra]


def live_params(node: str, dtype: str = "float32"):
    """A live run's node parameters: the CLI's launch preset; in float64
    on the CPU the plain stream solve (``auto`` would take the plain
    inverse), as phase_mvdr's references."""
    if node == "das":
        return None
    return preset(node, **({"solver": "stream"} if dtype == "float64"
                           else {}))


def interf_rows(machine, k: int, chunk_hops: int):
    """Chunk ``k``'s interference rows after LIVE_MSGS' message of that
    chunk, as the CLI's poll of its control file gives them."""
    reset = False
    if k in LIVE_MSGS:
        iid, ang = LIVE_MSGS[k].split(":")
        reset = machine.apply(int(iid), float(ang))
    return machine.rows(chunk_hops, reset_first=reset)


def live_machine():
    from beamform_tpu_torch.runtime.timeline import (MAX_INTERFERENCES,
                                                     InterferenceMachine)
    return InterferenceMachine(
        list(EVENTS[0]), threshold=preset("lcmv")["interf_angle_threshold"],
        capacity=MAX_INTERFERENCES)


def session_run(node: str, x: np.ndarray, chunk_hops: int, dtype="float32",
                device=None, timed: bool = False):
    """``x`` through a StreamingSession in chunks of ``chunk_hops`` (the
    tail zero-padded, the output cut to the input), as the live loop
    chunks it; LCMV under LIVE_MSGS. ``timed``: first one zero warm-up
    chunk and a fresh state, as the live loop starts, then every chunk
    timed by a ``RealTimeMonitor`` (host numpy in, output ready on the
    card). Returns (output, the monitor's report with its latency
    percentiles, or None)."""
    from beamform_tpu_torch.models import get_model
    from beamform_tpu_torch.runtime.streaming import StreamingSession
    from beamform_tpu_torch.utils.profiling import RealTimeMonitor
    interf = EVENTS[0] if node == "lcmv" else ()
    model = get_model(node, engine(dtype), aira16(interf),
                      live_params(node, dtype), device=device or DEVICE)
    sess = StreamingSession(model)
    machine = live_machine() if node == "lcmv" else None
    chunk = chunk_hops * HOP

    def step(k, xc):
        kw = ({} if machine is None else
              {"interference": interf_rows(machine, k, chunk_hops)})
        return sess.process(xc, THETA, **kw).cpu().numpy()

    if timed:
        step(-1, np.zeros((16, chunk), np.float32))
        sess.state = model.stream_init()
        sess.monitor = RealTimeMonitor(FS)
    xp = np.pad(x, ((0, 0), (0, (-x.shape[1]) % chunk)))
    y = np.concatenate([step(k, xp[:, k * chunk:(k + 1) * chunk])
                        for k in range(xp.shape[1] // chunk)])[:x.shape[1]]
    return y, (dict(sess.monitor.report(), chunk_ms=sess.monitor.latency_ms())
               if timed else None)


def live_reference(node: str, seconds: float, chunk_hops: int):
    """The float64 CPU path of a live run at its chunking, run in a worker
    process beside the card's phases."""
    import torch
    torch.set_num_threads(2)
    x = make_input(16, SECONDS)[:, :int(seconds * FS)]
    return session_run(node, x, chunk_hops, "float64", "cpu")[0]


def live_report(err: str) -> dict:
    """The ``{"live": ...}`` run report, the last JSON line of stderr."""
    return json.loads([ln for ln in err.splitlines()
                       if ln.startswith("{")][-1])["live"]


def live_subprocess(argv: list, pcm: np.ndarray, paced: bool = False):
    """``python -m beamform_tpu_torch.runtime.cli <argv>`` fed ``pcm``
    ((S, 16) float32 frames) through its stdin: at once, or after a
    handshake (one hop in, one out: the child's start and warm-up do not
    count) one hop every HOP / FS seconds of the wall clock. Returns
    (output, run report)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "beamform_tpu_torch.runtime.cli", *argv],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=ROOT, env=dict(os.environ,
                                                   PYTHONPATH=ROOT))
    try:
        if not paced:
            out, err = proc.communicate(pcm.tobytes(), timeout=600)
        else:
            import threading
            hops = [pcm[i:i + HOP].tobytes()
                    for i in range(0, len(pcm), HOP)]
            proc.stdin.write(hops[0])
            proc.stdin.flush()
            first = proc.stdout.read(HOP * 4)
            got = []
            reader = threading.Thread(
                target=lambda: got.append(proc.stdout.read()), daemon=True)
            reader.start()
            t0 = time.perf_counter()
            for i, h in enumerate(hops[1:], 1):
                delay = t0 + i * HOP / FS - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                proc.stdin.write(h)
                proc.stdin.flush()
            proc.stdin.close()
            reader.join(timeout=120)
            err = proc.stderr.read()
            proc.wait(timeout=120)
            out = first + b"".join(got)
    finally:
        proc.kill()
        proc.wait()
    err = err.decode()
    if proc.returncode != 0:
        raise AssertionError(f"live {' '.join(argv)}: exit "
                             f"{proc.returncode}\n{err[-3000:]}")
    return np.frombuffer(out, dtype="<f4"), live_report(err)


def live_in_process(argv: list, x: np.ndarray, chunk_hops: int):
    """``cli.run_live`` in this process through two OS pipes, fed chunk by
    chunk, each only after the last one's output came back (so that
    LIVE_MSGS are appended to the control file at their chunk's
    boundary). Returns (output, run report)."""
    import contextlib
    import io
    import threading
    import torch
    from beamform_tpu_torch.runtime import cli
    args = cli.build_parser().parse_args(argv)
    rin, win = os.pipe()
    rout, wout = os.pipe()
    stdin, stdout = os.fdopen(rin, "rb", buffering=0), os.fdopen(wout, "wb")
    err, res = io.StringIO(), {}

    def run():
        try:
            with contextlib.redirect_stderr(err):
                res["rc"] = cli.run_live(args, torch.device(DEVICE), stdin,
                                         stdout)
        finally:
            stdout.close()
            stdin.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    chunk = chunk_hops * HOP
    n = -(-x.shape[1] // chunk)
    out = bytearray()
    for k in range(n):
        if args.interf_control and k in LIVE_MSGS:
            with open(args.interf_control, "a") as f:
                f.write(LIVE_MSGS[k] + "\n")
        blk = np.ascontiguousarray(x[:, k * chunk:(k + 1) * chunk].T,
                                   dtype="<f4")
        os.write(win, blk.tobytes())
        if k == n - 1:
            break            # a short last chunk is processed at EOF
        want = len(out) + blk.shape[0] * 4
        while len(out) < want:
            d = os.read(rout, want - len(out))
            if not d:
                break
            out += d
    os.close(win)
    while d := os.read(rout, 1 << 16):
        out += d
    th.join(timeout=120)
    os.close(rout)
    if th.is_alive() or res.get("rc") != 0:
        raise AssertionError(f"live {' '.join(argv)}: {res}\n"
                             f"{err.getvalue()[-3000:]}")
    return np.frombuffer(bytes(out), dtype="<f4"), live_report(
        err.getvalue())


def check_live(label: str, y: np.ndarray, card_ref: np.ndarray,
               ref64: np.ndarray):
    """A live run's output: the card's StreamingSession at the same
    chunking bit for bit, the float64 CPU path within DAS_ABS_TOL."""
    if not np.array_equal(y, card_ref):
        diff = (float(np.abs(y - card_ref).max()) if y.shape ==
                card_ref.shape else f"shape {y.shape} vs {card_ref.shape}")
        raise AssertionError(f"{label}: differs from the card's "
                             f"StreamingSession ({diff})")
    check_scene(f"{label} (equal to the card's StreamingSession bit for "
                "bit) vs float64 CPU", y, ref64, len(ref64), False)


def jack_live(cfg: str, x: np.ndarray):
    """(d): ``das --live --jack`` at one hop a chunk, in this process,
    against the fake JACK server (``csrc/fakejack.cpp`` through
    BEAMIO_JACK_LIB) at 16 channels and 1024 frames a period, driven for
    JACK_CYCLES cycles in lockstep: each cycle only after the client wrote
    the last chunk, so that cycle n + 1 plays chunk n whole. Returns (the
    JACK_CYCLES played hops, run report, launches of the loop)."""
    import contextlib
    import ctypes
    import io
    import threading
    from beamform_tpu_torch.runtime import cli, native
    path = native.build_library("fakejack.cpp")
    drv = ctypes.CDLL(path)
    fp = ctypes.POINTER(ctypes.c_float)
    drv.fakejack_drive.restype = ctypes.c_int
    drv.fakejack_drive.argtypes = [fp, ctypes.c_uint32, ctypes.c_int, fp]
    drv.fakejack_set_buffer_size.argtypes = [ctypes.c_uint32]
    drv.fakejack_set_buffer_size(HOP)
    written = threading.Semaphore(0)
    real_write = native.JackClient.write

    def write(self, data):
        got = real_write(self, data)
        written.release()
        return got

    outs = []

    def server():
        for k in range(JACK_CYCLES + 1):
            if k and not written.acquire(timeout=120):
                return
            blk = (x[:, k * HOP:(k + 1) * HOP] if k < JACK_CYCLES
                   else np.zeros((16, HOP), np.float32))
            inter = np.ascontiguousarray(blk.T, dtype=np.float32)
            out = np.zeros(HOP, np.float32)
            # the first cycle waits for the client's process callback
            while drv.fakejack_drive(inter.ctypes.data_as(fp), HOP, 16,
                                     out.ctypes.data_as(fp)) != 0:
                if k or time.perf_counter() > deadline:
                    return
                time.sleep(0.001)
            outs.append(out)

    err = io.StringIO()
    deadline = time.perf_counter() + 300
    os.environ["BEAMIO_JACK_LIB"] = path
    native.JackClient.write = write
    th = threading.Thread(target=server, daemon=True)
    th.start()
    try:
        reset_launches()
        with contextlib.redirect_stderr(err):
            rc = cli.main(live_argv("das", cfg, 1, "--jack", "--max-chunks",
                                    str(JACK_CYCLES + 1)))
        launches = read_launches()
    finally:
        native.JackClient.write = real_write
        del os.environ["BEAMIO_JACK_LIB"]
    th.join(timeout=120)
    if rc != 0 or th.is_alive() or len(outs) != JACK_CYCLES + 1:
        raise AssertionError(f"jack loop: rc {rc}, {len(outs)} cycles\n"
                             f"{err.getvalue()[-3000:]}")
    return np.concatenate(outs[1:]), live_report(err.getvalue()), launches


def host_steal() -> tuple:
    """(CPU time stolen from this host's cores by its hypervisor, in
    clock ticks, from /proc/stat; the 1-minute load average)."""
    with open("/proc/stat") as f:
        cpu = f.readline().split()
    return int(cpu[8]) if len(cpu) > 8 else 0, os.getloadavg()[0]


def phase_live(card: str, pool, x: np.ndarray):
    """The live serving path at full width (aira16, 48 kHz, hop 1024, the
    headline input), through ``beamform-tpu-torch <node> --live``, each
    output equal to the card's StreamingSession at the same chunking bit
    for bit: (b) DAS at one hop a chunk on 10 s fed at the audio rate
    through a subprocess's pipe, first, while the host is otherwise
    quiet: no xrun, its per-chunk wall times against the 21.3 ms budget;
    (a) DAS at 4 hops a chunk on the 30 s input through a subprocess's
    pipe; (c) MVDR ``auto`` (row 3) and LCMV ``auto`` (row 5) with
    ``--interf-control`` under LIVE_MSGS, 10 s each, in this process
    through OS pipes with each path's launches counted; (a) and (c) within
    DAS_ABS_TOL of the float64 CPU path; (d) the JACK loop over the fake
    server for JACK_CYCLES cycles, equal to (b)'s first hops bit for bit;
    the per-chunk latency of DAS, MVDR and LCMV at 1 and LIVE_CHUNK hops a
    chunk (:func:`session_run`, timed); last, as it runs the profiler, (e)
    (a)'s median per-chunk wall at least the chunk's device time, and a
    monitored chunk whose model queues more device work after its own
    waits for it: the monitor synchronises."""
    import torch
    from beamform_tpu_torch.models import get_model
    from beamform_tpu_torch.runtime.streaming import StreamingSession
    short = int(LIVE_SECONDS * FS)
    budget = {k: k * HOP / FS * 1e3 for k in (1, LIVE_CHUNK)}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        cfg = aira16_yaml(tmp)
        # (b)
        steal0, load = host_steal()
        y_b, rep_b = live_subprocess(live_argv("das", cfg, 1),
                                     np.ascontiguousarray(x[:, :short].T),
                                     paced=True)
        steal = host_steal()[0] - steal0
        lat = rep_b["chunk_ms"]
        log(f"live das --live-chunk 1, {LIVE_SECONDS:g} s fed at the audio "
            f"rate: {rep_b['chunks']} chunks, xruns {rep_b['xruns']}, "
            f"per-chunk wall median {lat['median']:.3f} ms, p99 "
            f"{lat['p99']:.3f}, worst {lat['worst']:.3f} (chunk "
            f"{lat['worst_at']}) against the {budget[1]:.1f} ms budget "
            f"(worst/budget {rep_b['worst_chunk_ratio']}); host: load "
            f"{load:.2f} before, {steal} ticks stolen during; report "
            f"{json.dumps(rep_b)}; on {card}")
        if rep_b["xruns"] != 0:
            raise AssertionError(f"live das chunk 1 paced: {rep_b['xruns']} "
                                 "xruns")
        refs = {"das": pool.apply_async(live_reference,
                                        ("das", SECONDS, LIVE_CHUNK)),
                "mvdr": pool.apply_async(live_reference,
                                         ("mvdr", LIVE_SECONDS, LIVE_CHUNK)),
                "lcmv": pool.apply_async(live_reference,
                                         ("lcmv", LIVE_SECONDS, LIVE_CHUNK))}
        y_b_card = session_run("das", x[:, :short], 1)[0]
        if not np.array_equal(y_b, y_b_card):
            raise AssertionError("live das chunk 1 differs from the card's "
                                 "StreamingSession")
        log(f"live das --live-chunk 1 equals the card's StreamingSession "
            f"bit for bit ({len(y_b)} samples)")
        # (a)
        t0 = time.perf_counter()
        y_a, rep_a = live_subprocess(live_argv("das", cfg, LIVE_CHUNK),
                                     np.ascontiguousarray(x.T))
        log(f"live das --live-chunk {LIVE_CHUNK}, {SECONDS:g} s through a "
            f"subprocess's pipe: {time.perf_counter() - t0:.1f} s wall; "
            f"report {json.dumps(rep_a)}")
        # (c)
        launches, outs_c = {}, {}
        for node in ("mvdr", "lcmv"):
            extra = ()
            if node == "lcmv":
                ctl = os.path.join(tmp, "interf.ctl")
                open(ctl, "w").close()
                extra = ("--interf-control", ctl)
            argv = live_argv(node, aira16_yaml(
                tmp, EVENTS[0] if node == "lcmv" else ()), LIVE_CHUNK, *extra)
            reset_launches()
            outs_c[node], rep = live_in_process(argv, x[:, :short],
                                                LIVE_CHUNK)
            launches[node] = read_launches()
            kernel = f"{node}_stream"
            log(f"live {node} --live-chunk {LIVE_CHUNK}"
                f"{' --interf-control ' + str(LIVE_MSGS) if extra else ''}, "
                f"{LIVE_SECONDS:g} s through OS pipes: launches "
                f"{launches[node]}; report {json.dumps(rep)}")
            n_chunks = -(-short // (LIVE_CHUNK * HOP)) + 1      # + warm-up
            want = dict(wola_analysis=n_chunks, wola_synthesis=n_chunks,
                        **{kernel: n_chunks})
            if any(launches[node][k] != v for k, v in want.items()):
                raise AssertionError(f"live {node}: launches "
                                     f"{launches[node]}, expected {want}")
        # the card's sessions at the same chunking
        y_a_card = session_run("das", x, LIVE_CHUNK)[0]
        card_c = {n: session_run(n, x[:, :short], LIVE_CHUNK)[0]
                  for n in ("mvdr", "lcmv")}
        t0 = time.perf_counter()
        ref64 = {k: r.get() for k, r in refs.items()}
        log(f"live float64 CPU references: waited "
            f"{time.perf_counter() - t0:.1f} s")
        check_live(f"live das --live-chunk {LIVE_CHUNK} ({SECONDS:g} s)",
                   y_a, y_a_card, ref64["das"])
        for node in ("mvdr", "lcmv"):
            check_live(f"live {node} --live-chunk {LIVE_CHUNK} "
                       f"({LIVE_SECONDS:g} s)", outs_c[node], card_c[node],
                       ref64[node][:short])
        # (d)
        y_d, rep_d, launches_d = jack_live(cfg, x)
        log(f"live das --jack, fake server, {JACK_CYCLES} cycles of {HOP} "
            f"frames x 16 channels: launches {launches_d}; report "
            f"{json.dumps(rep_d)}")
        n = JACK_CYCLES + 2                          # + warm-up, + drain
        if (launches_d["wola_analysis"] != n
                or launches_d["wola_synthesis"] != n):
            raise AssertionError(f"jack loop launches {launches_d}, "
                                 f"expected {n} of each WOLA kernel")
        if rep_d["jack_xruns"] != 0 or rep_d["jack_connected_in"] != 16:
            raise AssertionError(f"jack loop report {rep_d}")
        if not np.array_equal(y_d, y_b[:JACK_CYCLES * HOP]):
            raise AssertionError("jack loop output differs from the pipe's "
                                 "at one hop a chunk")
        log(f"live das --jack equals --live-chunk 1 through the pipe bit "
            f"for bit ({JACK_CYCLES} hops)")
    # the live loop's per-chunk latency without its pipe, by node and chunk
    for node in ("das", "mvdr", "lcmv"):
        for k in (1, LIVE_CHUNK):
            rep = session_run(node, x[:, :short], k, timed=True)[1]
            lat = rep["chunk_ms"]
            log(f"live latency {node} auto at {k} hop(s) a chunk, "
                f"{LIVE_SECONDS:g} s, StreamingSession from host numpy: "
                f"median {lat['median']:.4f} ms, p99 {lat['p99']:.4f}, worst "
                f"{lat['worst']:.4f} (chunk {lat['worst_at']}) of "
                f"{rep['chunks']} chunks against {budget[k]:.1f} ms, xruns "
                f"{rep['xruns']}, xRT {rep['xrt']}; on {card}")
    # (e) the chunk's device time: its kernels and copies by the profiler,
    # the mean of 5 calls
    from torch.profiler import ProfilerActivity, profile
    model = get_model("das", engine(), aira16(), device=DEVICE)
    sess = StreamingSession(model)
    blk = np.ascontiguousarray(x[:, :LIVE_CHUNK * HOP])
    sess.process(blk, THETA).cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            sess.process(blk, THETA).cpu()
    busy = sum(getattr(e, "device_time_total", 0.0)
               for e in prof.key_averages()
               if not e.key.startswith(("aten::", "cuda"))) / 5e3
    # and a monitored chunk whose model queues BLOCK_CYCLES of device work
    # after its own must wait for it: a monitor that did not synchronise
    # would stop at the launches
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    real = model.process_chunk

    def slow(*args, **kw):
        out = real(*args, **kw)
        a.record()
        torch.cuda._sleep(BLOCK_CYCLES)
        b.record()
        return out

    mon = StreamingSession(model, monitor=True)
    model.process_chunk = slow
    try:
        mon.process(blk, THETA)
    finally:
        del model.process_chunk
    queued = a.elapsed_time(b)
    waited = mon.monitor.chunk_walls[-1] * 1e3
    wall = rep_a["chunk_ms"]["median"]
    log(f"live das per-chunk wall (monitor, median of {rep_a['chunks']}) "
        f"{wall:.4f} ms at {LIVE_CHUNK} hops vs the chunk's device time "
        f"{busy:.4f} ms (kernels and copies by the profiler, mean of 5); "
        f"budget {budget[LIVE_CHUNK]:.1f} ms; a monitored chunk with "
        f"{queued:.3f} ms of device work queued after its own: "
        f"{waited:.3f} ms; on {card}")
    if not (busy > 0 and wall >= busy and waited >= queued > 10.0):
        raise AssertionError(f"live monitor: wall {wall} ms vs device "
                             f"{busy} ms; {waited} ms with {queued} ms of "
                             "work queued after the chunk's own")


# the parallel phase: 8 streams of 2 s of the speech input, each with its
# quiet lead-in, in 3 chunks of 31 hops, thetas linspace(-60, 60, 8)
PAR_STREAMS = 8
PAR_SECONDS = 2.0
PAR_CHUNK_HOPS = 31
PAR_CHUNKS = 3
# (label, node, preset overrides (None: no preset), static interferers, the
# mesh axis that splits the case, the overrides of the single-process
# BatchRunner it must equal): the covariance models over bin groups (MVDR
# ``mega`` runs the stream kernel under sharding, as in the JAX package,
# so its reference is the ``stream`` runner); DAS (the stateless spectral
# pipeline), GSS and phase over streams
PAR_CASES = (
    ("mvdr stream", "mvdr", {}, (), "bin", {}),
    ("mvdr mega", "mvdr", {"solver": "mega"}, (), "bin", {"solver": "stream"}),
    ("lcmv S=3", "lcmv", {}, INTERFERERS, "bin", {}),
    ("das", "das", None, (), "stream", None),
    ("gss", "gss", {}, (), "stream", {}),
    ("phase", "phase", {}, (), "stream", {}))
# each stream's output and state shard against the single-process run:
# bit for bit, but GSS, whose fused kernel's overlap-add adds with atomics,
# within BATCH_PEAK_TOL of the peak (phase_batch's bar)
PAR_INEXACT = ("gss",)
PAR_RANK_TIMEOUT_S = 300
# the card against float64 on the CPU on examples/torch_demo.py's scene:
# each node's SIR gain (dB)
EVAL_NODES = ("das", "mvdr", "lcmv", "gss", "phase")
EVAL_GAIN_DB = 0.05


def make_parallel_input() -> np.ndarray:
    """(8, 16, 93 hops) float32: 8 consecutive 2 s slices of the speech
    input, each with make_speech_input's quiet lead-in."""
    hops = int(PAR_SECONDS * FS) // HOP
    s = int(PAR_SECONDS * FS)
    x = make_speech_input(16, PAR_STREAMS * PAR_SECONDS)
    xs = np.stack([x[:, i * s:i * s + hops * HOP]
                   for i in range(PAR_STREAMS)])
    xs[1:, :, :12 * HOP] *= 1e-3
    return xs


def parallel_model(node, over, interf):
    from beamform_tpu_torch.models import get_model
    return get_model(node, engine(), aira16(interf),
                     None if over is None else preset(node, **over),
                     device=DEVICE)


def parallel_cases(mesh_bin, mesh_stream) -> dict:
    """Every case of PAR_CASES on this rank's share of the parallel input:
    its streams and, over the bin axis, its bin group; from
    sharded_state_init, one sharded_batched_step a chunk (DAS: one
    sharded_spectral_pipeline call on the whole input). Returns the
    rank's outputs, state shards, mesh coordinates and each chunk's
    launches, as numpy."""
    import torch
    from torch.utils import _pytree as pytree
    from beamform_tpu_torch.models import common
    from beamform_tpu_torch.parallel.sharded import (
        axis, sharded_batched_step, sharded_spectral_pipeline,
        sharded_state_init)
    xd = torch.as_tensor(make_parallel_input(), device=DEVICE)
    thetas = np.linspace(-60.0, 60.0, PAR_STREAMS)
    c = PAR_CHUNK_HOPS * HOP
    res = {}
    for label, node, over, interf, ax, _ in PAR_CASES:
        mesh = mesh_bin if ax == "bin" else mesh_stream
        (n_s, g), (n_b, k) = axis(mesh, "stream"), axis(mesh, "bin")
        b = PAR_STREAMS // n_s
        rows = slice(g * b, (g + 1) * b)
        model = parallel_model(node, over, interf)
        launches, leaves = [], []
        if node == "das":
            uniq, _ = model.batch_controls(np.full((1, 1), THETA))
            w = common.weights_for_thetas(model.geom, model.freqs, uniq,
                                          model.rdtype, model.cdtype)[0]
            reset_launches()
            out = sharded_spectral_pipeline(mesh, engine(), w, xd[rows])
            launches.append(read_launches())
        else:
            state = sharded_state_init(mesh, model, PAR_STREAMS)
            outs = []
            for i in range(PAR_CHUNKS):
                reset_launches()
                o, state = sharded_batched_step(
                    mesh, model, xd[rows, :, i * c:(i + 1) * c],
                    thetas[rows], state)
                launches.append(read_launches())
                outs.append(o)
            out = torch.cat(outs, dim=1)
            leaves = pytree.tree_leaves(state)
        res[f"{label}/coord"] = np.array([n_s, g, n_b, k])
        res[f"{label}/out"] = out.cpu().numpy()
        for i, leaf in enumerate(leaves):
            res[f"{label}/state{i}"] = leaf.cpu().numpy()
        res[f"{label}/launches"] = np.array(
            [[n[name] for name in counters()] for n in launches])
    return res


def parallel_rank(rank: int, port: int, out: str):
    """One rank of the 2-rank gloo world on the one card (a spawned
    process): meshes (1, 2) and (2, 1) over the world, every case, its
    results to ``out``/rank<r>.npz."""
    import torch
    import torch.distributed as dist
    from beamform_tpu_torch.parallel.mesh import make_mesh
    from beamform_tpu_torch.parallel.multihost import init_multihost
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    init_multihost(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                   backend="gloo")
    try:
        res = parallel_cases(make_mesh(shape=(1, 2)),
                             make_mesh(shape=(2, 1)))
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_references() -> dict:
    """Each case's single-process BatchRunner run of the parallel input
    on the card (the reference override of PAR_CASES): output (8, S),
    state leaves, each chunk's launches."""
    import torch
    from torch.utils import _pytree as pytree
    from beamform_tpu_torch.runtime.batch import BatchRunner
    xd = torch.as_tensor(make_parallel_input(), device=DEVICE)
    thetas = np.linspace(-60.0, 60.0, PAR_STREAMS)
    c = PAR_CHUNK_HOPS * HOP
    refs = {}
    for label, node, _, interf, _, ref_over in PAR_CASES:
        runner = BatchRunner(node, engine(), aira16(interf),
                             None if ref_over is None
                             else preset(node, **ref_over),
                             batch=PAR_STREAMS, device=DEVICE)
        outs, launches = [], []
        pieces = ([(xd, THETA)] if node == "das" else
                  [(xd[..., i * c:(i + 1) * c].contiguous(), thetas)
                   for i in range(PAR_CHUNKS)])
        for xc, th in pieces:
            reset_launches()
            outs.append(runner.process(xc, th))
            launches.append(read_launches())
        refs[label] = dict(
            out=torch.cat(outs, dim=1).cpu().numpy(),
            state=[a.cpu().numpy() for a in pytree.tree_leaves(runner.state)]
            if node != "das" else [],
            launches=np.array([[n[k] for k in counters()]
                               for n in launches]))
    return refs


def bin_positions(nib: int, size: int, index: int) -> np.ndarray:
    """The band positions of bin group ``index`` of ``size``, the band
    padded by repeating its last bin (parallel/sharded.py _bin_group)."""
    pos = np.concatenate([np.arange(nib), np.full((-nib) % size, nib - 1)])
    n = len(pos) // size
    return pos[index * n:(index + 1) * n]


def check_parallel(world: str, results: list, refs: dict):
    """Each rank's outputs, state shards and launches against the
    single-process run: its rows of the output; of each state leaf its
    rows and, for the bin-sharded history (the last leaf of MVDR/LCMV),
    its bin group's lanes; each chunk's launches equal to the
    BatchRunner chunk's, one launch of the case's kernels a chunk."""
    names = list(counters())
    for label, node, _, _, ax, _ in PAR_CASES:
        ref = refs[label]
        exact = label not in PAR_INEXACT
        for r, res in enumerate(results):
            n_s, g, n_b, k = (int(v) for v in res[f"{label}/coord"])
            b = PAR_STREAMS // n_s
            rows = slice(g * b, (g + 1) * b)
            why = same(res[f"{label}/out"], ref["out"][rows], exact)
            for i, want in enumerate(ref["state"]):
                want = want[rows]
                if ax == "bin" and i == len(ref["state"]) - 1:
                    want = want[..., bin_positions(want.shape[-1], n_b, k)]
                got = res[f"{label}/state{i}"]
                differs = (f"{got.shape} vs {want.shape}"
                           if got.shape != want.shape
                           else same(got, want, exact))
                if differs:
                    why = why or f"state {i}: {differs}"
            if not np.array_equal(res[f"{label}/launches"],
                                  ref["launches"]):
                why = why or (f"launches {res[f'{label}/launches'].tolist()}"
                              f" vs {ref['launches'].tolist()}")
            if why:
                raise AssertionError(f"parallel {world} {label}: rank {r}: "
                                     f"{why}")
            a = res[f"{label}/out"]
            match = ("bit for bit" if np.array_equal(
                a, ref["out"][rows], equal_nan=True)
                else f"within {peak_rel(a, ref['out'][rows]):.3e} of peak")
            launched = ", ".join(
                f"{names[j]} x{v}" for j, v in
                enumerate(ref["launches"][0]) if v)
            shards = ", its state shards too" if ref["state"] else ""
            log(f"parallel {world} {label}: rank {r} at stream {g}/{n_s}, "
                f"bin {k}/{n_b}: rows {rows.start}:{rows.stop} {match} of "
                f"BatchRunner (B = {PAR_STREAMS}){shards}; a chunk launches "
                f"{launched}, as BatchRunner's")


def parallel_eval(card: str):
    """(c): evaluate_separation on examples/torch_demo.py's 2 s scene on
    the card against the float64 CPU run, each node's SIR gain within
    EVAL_GAIN_DB."""
    import importlib.util
    from beamform_tpu_torch.evaluation import evaluate_separation
    from beamform_tpu_torch.models import get_model
    spec = importlib.util.spec_from_file_location(
        "torch_demo", os.path.join(ROOT, "examples", "torch_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    eng32, cfg, scene = demo.demo_scene(2.0)
    eng64, _, _ = demo.demo_scene(2.0, "float64")
    for node in EVAL_NODES:
        card_rep = evaluate_separation(
            get_model(node, eng32, cfg, demo.PARAMS[node], device=DEVICE),
            scene, theta=0.0)
        cpu_rep = evaluate_separation(
            get_model(node, eng64, cfg, demo.PARAMS[node], device="cpu"),
            scene, theta=0.0)
        gap = abs(card_rep["sir_gain_db"] - cpu_rep["sir_gain_db"])
        log(f"parallel eval {node}: SIR gain {card_rep['sir_gain_db']:+.2f} "
            f"dB on the card, {cpu_rep['sir_gain_db']:+.2f} float64 on the "
            f"CPU (bar {EVAL_GAIN_DB} dB); on {card}")
        if not gap <= EVAL_GAIN_DB:
            raise AssertionError(f"eval {node}: {card_rep} vs {cpu_rep}")


def parallel_ab(card: str):
    """The 1-rank sharded MVDR ``stream`` step of a 2 s chunk of the 8
    streams against BatchRunner's (CUDA events, median of REPS after one
    warm-up, in turns): the sharding layer's host work and all-gather at
    world size 1."""
    import torch
    from beamform_tpu_torch.parallel.mesh import make_mesh
    from beamform_tpu_torch.parallel.sharded import (sharded_batched_step,
                                                     sharded_state_init)
    from beamform_tpu_torch.runtime.batch import BatchRunner
    xd = torch.as_tensor(make_parallel_input(), device=DEVICE)
    thetas = np.linspace(-60.0, 60.0, PAR_STREAMS)
    model = parallel_model("mvdr", {}, ())
    mesh = make_mesh(shape=(1, 1))
    state = sharded_state_init(mesh, model, PAR_STREAMS)
    runner = BatchRunner("mvdr", engine(), aira16(), preset("mvdr"),
                         batch=PAR_STREAMS, device=DEVICE)
    t = {"sharded": [], "runner": []}
    for _ in range(2):
        t["runner"].append(cuda_ms(lambda: runner.process(xd, thetas)))
        t["sharded"].append(cuda_ms(lambda: sharded_batched_step(
            mesh, model, xd, thetas, state)))
    log(f"parallel a/b, 1-rank nccl, mvdr stream, {PAR_STREAMS} streams x "
        f"{xd.shape[-1] // HOP} hops: sharded_batched_step "
        f"{t['sharded']} ms vs BatchRunner.process {t['runner']} ms "
        f"(CUDA events, median of {REPS}, two turns); on {card}")


def phase_parallel(card: str):
    """The multi-device layer on the one card. (a) A 2-rank gloo world,
    both ranks on cuda:0 (spawned processes): the (1, 2) mesh splits MVDR
    ``stream`` and ``mega`` and LCMV S = 3 over bin groups, the (2, 1)
    mesh DAS, GSS and phase over streams; each rank's rows and state
    shards against the single-process BatchRunner run (check_parallel).
    (b) A 1-rank NCCL world through init_multihost in this process, mesh
    (1, 1), the same comparison, and the A/B of parallel_ab. (c)
    evaluate_separation on the card against float64. (d)
    examples/torch_demo.py --seconds 2 in a subprocess."""
    import torch.distributed as dist
    from beamform_tpu_torch.parallel.mesh import make_mesh
    from beamform_tpu_torch.parallel.multihost import init_multihost
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        port = free_port()
        procs = [ctx.Process(target=parallel_rank, args=(r, port, tmp))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            refs = parallel_references()
            for p in procs:
                p.join(PAR_RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"parallel gloo ranks exited {codes}")
        results = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                   for r in range(2)]
    log("parallel gloo: 2 ranks on cuda:0; gloo took the CUDA all-gathers "
        "itself, nothing staged through host memory")
    check_parallel("gloo 2 ranks", results, refs)
    init_multihost(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        log(f"parallel nccl: backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}")
        mesh = make_mesh(shape=(1, 1))
        check_parallel("nccl 1 rank", [parallel_cases(mesh, mesh)], refs)
        parallel_ab(card)
    finally:
        dist.destroy_process_group()
    parallel_eval(card)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples", "torch_demo.py"),
             "--seconds", "2", "--outdir", tmp], capture_output=True,
            text=True, timeout=PAR_RANK_TIMEOUT_S)
        log(run.stdout.strip())
        if run.returncode:
            raise AssertionError(f"torch_demo.py exited {run.returncode}: "
                                 f"{run.stderr[-2000:]}")
        log(f"parallel demo: examples/torch_demo.py --seconds 2 exit 0 in "
            f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(card)                # name, power limit: as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("build", phase_build)
    # worker processes for GSC's float64 CPU references, idle until drive
    # gives them work; leaving the block stops them
    with multiprocessing.get_context("spawn").Pool(REF_WORKERS) as pool:
        return drive(pool, card, t_start)


def drive(pool, card: str, t_start: float) -> int:
    """Every phase after the build in order, then the kernels line and the
    result line."""
    import torch
    x = make_input(16, SECONDS)
    xs = make_speech_input(16, SECONDS)
    xsrc = make_source_input(16, SECONDS)
    t_main = -(-x.shape[1] // HOP)
    wola = phase("kernels", phase_kernels, t_main)
    kern = {"wola_analysis": wola["analysis"],
            "wola_synthesis": wola["synthesis"],
            **phase("mvdr_kernels", phase_mvdr_kernels, x, xs),
            **phase("lcmv_kernels", phase_lcmv_kernels, x),
            **phase("mega_kernels", phase_mega_kernels, x),
            **phase("gss_kernels", phase_gss_kernels, x),
            **phase("phase_kernels", phase_phase_kernels, x, xsrc),
            **phase("gsc_kernels", phase_gsc_kernels, x, xs, card, pool)}
    # the gsc phase's float64 CPU references run in the workers from here
    # on, beside the node phases: not beside the kernel checks above,
    # whose host launch overheads they would inflate
    gsc_refs = {(inp, path): pool.apply_async(gsc_reference, (inp, path))
                for path in ("per-sample", "blocklms128", "blocklms512")
                for inp in ("noise", "speech")}
    refs_batch = batch_refs(pool)
    y, das_launches = phase("das", phase_das, x)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phase("das_streaming", phase_streaming, x, y, tmp)
        phase("das_cli", phase_cli, x, tmp)
    phase("das_xrt", phase_xrt, x, card)
    mvdr_outs, mvdr_refs, mvdr_launches = phase("mvdr", phase_mvdr, x, xs)
    y_mvdr = mvdr_outs[("noise", "auto")]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phase("mvdr_streaming", phase_streaming, x, y_mvdr, tmp, "mvdr",
              preset("mvdr"))
        phase("mvdr_cli", phase_cli, x, tmp, "mvdr", preset("mvdr"))
    phase("mvdr_xrt", phase_xrt, x, card, "mvdr", preset("mvdr"), "noise")
    phase("mvdr_xrt", phase_xrt, xs, card, "mvdr", preset("mvdr"), "speech")
    phase("mvdr_xrt", phase_xrt, x, card, "mvdr",
          preset("mvdr", solver="dense"), "noise, dense")
    lcmv_outs, lcmv_refs, lcmv_launches = phase("lcmv", phase_lcmv, x, xs,
                                                y_mvdr, mvdr_refs["noise"])
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phase("lcmv_streaming", phase_streaming, x,
              lcmv_outs[("noise", "auto")], tmp, "lcmv", preset("lcmv"),
              tol=0.0)
        phase("lcmv_cli", phase_cli, x, tmp, "lcmv", preset("lcmv"),
              ["--stream", "64"], seconds=4.0, interference=EVENTS[0],
              events="1.5:2:-60,3:2:70.5", tol=0.0)
    phase("lcmv_xrt", phase_xrt, x, card, "lcmv", preset("lcmv"), "noise, S=1")
    phase("lcmv_xrt", phase_xrt, xs, card, "lcmv", preset("lcmv"),
          "speech, S=1")
    phase("lcmv_xrt", phase_xrt, x, card, "lcmv", preset("lcmv"), "noise, S=3",
          INTERFERERS)
    phase("lcmv_xrt", phase_xrt, x, card, "lcmv",
          preset("lcmv", solver="dense"), "noise, dense")
    y_mega, mega_launches = phase("mega", phase_mega, x, xs, mvdr_outs,
                                  mvdr_refs, lcmv_outs, lcmv_refs)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phase("mega_streaming", phase_streaming, x, y_mega, tmp, "mvdr",
              preset("mvdr", solver="mega"), tol=0.0)
        phase("mega_cli", phase_cli, x, tmp, "mvdr",
              preset("mvdr", solver="mega"), ["--param", "solver=mega"])
        phase("mega_cli", phase_cli, x, tmp, "lcmv",
              preset("lcmv", solver="mega"),
              ["--stream", "64", "--param", "solver=mega"], seconds=4.0,
              interference=EVENTS[0], events="1.5:2:-60,3:2:70.5", tol=0.0)
    phase("mega_xrt", phase_xrt, x, card, "mvdr",
          preset("mvdr", solver="mega"), "noise, mega")
    phase("mega_xrt", phase_xrt, x, card, "lcmv",
          preset("lcmv", solver="mega"), "noise, S=1, mega")
    y_gss, gss_launches = phase("gss", phase_gss, x, xs)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        phase("gss_streaming", phase_streaming, x, y_gss, tmp, "gss",
              preset("gss"), tol=0.0)
        phase("gss_cli", phase_cli, x, tmp, "gss", preset("gss"),
              ["--stream", "64"], seconds=4.0, interference=EVENTS[0],
              events="1.5:2:-60,3:2:70.5", tol=0.0)
    phase("gss_xrt", phase_xrt, x, card, "gss", preset("gss"), "noise")
    phase("gss_xrt", phase_xrt, x, card, "gss", preset("gss"), "noise, S=3",
          INTERFERERS)
    node_launches = {}
    for node in ("phase", "phasempf", "mcra"):
        y_node, node_launches[node] = phase(node, phase_phase_node, node, x,
                                            xsrc)
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                         dir=ROOT) as tmp:
            phase(f"{node}_streaming", phase_streaming, x, y_node, tmp, node,
                  preset(node))
            phase(f"{node}_cli", phase_cli, x, tmp, node, preset(node),
                  ["--stream", "64"], seconds=4.0)
        phase(f"{node}_xrt", phase_xrt, x, card, node, preset(node), "noise")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        gsc_outs, gsc_launches = phase("gsc", phase_gsc, x, xs, tmp,
                                       gsc_refs)
        gsc_preset = preset("gsc", write_mu=False)
        block_preset = preset("gsc", write_mu=False, solver="block")
        phase("gsc_streaming", phase_streaming, x,
              gsc_outs[("noise", "sample")], tmp, "gsc", gsc_preset, tol=0.0)
        phase("gsc_streaming", phase_streaming, x,
              gsc_outs[("noise", "block")], tmp, "gsc", block_preset,
              tol=0.0)
        phase("gsc_cli", phase_cli, x, tmp, "gsc", block_preset,
              ["--stream", "64", "--param", "write_mu=false", "--param",
               "solver=block"], seconds=4.0, tol=0.0)
        # the CLI runs the preset, write_mu on: its trace to --mu-file
        mu_file = os.path.join(tmp, "cli_mu.txt")
        phase("gsc_cli", phase_cli, x, tmp, "gsc", gsc_preset,
              ["--stream", "64", "--mu-file", mu_file], seconds=4.0, tol=0.0)
        with open(mu_file) as f:
            lines = len(f.read().split())
        log(f"gsc cli mu trace: {lines} lines (3 chunks of 64 hops)")
        if lines != 192:
            raise AssertionError(f"gsc cli mu trace {lines} lines")
    # a GSC call takes ~0.3-0.6 s: fewer runs than the other nodes'
    phase("gsc_xrt", phase_xrt, x, card, "gsc", gsc_preset, "noise, sample",
          reps=3, warmups=1)
    phase("gsc_xrt", phase_xrt, x, card, "gsc",
          preset("gsc", write_mu=False, solver="blocklms"),
          "noise, blocklms l=128", reps=3, warmups=1)
    phase("gsc_xrt", phase_xrt, x, card, "gsc", block_preset, "noise, block",
          reps=3, warmups=1)
    for node in ("ref", "read"):
        y_node, _ = phase(node, phase_refread, node, x)
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                         dir=ROOT) as tmp:
            phase(f"{node}_streaming", phase_streaming, x, y_node, tmp, node,
                  tol=0.0)
            phase(f"{node}_cli", phase_cli, x, tmp, node, None,
                  ["--stream", "64"], seconds=4.0, tol=0.0)
        phase(f"{node}_xrt", phase_xrt, x, card, node, None, "noise")
    phase("das_vs_ref", phase_das_vs_ref, xsrc)
    phase("batch", phase_batch, card, refs_batch)
    phase("live", phase_live, card, pool, x)
    phase("parallel", phase_parallel, card)

    launches = {"wola_analysis": das_launches["wola_analysis"],
                "wola_synthesis": das_launches["wola_synthesis"],
                "mvdr_stream": mvdr_launches["auto"]["mvdr_stream"],
                "gj_inverse": mvdr_launches["dense"]["gj_inverse"],
                "lcmv_stream": lcmv_launches["auto"]["lcmv_stream"],
                "mega_stream": mega_launches["mega_stream"],
                "gss_stream": gss_launches["gss_stream"],
                **{k: node_launches[node][k]
                   for node, k in PHASE_KERNEL.items()},
                "gsc_sample": gsc_launches["sample"]["gsc_sample"],
                "gsc_xmu": gsc_launches["xmu"]["gsc_xmu"],
                "gsc_blocklms": gsc_launches["blocklms128"]["gsc_blocklms"],
                "gsc_block": gsc_launches["block"]["gsc_block"]}
    csrc = "beamform_tpu_torch/csrc/"
    meta = {"wola_analysis": ("wola.cu",
                              "beamform_tpu/kernels/wola_pallas.py:120"),
            "wola_synthesis": ("wola.cu",
                               "beamform_tpu/kernels/wola_pallas.py:280"),
            "mvdr_stream": ("mvdr_stream.cu",
                            "beamform_tpu/kernels/mvdr_stream.py:209"),
            "gj_inverse": ("linalg.cu", "beamform_tpu/kernels/linalg.py:70"),
            "lcmv_stream": ("lcmv_stream.cuh",
                            "beamform_tpu/kernels/lcmv_stream.py:151"),
            "mega_stream": ("mega_stream.cuh",
                            "beamform_tpu/kernels/mega_stream.py:230"),
            "gss_stream": ("gss_stream.cu",
                           "beamform_tpu/kernels/gss_stream.py:64"),
            "phase_mask": ("phase_mask.cu",
                           "beamform_tpu/kernels/phase_mask.py:111"),
            "mpf_march": ("phase_mask.cu",
                          "beamform_tpu/kernels/phase_mask.py:190"),
            # no Pallas kernel: the MCRA node's lax.scan
            "mcra_march": ("phase_mask.cu", "beamform_tpu/models/mcra.py:124"),
            "gsc_sample": ("gsc_sample.cu",
                           "beamform_tpu/kernels/gsc_pallas.py:37"),
            "gsc_xmu": ("gsc_sample.cu",
                        "beamform_tpu/kernels/gsc_pallas.py:193"),
            "gsc_blocklms": ("gsc_blocklms.cu",
                             "beamform_tpu/kernels/gsc_blocklms.py:135"),
            "gsc_block": ("gsc_block.cu",
                          "beamform_tpu/kernels/gsc_block.py:75")}
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": csrc + meta[k][0],
         "replaces": meta[k][1], "launches": launches[k],
         **{key: kern[k][key] for key in KERNEL_KEYS}}
        for k in meta]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
