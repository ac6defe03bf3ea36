"""Generalized sidelobe canceller with dynamic adaptation rate.

Reference: gsc.cpp, two stages:

1. per-mic phase alignment in the frequency domain through the by-mic WOLA
   path (gsc.cpp:54-75, do_overlap_bymic at util.h:353-379): each mic's
   spectrum times conj(w_mic), resynthesised per mic;
2. a per-sample time-domain adaptive stage (gsc.cpp:120-179): fixed beam =
   mic mean, blocking matrix = adjacent-mic differences (M-1 channels), an
   FIR bank of ``filter_size`` taps with LMS updates g += mu e u, the
   dynamic mu and its NaN/Inf scrub (gsc.cpp:146-168), an optional VAD gate
   on the output power (gsc.cpp:146).

Counterpart of ``beamform_tpu/models/gsc.py``. Stage 1 is the WOLA
analysis kernel, the conjugate steering and the synthesis kernel over the
mic channels in one launch. Stage 2 follows the solver
(:meth:`GscModel._strategy`): ``sample`` the per-sample kernel of
``kernels/gsc.py``, ``xmu`` its xmu mode, ``blocklms`` the block-LMS kernel
of ``kernels/gsc_blocklms.py``, ``block`` the lookahead-8 kernel of
``kernels/gsc_block.py``; on the CPU the per-sample recurrence in float32
or float64 for any tap count (``sample``, ``xmu`` and ``block``, as the
JAX package runs ``block`` off the TPU) and the block scan (``blocklms``).
``write_mu`` always runs the per-sample recurrence and appends the
reference's mean-mu trace (gsc.cpp:181-184) to ``mu_file_path``.

Streaming state: ``(WolaCarry(tail (M, hop), out_prev (M, hop)),
GscState)``, the JAX package's leaves in its order, so ``.npz`` checkpoints
move between the packages.

The model's one forward (:meth:`GscModel.batched_forward`, JAX
``gsc.py:248-340``; a single stream is a batch of one) runs stage 1 on the
flattened (B, M) channels, one analysis and one synthesis launch, and the
adaptive stage on the B streams in one launch of its kernel; only a single
stream's ``process_chunk`` writes the mu trace.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from beamform_tpu_torch.config import EngineConfig, GscParams
from beamform_tpu_torch.geometry import ArrayGeometry
from beamform_tpu_torch.kernels.gsc import K as KERNEL_TAPS
from beamform_tpu_torch.kernels.gsc import TILE, gsc_sample, gsc_xmu
from beamform_tpu_torch.kernels.gsc_block import gsc_block
from beamform_tpu_torch.kernels.gsc_blocklms import block_len, gsc_blocklms
from beamform_tpu_torch.models import common
from beamform_tpu_torch.models.batching import BatchableModel
from beamform_tpu_torch.utils.profiling import span

SOLVERS = ("sample", "xmu", "blocklms", "block")


class GscState(NamedTuple):
    block: torch.Tensor      # (M-1, K) blocking-matrix registers
    filt: torch.Tensor       # (M-1, K) adaptive filters
    last_out: torch.Tensor   # (K,) recent outputs
    # the block kernels (solver="block") take the window-pair Grams at lags
    # 0..7 and the 8 samples before the registers; every path refreshes
    # them (gram_refresh, or the block kernel itself), so a checkpoint of
    # any solver resumes on that one
    gram: torch.Tensor       # (M-1, 8)
    uold: torch.Tensor       # (M-1, 8)


def gram_refresh(block_in, uold_in, u_new, k: int):
    """The block kernel's lookahead state from the u stream: ``block_in``
    and ``uold_in`` are the registers and the 8 samples before them ahead
    of the chunk, ``u_new`` (..., C, S) the chunk's blocking-matrix
    samples. Returns (gram (..., C, 8): gram[l] = <b(t-1-l), b(t-1)> over
    K-tap windows, uold (..., C, 8))."""
    ext = torch.cat([uold_in, block_in, u_new[..., -(k + 8):]],
                    dim=-1)[..., -(k + 8):]
    base = ext[..., 8:]
    gram = torch.stack([(ext[..., 8 - l:8 - l + k] * base).sum(dim=-1)
                        for l in range(8)], dim=-1)
    return gram, ext[..., :8].clone()


def gsc_init_state(num_mics: int, filter_size: int, rdtype,
                   device=None) -> GscState:
    c = num_mics - 1
    return GscState(*(torch.zeros(shape, dtype=rdtype, device=device)
                      for shape in ((c, filter_size), (c, filter_size),
                                    (filter_size,), (c, 8), (c, 8))))


def gsc_sample_step(state: GscState, a_t, p: GscParams,
                    with_mu: bool = False):
    """One sample of the adaptive stage, ``a_t`` (M,) aligned samples, as
    the JAX package writes it (gsc.py:82-118): the squared-domain gate,
    one rsqrt, the ``mu_raw < inf`` scrub, the per-tap NaN scrub and the
    VAD gate. With ``with_mu`` also (mu of channel 0, update flag)."""
    k = state.block.shape[-1]
    kinv = 1.0 / k
    das = a_t.mean()
    u_new = a_t[1:] - a_t[:-1]
    block = torch.cat([state.block[:, 1:], u_new[:, None]], dim=1)
    out = das - (state.filt * block).sum(dim=1).sum()
    last_out = torch.cat([state.last_out[1:], out[None]])
    osq = (last_out ** 2).sum()
    bsq = (block ** 2).sum(dim=1)
    cond = (p.mu0 * p.mu0) * bsq < (p.mu_max * p.mu_max) * osq
    den = torch.where(cond, osq, bsq) * kinv
    mu_raw = p.mu0 * torch.rsqrt(den)
    mu = torch.where(mu_raw < torch.inf, mu_raw, 0.0)
    filt = state.filt + mu[:, None] * out * block
    filt = torch.where(torch.isnan(filt), 0.0, filt)
    upd = torch.tensor(True)
    if p.use_vad:
        upd = torch.sqrt(osq * kinv) < p.vad_threshold
        filt = torch.where(upd, filt, state.filt)
    st = GscState(block, filt, last_out, state.gram, state.uold)
    return (st, (out, mu[0], upd)) if with_mu else (st, out)


class GscModel(BatchableModel, nn.Module):
    name = "gsc"
    collapse_constant_steering = True

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: GscParams = GscParams(), device="cuda"):
        super().__init__()
        if params.solver not in SOLVERS:
            raise ValueError(f"unknown GSC solver {params.solver!r}; one of "
                             f"{', '.join(SOLVERS)}")
        if params.solver == "blocklms":
            block_len(params)
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        self.register_buffer(
            "window", common.make_window(engine, self.rdtype).to(device))
        self.register_buffer(
            "freqs", torch.as_tensor(common.make_freqs_ext(engine),
                                     device=device))
        # where write_mu appends its trace (None: ~/mu_behavior.txt, the
        # reference's file)
        self.mu_file_path = None

    @property
    def device(self) -> torch.device:
        return self.window.device

    def stream_init(self):
        m = self.geom.num_mics
        return (common.wola_carry_init(self.engine, m, self.rdtype,
                                       self.device, per_mic_out=True),
                gsc_init_state(m, self.params.filter_size, self.rdtype,
                               self.device))

    def _strategy(self, num_samples: int) -> str:
        """The adaptive stage's route: "sample", "xmu", "blocklms" or
        "block" (the kernels on CUDA, plain versions on the CPU). On CUDA
        the kernels take float32 and 128 taps and anything else raises (the
        plain per-sample loop would take minutes there); ``write_mu``
        always runs the per-sample recurrence, emitting the trace. On the
        CPU "blocklms" runs the block scan when the chunk holds whole
        blocks of 128 taps without ``write_mu``, and every other case
        ("block" included) the per-sample recurrence, as the JAX package
        does off the TPU."""
        p = self.params
        if self.device.type == "cuda":
            if self.rdtype != torch.float32:
                raise ValueError("GSC on CUDA is a float32 strategy; run "
                                 "float64 on the CPU")
            if p.filter_size != KERNEL_TAPS:
                raise ValueError(f"the CUDA GSC kernels take filter_size "
                                 f"{KERNEL_TAPS}, got {p.filter_size}; the "
                                 "CPU runs any size")
            if num_samples % TILE:
                raise ValueError(f"the CUDA GSC kernels take chunks of a "
                                 f"multiple of {TILE} samples, got "
                                 f"{num_samples} (window_size)")
            if p.write_mu:
                return "sample"
            if p.solver == "blocklms" and num_samples % block_len(p):
                raise ValueError(f"solver='blocklms' on CUDA takes chunks "
                                 f"of a multiple of block_samples="
                                 f"{block_len(p)} samples, got {num_samples}")
            return p.solver
        if (p.solver == "blocklms" and not p.write_mu
                and p.filter_size == KERNEL_TAPS
                and num_samples % block_len(p) == 0):
            return "blocklms"
        return "sample"

    def _adaptive(self, aligned, gs: GscState, with_mu: bool):
        """Stage 2 on B streams in one launch: aligned (B, M, S), state
        leaves with a leading B -> ((B, S) output, new state, stream 0's mu
        trace when ``with_mu`` and the route is the per-sample one, else
        None)."""
        strategy = self._strategy(aligned.shape[-1])
        args = (aligned, gs.block, gs.filt, gs.last_out, self.params)
        trace = None
        if strategy == "block":
            out, blk, flt, lo, gram, uold = gsc_block(
                *args[:4], gs.gram, gs.uold, self.params)
            return out, GscState(blk, flt, lo, gram, uold), None
        if strategy == "blocklms":
            out, blk, flt, lo = gsc_blocklms(*args)
        elif strategy == "xmu":
            out, blk, flt, lo = gsc_xmu(*args)
        elif with_mu:
            out, blk, flt, lo, (mu0, upd) = gsc_sample(*args, with_mu=True)
            trace = (mu0[0], upd[0])
        else:
            out, blk, flt, lo = gsc_sample(*args)
        k = self.params.filter_size
        with span("bf.gsc.lookahead"):
            tail = aligned[..., -(k + 9):]
            gram, uold = gram_refresh(gs.block, gs.uold,
                                      tail[..., 1:, :] - tail[..., :-1, :],
                                      k)
        return out, GscState(blk, flt, lo, gram, uold), trace

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state, with_mu: bool = False):
        """x (B, M, T*hop), (unique thetas (U,), index (B, T) or (B, 1)),
        state leaves with a leading B -> ((B, T*hop) output, new state).
        Stage 1 on the B*M channels in one analysis and one synthesis
        launch, steered per (stream, frame); stage 2 in one launch of the
        solver's kernel (JAX ``gsc.py:_forward_batched``). ``with_mu``
        (a single stream's ``write_mu``) appends stream 0's mu trace to
        ``mu_file_path``."""
        thetas, idx = ctrl
        carry, gs = state
        b, m, s = x.shape
        hop = self.engine.hop
        t = s // hop
        if t == 0:
            return x.new_zeros((b, 0)), state
        with span("bf.steering"):
            w_conj = common.weights_for_thetas(
                self.geom, self.freqs, thetas, self.rdtype,
                self.cdtype).conj().resolve_conj()
        spec, _, tail = common.stft_streams_carry(
            x, self.engine, self.window, self.cdtype, carry.tail)
        with span("bf.gsc.align"):
            aligned_spec = (spec.movedim(0, 1) * w_conj[idx]).movedim(1, 2)
            aligned_spec = aligned_spec.reshape(b * m, t, -1)
        streams, prev = common.istft_channels_carry(
            aligned_spec, self.engine, self.window,
            carry.out_prev.reshape(b * m, hop))
        out, gs, trace = self._adaptive(streams.reshape(b, m, -1), gs,
                                        with_mu)
        if trace is not None:
            self._write_mu_trace(trace[0].cpu().numpy(),
                                 trace[1].cpu().numpy())
        return out, (common.WolaCarry(tail, prev.reshape(b, m, hop)), gs)

    @torch.no_grad()
    def process_chunk(self, x_chunk, theta, state, interference=None):
        """The shared streaming step (a batch of one), with ``write_mu``'s
        trace (gsc.cpp:181-184)."""
        return super().process_chunk(x_chunk, theta, state, interference,
                                     with_mu=self.params.write_mu)

    def _write_mu_trace(self, mu0, upd):
        """The per-callback mean-mu log (gsc.cpp:146-184): mu of the first
        blocking channel accumulates over each hop's updated samples; a
        VAD-gated sample overwrites the running sum with the previous
        hop's value. Appends one line per hop to ``mu_file_path``. The sums
        run in float64 in sample order, as the JAX package's loop."""
        hop = self.engine.hop
        path = self.mu_file_path or os.path.expanduser("~/mu_behavior.txt")
        last_avg = getattr(self, "_last_avg_mu", 0.0)
        mu0 = np.asarray(mu0, np.float64)
        lines = []
        for f in range(len(mu0) // hop):
            seg = mu0[f * hop:(f + 1) * hop]
            gated = np.nonzero(~np.asarray(upd[f * hop:(f + 1) * hop]))[0]
            start = int(gated[-1]) + 1 if len(gated) else 0
            base = last_avg if len(gated) else 0.0
            avg = float(np.cumsum(np.concatenate([[base], seg[start:]]))[-1])
            lines.append(f"{avg / hop:f}\n")
            last_avg = avg
        self._last_avg_mu = last_avg
        mode = "a" if getattr(self, "_mu_file_started", False) else "w"
        with open(path, mode) as fh:
            fh.writelines(lines)
        self._mu_file_started = True
