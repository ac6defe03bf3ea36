"""Online Geometric Source Separation (Valin 2007, ODAS-style).

Reference: gss.cpp — steering matrix A(f) built like LCMV's constraints
(gss.cpp:51-94), demixing matrix W(f) initialised to A(f)^H (gss.cpp:92-93);
per gated bin: y = W x, output source 0 (gss.cpp:120-121); natural-gradient
update (gss.cpp:124-136):

    E   = y y^H with zeroed diagonal
    a   = ||x||^4
    dJ1 = 4 S (1/a) (E y) x^H
    dJ2 = 2 (1/S) ((W A) - I) A^H
    W  <- (1 - lambda mu) W - mu (dJ1 + dJ2)

The band gate zeroes the bin (bin 0 included: gss.cpp's bin loop has no DC
special case); energy-gate failure passes 0.01*X0 through and skips the
update. ``out_amp`` gain on the output stream.

Counterpart of ``beamform_tpu/models/gss.py``. The interference set follows
a fixed-capacity masked timeline (``runtime/timeline.py``), as for LCMV;
the demixing state keeps every slot of the capacity (inactive slots are
zero rows), so checkpoints move between the two packages. Any theta change
or interference event resets W to A^H. Strategies (:meth:`GssModel.
_strategy`): ``mega``, the fused audio-to-audio kernel
(``kernels/gss_stream.py``: the CUDA kernel, or its plain version on the
CPU), and ``scan``, the per-frame march around the WOLA path, on the CPU.
Streaming state is ``(WolaCarry, W (NIB, S, M) complex, prev_theta)``,
prev_theta a 0-d float that starts as NaN, so the first frame resets W.

The model's one forward (:meth:`GssModel.batched_forward`; a single
stream is a batch of one): the B streams share the control rows (one
static interference set, or a single stream's replayed timeline) and the
timeline's reset flags; each has its row index, its resets on a theta
change and its state. On CUDA one launch of the fused kernel serves them
all; the CPU's ``scan`` marches each stream in turn.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from beamform_tpu_torch.config import EngineConfig, GssParams
from beamform_tpu_torch.geometry import ArrayGeometry
# gss_update is part of this module's surface; it lives with the fused
# kernel, whose plain version needs it too
from beamform_tpu_torch.kernels.gss_stream import (active_bits, gss_fits,
                                                   gss_march, gss_mega,
                                                   gss_update)
from beamform_tpu_torch.models import common
from beamform_tpu_torch.models.batching import BatchableConstrainedModel
from beamform_tpu_torch.models.lcmv import build_constraints_masked
from beamform_tpu_torch.utils.profiling import span

__all__ = ["GssModel", "gss_update"]

SOLVERS = ("auto", "mega", "scan")


class GssModel(BatchableConstrainedModel, nn.Module):
    name = "gss"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: GssParams = GssParams(), interference_angles=(),
                 capacity: int | None = None, device="cuda"):
        """``capacity``: interference-slot capacity of the demixing state
        (the fixed-shape replacement for the reference's reallocation,
        gss.cpp:241-286). Defaults to len(interference_angles); sessions
        replaying event timelines that add interferences need the
        timeline's capacity, set before ``stream_init``."""
        super().__init__()
        self.engine, self.geom, self.params = engine, geom, params
        self.interf = tuple(interference_angles)
        self.capacity = (len(self.interf) if capacity is None
                         else int(capacity))
        if self.capacity < len(self.interf):
            raise ValueError(f"capacity {self.capacity} holds fewer than the "
                             f"{len(self.interf)} interference angles")
        if params.solver not in SOLVERS:
            raise ValueError(f"unknown GSS solver {params.solver!r}; one of "
                             f"{', '.join(SOLVERS)}")
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        freqs = common.make_freqs_ext(engine)
        self.register_buffer(
            "window", common.make_window(engine, self.rdtype).to(device))
        self.register_buffer("freqs", torch.as_tensor(freqs, device=device))
        mask = ((np.abs(freqs) >= params.freq_min)
                & (np.abs(freqs) <= params.freq_max))
        self.ib_host = np.nonzero(mask)[0]
        self.register_buffer("ib", torch.as_tensor(self.ib_host,
                                                   device=device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.window.device

    def stream_init(self, capacity: int | None = None):
        """Zero demixing state and prev_theta = NaN: the first frame always
        resets W to A^H (the reference's startup init, gss.cpp:92-93)."""
        s = (self.capacity if capacity is None else int(capacity)) + 1
        m = self.geom.num_mics
        return (common.wola_carry_init(self.engine, m, self.rdtype,
                                       self.device),
                torch.zeros((len(self.ib_host), s, m), dtype=self.cdtype,
                            device=self.device),
                torch.tensor(float("nan"), dtype=self.rdtype,
                             device=self.device))

    def _strategy(self, s_cap: int) -> str:
        """"mega" or "scan". On CUDA only the fused kernel runs, in float32
        within ``gss_fits``, and anything else raises (there is no plain
        march on the card). On the CPU, "auto" and "scan" run the plain
        march in float32 or float64 and "mega" the fused kernel's plain
        version, which needs a band in [bin 1, nfft/2)."""
        solver = self.params.solver
        m, nfft = self.geom.num_mics, self.engine.fft_win
        fits = gss_fits(m, self.ib_host, nfft, s_cap)
        lo, hi = ((int(self.ib_host.min()), int(self.ib_host.max()))
                  if len(self.ib_host) else (0, -1))
        why = (f"{m} mics x {s_cap} source slots, band bins {lo}..{hi} of "
               f"nfft {nfft}; the fused kernel takes M <= 32, S <= 16 and "
               "a band without bin 0 and the Nyquist bin")
        if self.device.type == "cuda":
            if solver == "scan":
                raise ValueError("solver='scan' runs on the CPU only; on "
                                 "CUDA GSS runs the fused kernel")
            if self.cdtype != torch.complex64:
                raise ValueError("GSS on CUDA is a float32 strategy; run "
                                 "float64 on the CPU")
            if not fits:
                raise ValueError(f"the fused GSS kernel cannot take this "
                                 f"configuration ({why}) — run on the CPU")
            return "mega"
        if solver == "mega":
            if not fits:
                raise ValueError(f"solver='mega' exceeds the fused GSS "
                                 f"kernel's capacity ({why}) — use "
                                 "solver='scan'")
            return "mega"
        return "scan"

    def _control_tensors(self, u_theta, u_angles, u_active, u_row0):
        """The unique control rows -> (A^H in the kernel's layout (U, S, M,
        NIB), active slots (U, S) 0/1, theta (U,), the active slots as the
        fused kernel's bits (U,) int32), built once per control key (the
        span ``bf.steering``)."""
        with span("bf.steering"):
            a = build_constraints_masked(
                self.geom, self.freqs, u_theta, u_angles, u_active, u_row0,
                self.rdtype, self.cdtype, self.ib)      # (U, NIB, M, S)
            act = torch.cat([torch.ones_like(u_theta[:, None]), u_active],
                            dim=1)
            ah = a.conj().permute(0, 3, 2, 1).contiguous().resolve_conj()
            return ah, act, u_theta, active_bits(act)

    def _resets(self, u_theta, idx, reset_extra, prev_theta):
        """Per-frame resets (..., T): any theta change or interference
        event resets W to A^H (update_weights, gss.cpp:90-93), carried
        across chunks by prev_theta (...); also each frame's theta."""
        th_val = u_theta[idx]
        th_prev = torch.cat([prev_theta[..., None], th_val[..., :-1]], -1)
        return (th_val != th_prev) | reset_extra, th_val

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state):
        """x (B, M, T*hop), the controls of :meth:`batch_controls`, state
        with a leading B -> ((B, T*hop) output, new state). On CUDA the
        fused kernel serves the B streams in one launch; the CPU's scan
        marches them in turn, as the kernel's plain version does."""
        (ah, act, u_theta, act_bits), idx, reset_extra = ctrl
        p = self.params
        carry, w0, prev_theta = state
        if idx.shape[1] == 0:                # no whole hop: nothing to march
            return x.new_zeros((x.shape[0], 0)), state
        if w0.shape[-2] != ah.shape[1]:
            raise ValueError(
                f"demixing state holds {w0.shape[-2]} source slots but the "
                f"controls have {ah.shape[1]}")
        reset, th_val = self._resets(u_theta, idx, reset_extra, prev_theta)
        if self._strategy(ah.shape[1]) == "mega":
            audio, w_new, prev = gss_mega(
                x, carry.tail, carry.out_prev, w0, ah, idx, reset, self.ib,
                self.engine.fft_win, p.freq_mag_threshold, p.mu, p.lam,
                act_bits)
            tail = x[..., -self.engine.hop:].contiguous()
        else:
            spec, mag, tail = common.stft_streams_carry(
                x, self.engine, self.window, self.cdtype, carry.tail,
                with_mag=True)
            t, b, _, nb = spec.shape
            x_ib = spec.index_select(3, self.ib)         # (T, B, M, NIB)
            gate = mag.index_select(2, self.ib) > p.freq_mag_threshold
            a_h = ah.permute(0, 3, 1, 2)
            marched = [gss_march(x_ib[:, i], gate[:, i], w0[i], a_h, act,
                                 idx[i], reset[i], p.mu, p.lam)
                       for i in range(b)]
            w_new = torch.stack([w for _, w in marched])
            y = torch.zeros((b, t, nb), dtype=self.cdtype,
                            device=spec.device)
            y.index_copy_(2, self.ib, torch.stack([y_ib for y_ib, _ in
                                                   marched]))
            audio, prev = common.istft_channels_carry(
                y, self.engine, self.window, carry.out_prev)
        return (audio * p.out_amp,
                (common.WolaCarry(tail, prev), w_new, th_val[:, -1]))

    @torch.no_grad()
    def process_chunk(self, x_chunk, theta, state, interference=None):
        """The shared streaming step (a batch of one), once the state holds
        the controls' source slots. ``interference``: optional
        InterferenceTimeline rows for this chunk (the /theta_interference
        replacement, gss.cpp:288-339), of the state's capacity."""
        cap = (self.capacity if interference is None
               else interference.capacity)
        if state[1].shape[-2] != cap + 1:
            raise ValueError(
                f"demixing state holds {state[1].shape[-2]} source slots but "
                f"the interference timeline has capacity {cap}; build the "
                "model with capacity=timeline.capacity (or size stream_init "
                "with the same capacity)")
        return super().process_chunk(x_chunk, theta, state, interference)
