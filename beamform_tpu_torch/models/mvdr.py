"""MVDR beamformer with band/energy-gated frequency subset.

Reference: mvdr.cpp — per bin, sample covariance R from the last
``past_windows`` FFTs with 1.001 multiplicative diagonal loading
(R = (P P^H) .* whiteR, mvdr.cpp:87, 239-243), distortionless weights
w = R^-1 d / (d^H R^-1 d) (mvdr.cpp:88-94), band gate ``freq_min..freq_max``
(else output 0), energy gate ``freq_mag_threshold`` on the mic-mean |X|
(else passthrough 0.01 * X0), ``out_amp`` gain on the processed window
(mvdr.cpp:112-114). The FFT history shifts every frame for in-band bins
regardless of the energy gate (mvdr.cpp:100-101).

Counterpart of ``beamform_tpu/models/mvdr.py`` with three solver
strategies (:func:`select_solver_strategy`):

* ``stream``: WOLA analysis with the gate statistic, the streaming solve
  (``kernels/mvdr_stream.py``: the CUDA kernel, or its plain version on the
  CPU), WOLA synthesis. The CUDA float32 production path (``auto``).
* ``mega``: the whole audio-to-audio step in one fused kernel
  (``kernels/mega_stream.py``: analysis, gate, unrefined solve,
  half-spectrum synthesis; the CUDA kernel, or its plain version on the
  CPU), for bands below the Nyquist bin.
* ``dense``: the JAX package's block pipeline: outer products and the
  banded window sum as ``torch.einsum`` (the JAX package leaves them to
  XLA), a batched Gauss-Jordan inverse (``kernels/linalg.py``: the CUDA
  kernel, or the plain version on the CPU) refined at the right-hand side.

Streaming state is ``(WolaCarry, hist)``: hist is the (W, M, NIB) complex
history of in-band spectra, as in the JAX package, so checkpoints move
between the two. Singular cold-start covariances give non-finite weights,
like the reference; parity scenes keep the first W hops below the gate.

The model's one forward (:meth:`MvdrModel.batched_forward`; a single
stream is a batch of one) serves B streams with one stream's launches.
``stream`` and ``mega`` launch each kernel once (the analysis of the B*M
channels with each stream's gate statistic, the stream solve, the
synthesis of the B outputs; or the fused kernel). ``dense`` runs the block
pipeline over a leading stream axis: one Gauss-Jordan launch a block for
the B streams. :meth:`MvdrModel.stream_solve` hands the stream kernel's
solve of a bin group to ``parallel/sharded.py``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from beamform_tpu_torch.config import EngineConfig, MvdrParams
from beamform_tpu_torch.geometry import ArrayGeometry
from beamform_tpu_torch.kernels.linalg import MAX_M, gj_inverse
from beamform_tpu_torch.kernels.mega_stream import (band_fits, mega_fits,
                                                    mvdr_mega)
# white_r is part of this module's surface; it lives with the streaming
# solve, whose plain version needs it too
from beamform_tpu_torch.kernels.mvdr_stream import (MAX_MICS, MAX_SLOTS,
                                                    mvdr_stream, stream_fits,
                                                    white_r)
from beamform_tpu_torch.models import common
from beamform_tpu_torch.models.batching import BatchableModel
from beamform_tpu_torch.utils.profiling import span

SOLVERS = ("auto", "stream", "dense", "sparse", "mega")


def select_solver_strategy(solver: str, cdtype, m: int, w_hist: int,
                           device: torch.device, s_cap: int = 0, ib=None,
                           nfft: int = 0) -> str:
    """MVDR/LCMV solver policy: "stream", "mega" or "dense".

    ``s_cap`` is 0 for MVDR and LCMV's constraint slot count S (the look
    direction plus the interference slots some row of the chunk uses);
    ``ib`` (host array) and ``nfft`` are the band and FFT length, which
    "mega" needs. "auto" runs the streaming solve kernel on a CUDA float32
    engine within its capacity (``kernels/mvdr_stream.stream_fits``:
    M <= 32, S <= 16 and the staged tile within shared memory: at 16
    mics W <= 162 for MVDR, W <= 158 for LCMV at one slot), and
    "dense" everywhere else; it does not pick "mega" until the two kernels
    have been timed against each other. "stream" on CUDA runs the kernel or
    raises past its capacity; on the CPU it runs the plain version in
    float32 or float64. "mega" refuses a band that reaches the Nyquist bin
    (``kernels/mega_stream.band_fits``) on every device; on CUDA it runs
    the fused kernel in float32 within ``mega_fits`` and raises otherwise;
    on the CPU it runs the plain version in float32 or float64. "dense"
    runs the Gauss-Jordan kernel for a CUDA tensor and the plain inverse
    on the CPU. On CUDA the kernels take at most 32 mics, so more raise
    whatever the solver; "dense" covers a ``past_windows`` past the stream
    tile and LCMV's S past 16. Legacy "sparse" with float64 maps to
    "dense" with a deprecation warning (with float32 it is "stream"), as in
    the JAX package. float64 on CUDA raises in the kernels.
    """
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of "
                         f"{', '.join(SOLVERS)}")
    if solver == "sparse" and cdtype != torch.complex64:
        warnings.warn(
            "solver='sparse' with float64 is deprecated: the gated-sparse "
            "path was replaced by the float32 stream kernel; running the "
            "dense solver", DeprecationWarning, stacklevel=3)
        return "dense"
    cuda = torch.device(device).type == "cuda"
    if cuda and m > MAX_M:
        raise ValueError(
            f"{m} mics exceed the capacity of the CUDA MVDR/LCMV kernels "
            f"(M <= {MAX_M} for both the stream and the Gauss-Jordan "
            "kernel) — run on the CPU")
    if solver == "mega":
        if ib is None or not band_fits(ib, nfft):
            raise ValueError(
                "solver='mega' takes bands in [bin 1, nfft/2): its "
                "half-spectrum synthesis would double the Nyquist bin and "
                "the shadow bin (kernels/mega_stream.band_fits) — use "
                "solver='stream' or 'dense'")
        if cuda and cdtype != torch.complex64:
            raise ValueError("the mega solver is a float32 strategy on "
                             "CUDA; use solver='dense' with float64, or the "
                             "CPU")
        if cuda and not mega_fits(m, ib, nfft, s_cap, w_hist):
            raise ValueError(
                f"solver='mega' exceeds the CUDA fused kernel's capacity "
                f"({m} mics, past_windows {w_hist}, {s_cap} constraint "
                f"slots, nfft {nfft}; see kernels/mega_stream.mega_fits) — "
                "use solver='stream' or 'dense'")
        return "mega"
    if solver in ("stream", "sparse"):
        if cuda and not stream_fits(m, w_hist, s_cap):
            slots = f", {s_cap} constraint slots" if s_cap else ""
            raise ValueError(
                f"solver='stream' exceeds the CUDA kernel's capacity ({m} "
                f"mics, past_windows {w_hist}{slots}; M <= {MAX_MICS}, S <= "
                f"{MAX_SLOTS}, see kernels/mvdr_stream.stream_fits) — use "
                "solver='dense'")
        return "stream"
    if solver == "dense":
        return "dense"
    return ("stream" if cuda and cdtype == torch.complex64
            and stream_fits(m, w_hist, s_cap) else "dense")


def batched_inv(a: torch.Tensor, polish: bool = True) -> torch.Tensor:
    """Batched complex inverse of (..., M, M) (replaces Eigen .inverse()):
    the Gauss-Jordan kernel for a CUDA tensor, the plain version on the
    CPU. ``polish=False`` leaves the refinement to the caller
    (:func:`mvdr_solve`)."""
    m = a.shape[-1]
    return gj_inverse(a.reshape(-1, m, m).contiguous(),
                      polish=polish).reshape(a.shape)


def stream_matmul(a: torch.Tensor, b: torch.Tensor,
                  streams: bool = False) -> torch.Tensor:
    """a @ b for the solves' small matrices. ``streams``: a and b lead with
    a stream axis, and each stream's product is a call of its own. On the
    card a batched product's kernel, so its rounding, depends on how many
    matrices the call takes: one call for B streams would not equal each
    stream's own, and the ill-conditioned covariances amplify the last
    bits (to ~1e-4 of a stream's peak at 16 mics and W = 10 on an NVIDIA
    H100 80GB HBM3, 700 W). Elementwise products summed over an axis are
    bit for bit too, but took twice as long there at M x 1."""
    if streams:
        return torch.stack([x @ y for x, y in zip(a, b)])
    return a @ b


def mvdr_solve(r: torch.Tensor, d: torch.Tensor,
               streams: bool = False) -> torch.Tensor:
    """w = R^-1 d / (d^H R^-1 d) per bin; r (..., M, M), d (..., M).

    The unpolished Gauss-Jordan inverse is refined on the right-hand side:
    one residual step reproduces the Newton-polished solution exactly.
    ``streams``: r and d lead with a stream axis; the inverse is one launch
    for every stream, the products :func:`stream_matmul`'s.
    """
    def mv(a, v):
        return stream_matmul(a, v[..., None], streams)[..., 0]

    inv = batched_inv(r, polish=False)
    x0 = mv(inv, d)
    resid = d - mv(r, x0)
    num = x0 + mv(inv, resid)
    den = (d.conj() * num).sum(-1)
    return num / den[..., None]


class MvdrModel(BatchableModel, nn.Module):
    name = "mvdr"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: MvdrParams = MvdrParams(), device="cuda"):
        super().__init__()
        self.engine, self.geom, self.params = engine, geom, params
        self.rdtype, self.cdtype = common.dtypes_of(engine)
        freqs = common.make_freqs_ext(engine)
        self.register_buffer(
            "window", common.make_window(engine, self.rdtype).to(device))
        self.register_buffer("freqs", torch.as_tensor(freqs, device=device))
        # in-band bin indices (not part of the state dict: derived from
        # params, like the JAX model's host constant ``ib``)
        ib = np.nonzero(common.band_mask(freqs, params.freq_min,
                                         params.freq_max))[0]
        self.register_buffer("ib", torch.as_tensor(ib, device=device),
                             persistent=False)
        self.ib_host = ib        # the solver policy reads it without a sync

    @property
    def device(self) -> torch.device:
        return self.window.device

    def stream_init(self):
        return (common.wola_carry_init(self.engine, self.geom.num_mics,
                                       self.rdtype, self.device),
                torch.zeros((self.params.past_windows, self.geom.num_mics,
                             len(self.ib)), dtype=self.cdtype,
                            device=self.device))

    def _block_frames(self, t: int) -> int:
        """Frames per dense covariance block, as the JAX model: the block's
        outer-product workspace (CB+W, NIB, M, M) complex stays ~128 MB."""
        m = self.geom.num_mics
        budget = 128e6 / (max(len(self.ib), 1) * m * m * 8)
        return max(8, min(128, int(budget) - self.params.past_windows, t))

    def _strategy(self, s_cap: int = 0) -> str:
        return select_solver_strategy(self.params.solver, self.cdtype,
                                      self.geom.num_mics,
                                      self.params.past_windows, self.device,
                                      s_cap=s_cap, ib=self.ib_host,
                                      nfft=self.engine.fft_win)

    def _steering_ib(self, thetas):
        """(U, M, NIB) steering of the unique thetas over the band (the
        span ``bf.steering``)."""
        with span("bf.steering"):
            w_uniq = common.weights_for_thetas(self.geom, self.freqs, thetas,
                                               self.rdtype, self.cdtype)
            return w_uniq.index_select(2, self.ib)

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state):
        """x (B, M, T*hop), (unique thetas (U,), index (B, T)), state with
        a leading B -> ((B, T*hop) output, new state): ``stream`` and
        ``mega`` in one launch of each kernel for the B streams, ``dense``
        in one Gauss-Jordan launch a block for the B streams."""
        thetas, idx = ctrl
        strategy = self._strategy()
        d_ib = self._steering_ib(thetas)
        if strategy == "mega":
            return self._forward_mega(mvdr_mega, x, d_ib, idx, state)

        def solve(spec, hist0, gate):
            if strategy == "stream":
                return mvdr_stream(spec, hist0, d_ib, idx, gate, self.ib)
            return self._solve_dense(
                spec.index_select(3, self.ib).movedim(0, 1), hist0, gate,
                lambda r, sl: mvdr_solve(
                    r, d_ib[idx[:, sl]].movedim(-2, -1), streams=True))

        return self.gated_forward(x, state, solve)

    def stream_solve(self, ctrl, sel, bins):
        """The stream kernel's solve on a bin group, for
        :meth:`gated_forward` with ``bins``: ``ctrl`` from
        :meth:`batch_controls`, ``sel`` the group's positions in the band
        and ``bins`` the spectrum bins they name -> ``solve(spec (T, B, M,
        NB), hist0 (B, W, M, G), gate (B, T, G)) -> (B, T, G)``, G =
        len(sel); None where no stream kernel carries the solve
        (``dense``). ``mega`` takes the stream kernel here, as in the JAX
        package (``mvdr.py:221-225``): the fused kernel analyses and
        synthesises every bin of a stream."""
        if self._strategy() not in ("stream", "mega"):
            return None
        thetas, idx = ctrl
        d_g = self._steering_ib(thetas).index_select(2, sel).contiguous()
        return lambda spec, hist0, gate: mvdr_stream(spec, hist0, d_g, idx,
                                                     gate, bins)

    def _forward_mega(self, fused, x, ctrl, idx, state):
        """The fused path (``fused`` is ``mvdr_mega`` or ``lcmv_mega``): raw
        audio in, beamformed audio out in one kernel launch, as
        ``beamform_tpu/models/mvdr.py:_forward_mega``; x (B, M, T*hop), idx
        (B, T), the state with a leading B. A chunk shorter than a hop
        marches nothing and keeps the carried tail."""
        p = self.params
        carry, hist0 = state
        audio, hist, prev = fused(
            x.contiguous(), carry.tail, carry.out_prev, hist0, ctrl, idx,
            self.ib, self.engine.fft_win, p.past_windows,
            p.freq_mag_threshold)
        tail = (carry.tail if x.shape[-1] < self.engine.hop
                else x[..., -self.engine.hop:].contiguous())
        return audio * p.out_amp, (common.WolaCarry(tail, prev), hist)

    def gated_forward(self, x, state, solve, bins=None):
        """The band-gated pipeline around a solve, on B streams: analysis
        of the B*M channels with each stream's gate statistic in one
        launch, ``solve(spec (T, B, M, NB), hist0 (B, W, M, NIB), gate (B,
        T, NIB)) -> (B, T, NIB)`` gated in-band output, the history update,
        bin 0 passed through, one synthesis launch of the B outputs. x (B,
        M, T*hop) -> ((B, T*hop) output, new state). ``bins`` (the band by
        default) are the bins the gate and the history hold: a bin group's
        under ``parallel/sharded.py``, whose ``solve`` still returns the
        whole band."""
        p = self.params
        carry, hist0 = state
        ib = self.ib if bins is None else bins
        spec, mag, tail = common.stft_streams_carry(
            x, self.engine, self.window, self.cdtype, carry.tail,
            with_mag=True)
        gate = (mag.index_select(2, ib)
                > p.freq_mag_threshold).transpose(0, 1).contiguous()
        y_ib = solve(spec, hist0, gate)
        # history: the last W in-band frames seen (mvdr.cpp:100-101)
        t, b, w = spec.shape[0], spec.shape[1], p.past_windows
        new = spec[max(t - w, 0):].index_select(3, ib).movedim(0, 1)
        hist = (new.contiguous() if t >= w
                else torch.cat([hist0[:, t:], new], dim=1))

        y = torch.zeros((b, t, spec.shape[3]), dtype=self.cdtype,
                        device=spec.device)                  # (B, T, NB)
        y.index_copy_(2, self.ib, y_ib)
        y[:, :, 0] = spec[:, :, 0, 0].T                       # mvdr.cpp:76
        out, prev = common.istft_channels_carry(y, self.engine, self.window,
                                                carry.out_prev)
        return out * p.out_amp, (common.WolaCarry(tail, prev), hist)

    def _solve_dense(self, x_ib, hist0, gate, weights):
        """The block pipeline on B streams: (B, T, M, NIB) in-band spectra,
        history (B, W, M, NIB), gate (B, T, NIB) -> (B, T, NIB) gated
        output. ``weights(r (B, n, NIB, M, M), frames slice) -> (B, n,
        NIB, M)`` turns a block's loaded covariances into
        beamformer weights: the B streams' blocks go through it at once, so
        its Gauss-Jordan inverse launches once a block for all of them. The
        block is one stream's (:meth:`_block_frames`), as JAX's vmap keeps
        it, so the block's workspaces grow B-fold (one stream's outer
        products alone ~128 MB)."""
        w = self.params.past_windows
        t, m = x_ib.shape[-3], x_ib.shape[-2]
        cb = self._block_frames(t)
        wr = white_r(m, self.rdtype, x_ib.device)
        # sliding-window selector: G[c] = sum of the W frames BEFORE frame c
        # (the reference updates history after solving, mvdr.cpp:87,100-101)
        ones = torch.ones((cb, cb + w), dtype=self.rdtype,
                          device=x_ib.device)
        band = (ones.tril(w - 1) - ones.tril(-1)).to(self.cdtype)
        ext = torch.cat([hist0, x_ib], dim=-3)              # (W+T, M, NIB)
        y_ib = torch.empty(x_ib.shape[:-2] + x_ib.shape[-1:],
                           dtype=self.cdtype, device=x_ib.device)
        for c0 in range(0, t, cb):
            n = min(cb, t - c0)
            e = ext[..., c0:c0 + n + w, :, :]               # (W+n, M, NIB)
            o = torch.einsum("...tmn,...tkn->...tnmk", e, e.conj())
            g = torch.einsum("ct,...tnmk->...cnmk", band[:n, :n + w], o)
            w_opt = weights(g * wr, slice(c0, c0 + n))
            xb = x_ib[..., c0:c0 + n, :, :]
            # w^H x per (frame, bin), products summed over the mics: each
            # sum in one order however many streams the block holds
            y_bf = (w_opt.conj() * xb.movedim(-1, -2)).sum(-1)
            y_ib[..., c0:c0 + n, :] = torch.where(
                gate[..., c0:c0 + n, :], y_bf, 0.01 * xb[..., 0, :])
        return y_ib
