"""LCMV beamformer with dynamic interference constraints.

Reference: lcmv.cpp — per-bin constraint matrix C(f) = [d_doi, d_int1..K]
(lcmv.cpp:44-86), the MVDR covariance machinery (lcmv.cpp:112-113),
w = R^-1 C (C^H R^-1 C)^-1 with output column 0 (lcmv.cpp:116-119), the same
band/energy gates and out_amp as MVDR.

Counterpart of ``beamform_tpu/models/lcmv.py``. The reference mutates the
interference set through the ``/theta_interference`` topic; here, as in the
JAX package, the set is a fixed-capacity masked constraint timeline
(``runtime/timeline.py``): each chunk reads its unique (theta,
interference angles, active, row0) control rows and a per-frame index.
Inactive slots are zero columns of C whose inner-matrix diagonal gets a 1,
which leaves the active slots' solution exactly the smaller problem's.
After the reference's first reallocation the mic-0 constraint row stays
zero (``row0``; ``update_weights(ini=false)`` never writes it), so with M
mics at most M-1 constraints stay usable.

Solver strategies as MVDR's (``models/mvdr.select_solver_strategy``, with
the slot count): ``stream`` runs WOLA analysis with the gate statistic,
the streaming constraint-space solve (``kernels/lcmv_stream.py``: the CUDA
kernel, or its plain version on the CPU) and WOLA synthesis; ``mega`` the
fused audio-to-audio kernel (``kernels/mega_stream.py``; one slot takes
its MVDR form); ``dense`` the block pipeline with the Gauss-Jordan inverse
(``kernels/linalg.py``) for R and for the S x S inner matrix. Slots that
no row of a chunk activates are dropped before any of them
(``models/batching.trim_inactive_slots``). Streaming
state is MVDR's ``(WolaCarry, hist)``, so checkpoints move between the two
packages. The one forward is MVDR's, each strategy with one stream's
launches: the B streams share the control rows (one static interference
set; a single stream, a batch of one, may replay an event timeline) and
each has its row index; ``dense`` inverts R and the S x S inner matrix of
the B streams' block in one launch each.
"""

from __future__ import annotations

import torch

from beamform_tpu_torch.config import EngineConfig, LcmvParams
from beamform_tpu_torch.geometry import (ArrayGeometry, steering_delays,
                                         steering_weights)
from beamform_tpu_torch.kernels.lcmv_stream import lcmv_stream
from beamform_tpu_torch.kernels.mega_stream import lcmv_mega
from beamform_tpu_torch.models.batching import BatchableConstrainedModel
from beamform_tpu_torch.models.mvdr import (MvdrModel, batched_inv,
                                            stream_matmul)
from beamform_tpu_torch.utils.profiling import span


def lcmv_solve(r: torch.Tensor, c: torch.Tensor, inactive_diag=None,
               streams: bool = False) -> torch.Tensor:
    """w = R^-1 C (C^H R^-1 C)^-1, output column 0 (lcmv.cpp:116-119).
    r (..., M, M); c (..., M, S) -> (..., M).

    R's unpolished Gauss-Jordan inverse is refined at the S-column
    right-hand side (the Newton polish's value at M^2 S). ``inactive_diag``
    (..., S): 1.0 for masked-out constraint slots, whose zero columns of C
    leave zero rows and columns in the inner matrix; the identity added
    there makes it block-diagonal, so the active block's inverse (hence
    column 0 of w) is the smaller problem's. The S x S inner matrix is
    inverted with the polish. ``streams``: r and c lead with a stream axis;
    each inverse is one launch for every stream, the products
    ``models/mvdr.stream_matmul``'s.
    """
    def mm(a, b):
        return stream_matmul(a, b, streams)

    inv = batched_inv(r, polish=False)
    ric0 = mm(inv, c)
    ric = ric0 + mm(inv, c - mm(r, ric0))
    inner = mm(c.conj().transpose(-1, -2), ric)               # (..., S, S)
    if inactive_diag is not None:
        inner = inner + torch.diag_embed(inactive_diag.to(inner.dtype))
    return mm(ric, batched_inv(inner)[..., :1])[..., 0]


def build_constraints_masked(geom: ArrayGeometry, freqs: torch.Tensor,
                             theta: torch.Tensor, interf_angles: torch.Tensor,
                             active: torch.Tensor, row0: torch.Tensor,
                             rdtype, cdtype, ib: torch.Tensor) -> torch.Tensor:
    """Masked constraint matrices of U control rows at once.

    theta (U,); interf_angles (U, K); active (U, K) 0/1; row0 (U,).
    Returns (U, NIB, M, K+1): column 0 the look direction, inactive columns
    zeroed, the mic-0 row scaled by the row's ``row0`` (the post-realloc
    quirk, lcmv.cpp:243-252 + update_weights), evaluated in ``rdtype``.
    """
    angles = torch.cat([theta[:, None], interf_angles], dim=1).to(rdtype)
    tau = steering_delays(geom, angles, dtype=rdtype,
                          device=angles.device)             # (U, S, M)
    r0 = row0.to(rdtype)[:, None].expand(angles.shape)
    w = steering_weights(freqs.to(rdtype), tau, row0_scale=r0)  # (U,S,M,NB)
    cols = torch.cat([torch.ones_like(theta[:, None]), active],
                     dim=1).to(rdtype)                      # (U, S)
    c = w.to(cdtype) * cols[:, :, None, None].to(cdtype)
    return c.index_select(3, ib).permute(0, 3, 2, 1)


class LcmvModel(BatchableConstrainedModel, MvdrModel):
    name = "lcmv"

    def __init__(self, engine: EngineConfig, geom: ArrayGeometry,
                 params: LcmvParams = LcmvParams(), interference_angles=(),
                 device="cuda"):
        super().__init__(engine, geom, params, device=device)
        self.interf = tuple(interference_angles)

    def _control_tensors(self, u_theta, u_angles, u_active, u_row0):
        """The unique control rows -> (masked constraints in the stream
        kernel's layout (U, S, M, NIB), inactive-slot indicator (U, S)),
        built once per control key (the span ``bf.steering``)."""
        with span("bf.steering"):
            c_ib = build_constraints_masked(
                self.geom, self.freqs, u_theta, u_angles, u_active, u_row0,
                self.rdtype, self.cdtype, self.ib)
            inact = 1.0 - torch.cat([torch.ones_like(u_theta[:, None]),
                                     u_active], dim=1)
            return c_ib.permute(0, 3, 2, 1).contiguous(), inact

    def _controls(self, thetas_bt, interference=None):
        """(B, T) theta timelines and an optional shared interference
        timeline -> (constraints (U, S, M, NIB), inactive slots (U, S), row
        index (B, T))."""
        (c_k, inact), idx, _ = super()._controls(thetas_bt, interference)
        return c_k, inact, idx

    @torch.no_grad()
    def batched_forward(self, x, ctrl, state):
        """x (B, M, T*hop), the controls of :meth:`batch_controls`, state
        with a leading B -> ((B, T*hop) output, new state): ``stream`` and
        ``mega`` in one launch of each kernel for the B streams, ``dense``
        in one launch of each Gauss-Jordan inverse a block for the B
        streams."""
        c_k, inact, idx = ctrl
        strategy = self._strategy(c_k.shape[1])
        if strategy == "mega":
            return self._forward_mega(lcmv_mega, x, c_k, idx, state)

        def solve(spec, hist0, gate):
            if strategy == "stream":
                return lcmv_stream(spec, hist0, c_k, idx, gate, self.ib)
            c_ib = c_k.permute(0, 3, 2, 1)                 # (U, NIB, M, S)
            return self._solve_dense(
                spec.index_select(3, self.ib).movedim(0, 1), hist0, gate,
                lambda r, sl: lcmv_solve(r, c_ib[idx[:, sl]],
                                         inact[idx[:, sl]][..., None, :],
                                         streams=True))

        return self.gated_forward(x, state, solve)

    def stream_solve(self, ctrl, sel, bins):
        """:meth:`MvdrModel.stream_solve` with the LCMV stream kernel: the
        controls' constraints on the bin group."""
        c_k, _, idx = ctrl
        if self._strategy(c_k.shape[1]) not in ("stream", "mega"):
            return None
        c_g = c_k.index_select(3, sel).contiguous()
        return lambda spec, hist0, gate: lcmv_stream(spec, hist0, c_g, idx,
                                                     gate, bins)
