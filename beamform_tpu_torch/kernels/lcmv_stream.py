"""Streaming LCMV solve: the CUDA kernel's wrapper and its plain-torch
version.

Counterpart of ``beamform_tpu/kernels/lcmv_stream.py``: :func:`lcmv_stream`
replaces ``_kernel`` (reached through ``lcmv_stream_pallas`` /
``lcmv_stream_planes_pallas``), the algebra of its
``constraint_space_apply``. Reference semantics (lcmv.cpp:108-138): per
frame t and in-band bin, R is the sum of x x^H over the ``W`` frames
BEFORE t times ``ones + 0.001 I`` elementwise (as MVDR), X = R^-1 C with
C the frame's (M, S) constraint matrix, G = C^H X plus 1 on the diagonal
of every all-zero column of C (an inactive slot of the masked timeline),
v = G^-1 e0, and y = (X v)^H x_t where the energy gate passes, else the
passthrough 0.01 * x_t[mic 0]. X is a Cholesky solve with one refinement
pass, v a solve with one residual step, as in the JAX kernel. The kernel is
in ``csrc/lcmv_stream.cu``.

As for MVDR, the passthrough is part of the contract, solves are skipped
per (frame, bin), and each window sum is computed directly, so a chunk's
output does not depend on where the chunk starts.

Streams: as ``kernels/mvdr_stream.py``, one launch serves B streams, the
spectra (T, B, M, NB), hist, idx, gate and y with a leading stream axis,
the constraint sets c shared; the single-stream form is B = 1.

Routing: a CPU tensor takes the plain version (float32 or float64); a CUDA
tensor launches the kernel or raises. ``lcmv_stream.launches`` counts
launches.
"""

from __future__ import annotations

import torch

from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.kernels.mvdr_stream import (MAX_MICS, MAX_SLOTS,
                                                    MAX_SMEM, MAX_STREAMS,
                                                    cholesky_refined_solve,
                                                    gated_problems,
                                                    stream_fits)
from beamform_tpu_torch.utils.profiling import span


def lcmv_stream_plain(x: torch.Tensor, hist: torch.Tensor, c: torch.Tensor,
                      idx: torch.Tensor, gate: torch.Tensor,
                      ib: torch.Tensor, refine: bool = True) -> torch.Tensor:
    """The kernel's plain version (``refine`` False drops the refinement of
    the solves with R, as the fused kernel's default; kernels/mega_stream).

    x     (T, M, NB) complex spectra of the chunk (the analysis output)
    hist  (W, M, NIB) the W in-band frames before x[0]
    c     (U, S, M, NIB) constraint sets, one per unique control row
          (column 0 the look direction; inactive slots all zero)
    idx   (T,) int index into U; gate (T, NIB) bool energy gate
    ib    (NIB,) int bins of x in the band
    -> y  (T, NIB): the LCMV output where the gate passes, 0.01 * x[:, 0]
    where it fails.

    With a stream axis (x (T, B, M, NB), hist (B, W, M, NIB), idx (B, T),
    gate (B, T, NIB)) -> y (B, T, NIB): each stream's plain version,
    stacked.
    """
    if x.dim() == 4:
        return torch.stack([
            lcmv_stream_plain(x[:, b], hist[b], c, idx[b], gate[b], ib,
                              refine)
            for b in range(x.shape[1])])
    s = c.shape[1]
    x_ib, batches = gated_problems(x, hist, gate, ib)
    y = 0.01 * x_ib[:, 0, :]
    e0 = torch.zeros((s, 1), dtype=x.dtype, device=x.device)
    e0[0] = 1
    for t, b, r in batches:
        cm = c[idx[t], :, :, b].transpose(1, 2)            # (P, M, S)
        xs = cholesky_refined_solve(r, cm, refine)         # R^-1 C
        g = cm.conj().transpose(1, 2) @ xs                 # (P, S, S)
        g = g + torch.diag_embed((cm == 0).all(dim=1).to(g.dtype))
        # solve_ex: a singular inner matrix gives non-finite weights, as
        # in the kernel and the reference, instead of raising
        v = torch.linalg.solve_ex(g, e0.expand(len(t), s, 1)).result
        v = v + torch.linalg.solve_ex(g, e0 - g @ v).result
        w = (xs @ v)[..., 0]                               # (P, M)
        y[t, b] = (w.conj() * x_ib[t, :, b]).sum(-1)       # w^H x
    return y


def lcmv_stream(x: torch.Tensor, hist: torch.Tensor, c: torch.Tensor,
                idx: torch.Tensor, gate: torch.Tensor,
                ib: torch.Tensor) -> torch.Tensor:
    """Streaming LCMV solve; see :func:`lcmv_stream_plain` for the
    contract, with or without a stream axis: one launch either way. On
    CUDA: complex64 x, hist and c, int64 idx and ib, bool gate, all
    contiguous, M <= 32 and S <= 16 within ``mvdr_stream.stream_fits``, at
    most ``MAX_STREAMS`` streams. The kernel checks the index tensors'
    bounds itself, so the call never synchronises: an index out of range
    gives NaN where the plain version raises."""
    if not x.is_cuda:
        return lcmv_stream_plain(x, hist, c, idx, gate, ib)
    with span("bf.kernel.lcmv_stream"):
        t, m, nb = x.shape[0], x.shape[-2], x.shape[-1]
        lead = tuple(x.shape[1:-2])             # (B,), or () for one stream
        b = lead[0] if lead else 1
        w, nib = hist.shape[-3], hist.shape[-1]
        u, s = c.shape[:2]
        if (t == 0 or w == 0 or nib == 0 or u == 0
                or not 1 <= b <= MAX_STREAMS):
            raise ValueError(f"empty chunk, history, band or control rows, "
                             f"or streams outside 1..{MAX_STREAMS}: T={t}, "
                             f"W={w}, NIB={nib}, U={u}, B={b}")
        if not (s >= 1 and stream_fits(m, w, s)):
            raise ValueError(f"the CUDA LCMV stream kernel takes M <= "
                             f"{MAX_MICS}, 1 <= S <= {MAX_SLOTS} constraint "
                             f"slots and a tile within {MAX_SMEM} bytes of "
                             f"shared memory, got M={m}, S={s}, W={w}")
        dev = x.device
        check_tensor(x, "x", torch.complex64, (t,) + lead + (m, nb), dev)
        check_tensor(hist, "hist", torch.complex64, lead + (w, m, nib), dev)
        check_tensor(c, "c", torch.complex64, (u, s, m, nib), dev)
        check_tensor(idx, "idx", torch.int64, lead + (t,), dev)
        check_tensor(gate, "gate", torch.bool, lead + (t, nib), dev)
        check_tensor(ib, "ib", torch.int64, (nib,), dev)
        y = torch.empty(lead + (t, nib), dtype=torch.complex64, device=dev)
        with device_guard(dev):
            lib, stream = launch_context(dev)
            code = lib.bf_lcmv_stream(
                x.data_ptr(), ib.data_ptr(), hist.data_ptr(), c.data_ptr(),
                idx.data_ptr(), gate.data_ptr(), y.data_ptr(), b, t, m, nb,
                nib, w, u, s, stream)
        check(lib, code, "lcmv_stream")
    lcmv_stream.launches += 1
    return y


lcmv_stream.launches = 0
