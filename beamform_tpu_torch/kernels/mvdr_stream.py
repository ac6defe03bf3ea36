"""Streaming MVDR solve: the CUDA kernel's wrapper and its plain-torch
version.

Counterpart of ``beamform_tpu/kernels/mvdr_stream.py``: :func:`mvdr_stream`
replaces ``_kernel`` (reached through ``mvdr_stream_pallas``). Reference
semantics (mvdr.cpp:84-114): per frame t and in-band bin, R is the sum of
x x^H over the ``W`` frames BEFORE t (the carried history, then the chunk's
own frames) times ``ones + 0.001 I`` elementwise, w = R^-1 d / (d^H R^-1 d)
and y = w^H x_t where the energy gate passes, else the passthrough
0.01 * x_t[mic 0] (mvdr.cpp:96). The solve is a Cholesky factorisation
with one iterative-refinement pass, as the JAX kernel's ``refine=True``.
The kernel is in ``csrc/mvdr_stream.cu``.

Unlike the JAX kernel, the passthrough is part of the contract (the JAX
caller applies it with a ``where``), and solves are skipped per (frame,
bin) rather than per frame; the gated outputs are the same. Each window
sum is computed directly, so a chunk's output does not depend on where
the chunk starts.

Streams: one launch serves B streams (the kernel's grid carries a stream
index). The spectra are then (T, B, M, NB), the analysis output of all
B * M channels, and hist, the steering index, the gate and the output
gain a leading stream axis; the steering d is shared. The single-stream
form is B = 1 of the same kernel.

Schedule: the kernel solves only the gated pairs. Each block of 8 bins x
32 frames lists its gated pairs in shared memory (one byte a pair) and
hands them to its solve slots in turn, so every slot of a warp that runs a
solve holds a gated pair, except in a block's last round; the pairs off the
list get the passthrough straight from the spectra, and a block with no
gated pair stages nothing. A listed pair's output does not depend on the
other pairs' gates, bit for bit. The tile keeps ``csrc/tri_solve.cuh``'s
layout, in which two problems of one bin at different frames share banks
(``csrc/mvdr_stream.cu`` says why that stays).

Routing: a CPU tensor takes the plain version (float32 or float64); a CUDA
tensor launches the kernel or raises. ``mvdr_stream.launches`` counts
launches; ``mvdr_stream.slot_counts()`` synchronises and returns the pairs
the kernel solved and the slots it issued (those of the warps that ran a
solve), summed over every launch and device so far: their ratio is the
schedule's fill share. The counts live on the device, one atomic add each a
block that solves, and are never read on the hot path.
"""

from __future__ import annotations

import torch

from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.utils.profiling import span

#: capacity of the CUDA kernels: one problem in at most 32 lanes (a warp);
#: the LCMV kernel takes at most 16 constraint slots
MAX_MICS, MAX_SLOTS = 32, 16
#: a block stages 32 frames plus their W-frame history, 8 bins wide, for
#: problems of a power-of-two size, in at most the card's 227 KB of shared
#: memory per block; 256 threads
_TILE_FRAMES, _TILE_BINS, MAX_SMEM, _THREADS = 32, 8, 232448, 256
#: problems per plain-version batch (bounds its memory on the card)
_PLAIN_CHUNK = 1 << 16
#: streams one launch takes (the grid's z extent)
MAX_STREAMS = 65535
#: the MVDR kernel's list of a tile's gated pairs: a byte a pair
_LIST_BYTES = _TILE_FRAMES * _TILE_BINS
#: per device, the kernel's (pairs solved, slots issued), int64 on the card
_SLOT_COUNTS: dict = {}


def _lanes(n: int) -> int:
    return max(4, 1 << (n - 1).bit_length())


def solve_smem_elems(mp: int, w_hist: int, s_cap: int = 0) -> int:
    """complex64 elements of the shared memory of one block of a solve on
    csrc/tri_solve.cuh (the MVDR and LCMV stream kernels, the fused
    kernel's stage B) for problems of size ``mp``: the staged tile
    ((32 + W) frames x 8 bins x (MP + 2)), two column buffers of MP + 1
    pairs per problem in flight (512 / MP of them), and with ``s_cap``
    slots each problem's X scratch (SP x MP, SP the slots rounded up to a
    power of two)."""
    slots = 2 * _THREADS // mp
    elems = (_TILE_FRAMES + w_hist) * _TILE_BINS * (mp + 2) + slots * (2 * mp
                                                                       + 2)
    if s_cap:
        elems += slots * (1 << (s_cap - 1).bit_length()) * mp
    return elems


def smem_bytes(m: int, w_hist: int, s_cap: int = 0) -> int:
    """Shared memory of one block of the MVDR kernel (``s_cap`` 0) or of
    the LCMV kernel with ``s_cap`` constraint slots: :func:`solve_smem_elems`
    for MP = max(M, S) rounded up to a power of two, and for the MVDR
    kernel its list of the tile's gated pairs."""
    return (solve_smem_elems(_lanes(max(m, s_cap)), w_hist, s_cap) * 8
            + (0 if s_cap else _LIST_BYTES))


def stream_fits(m: int, w_hist: int, s_cap: int = 0) -> bool:
    """The streaming kernels' capacity rule: M <= 32, at most 16 slots
    (LCMV), and the block's shared memory within the card's (MVDR, the list
    of gated pairs included: W <= 162 at 16 mics, W <= 70 at 32; LCMV at
    one slot: W <= 158 at 16 mics, W <= 69 at 32; at 16 slots: W <= 105 at
    16 mics, W <= 40 at 32)."""
    return (1 <= m <= MAX_MICS and 0 <= s_cap <= MAX_SLOTS
            and smem_bytes(m, w_hist, s_cap) <= MAX_SMEM)


def white_r(m: int, rdtype, device=None) -> torch.Tensor:
    """ones + 0.001 on the diagonal (mvdr.cpp:239-243)."""
    return (torch.ones((m, m), dtype=rdtype, device=device)
            + 0.001 * torch.eye(m, dtype=rdtype, device=device))


def cholesky_refined_solve(r: torch.Tensor, b: torch.Tensor,
                           refine: bool = True):
    """R^-1 B by Cholesky with one refinement pass (none when not
    ``refine``); r (P, M, M), b (P, M, K)."""
    low = torch.linalg.cholesky_ex(r).L
    u = torch.cholesky_solve(b, low)
    return u + torch.cholesky_solve(b - r @ u, low) if refine else u


def gated_problems(x: torch.Tensor, hist: torch.Tensor, gate: torch.Tensor,
                   ib: torch.Tensor):
    """The plain versions' common part: (x_ib, batches). ``x_ib`` (T, M,
    NIB) are the in-band spectra; ``batches`` yields, for at most
    ``_PLAIN_CHUNK`` gated-on (frame, bin) pairs at a time, their frame
    and bin indices (P,) and their loaded window covariances (P, M, M)."""
    w = hist.shape[0]
    x_ib = x.index_select(2, ib)                          # (T, M, NIB)
    ext = torch.cat([hist, x_ib], dim=0)                  # (W+T, M, NIB)
    white = white_r(x.shape[1], x.real.dtype, x.device)
    tt, bb = torch.nonzero(gate, as_tuple=True)
    offs = torch.arange(w, device=x.device)

    def batches():
        for s in range(0, len(tt), _PLAIN_CHUNK):
            t, b = tt[s:s + _PLAIN_CHUNK], bb[s:s + _PLAIN_CHUNK]
            win = ext[t[:, None] + offs, :, b[:, None]]    # (P, W, M)
            yield t, b, torch.einsum("pwi,pwj->pij", win, win.conj()) * white

    return x_ib, batches()


def mvdr_stream_plain(x: torch.Tensor, hist: torch.Tensor, d: torch.Tensor,
                      w_idx: torch.Tensor, gate: torch.Tensor,
                      ib: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version.

    x     (T, M, NB) complex spectra of the chunk (the analysis output)
    hist  (W, M, NIB) the W in-band frames before x[0]
    d     (U, M, NIB) steering vectors; w_idx (T,) int index into U
    gate  (T, NIB) bool energy gate; ib (NIB,) int bins of x in the band
    -> y  (T, NIB): the MVDR output where the gate passes, 0.01 * x[:, 0]
    where it fails.

    With a stream axis (x (T, B, M, NB), hist (B, W, M, NIB), w_idx
    (B, T), gate (B, T, NIB)) -> y (B, T, NIB): each stream's plain
    version, stacked.
    """
    if x.dim() == 4:
        return torch.stack([
            mvdr_stream_plain(x[:, b], hist[b], d, w_idx[b], gate[b], ib)
            for b in range(x.shape[1])])
    x_ib, batches = gated_problems(x, hist, gate, ib)
    y = 0.01 * x_ib[:, 0, :]
    for t, b, r in batches:
        dv = d[w_idx[t], :, b]                             # (P, M)
        u = cholesky_refined_solve(r, dv[..., None])[..., 0]
        den = (dv.conj() * u).sum(-1)                      # d^H u
        num = (u.conj() * x_ib[t, :, b]).sum(-1)           # u^H x
        y[t, b] = num / den.conj()
    return y


def mvdr_stream(x: torch.Tensor, hist: torch.Tensor, d: torch.Tensor,
                w_idx: torch.Tensor, gate: torch.Tensor,
                ib: torch.Tensor) -> torch.Tensor:
    """Streaming MVDR solve; see :func:`mvdr_stream_plain` for the
    contract, with or without a stream axis: one launch either way. On
    CUDA: complex64 x, hist and d, int64 w_idx and ib, bool gate, all
    contiguous, within :func:`stream_fits` and at most
    :data:`MAX_STREAMS` streams. The kernel checks the index tensors'
    bounds itself, so the call never synchronises: an index out of range
    gives NaN where the plain version raises."""
    if not x.is_cuda:
        return mvdr_stream_plain(x, hist, d, w_idx, gate, ib)
    with span("bf.kernel.mvdr_stream"):
        t, m, nb = x.shape[0], x.shape[-2], x.shape[-1]
        lead = tuple(x.shape[1:-2])             # (B,), or () for one stream
        b = lead[0] if lead else 1
        w, nib = hist.shape[-3], hist.shape[-1]
        u = d.shape[0]
        if t == 0 or w == 0 or nib == 0 or not 1 <= b <= MAX_STREAMS:
            raise ValueError(f"empty chunk, history or band, or streams "
                             f"outside 1..{MAX_STREAMS}: T={t}, W={w}, "
                             f"NIB={nib}, B={b}")
        if not stream_fits(m, w):
            raise ValueError(f"the CUDA MVDR stream kernel takes M <= "
                             f"{MAX_MICS} and a tile within {MAX_SMEM} bytes "
                             f"of shared memory, got M={m}, W={w}")
        dev = x.device
        check_tensor(x, "x", torch.complex64, (t,) + lead + (m, nb), dev)
        check_tensor(hist, "hist", torch.complex64, lead + (w, m, nib), dev)
        check_tensor(d, "d", torch.complex64, (u, m, nib), dev)
        check_tensor(w_idx, "w_idx", torch.int64, lead + (t,), dev)
        check_tensor(gate, "gate", torch.bool, lead + (t, nib), dev)
        check_tensor(ib, "ib", torch.int64, (nib,), dev)
        y = torch.empty(lead + (t, nib), dtype=torch.complex64, device=dev)
        with device_guard(dev):
            counts = _SLOT_COUNTS.get(dev)
            if counts is None:
                counts = _SLOT_COUNTS[dev] = torch.zeros(
                    2, dtype=torch.int64, device=dev)
            lib, stream = launch_context(dev)
            code = lib.bf_mvdr_stream(
                x.data_ptr(), ib.data_ptr(), hist.data_ptr(), d.data_ptr(),
                w_idx.data_ptr(), gate.data_ptr(), y.data_ptr(),
                counts.data_ptr(), b, t, m, nb, nib, w, u, stream)
        check(lib, code, "mvdr_stream")
    mvdr_stream.launches += 1
    return y


def slot_counts() -> tuple[int, int]:
    """(pairs solved, slots issued) by the CUDA kernel so far, over every
    launch and device; (0, 0) before the first. Synchronises."""
    pairs = slots = 0
    for counts in _SLOT_COUNTS.values():
        p, s = counts.tolist()
        pairs, slots = pairs + p, slots + s
    return pairs, slots


mvdr_stream.launches = 0
mvdr_stream.slot_counts = slot_counts
