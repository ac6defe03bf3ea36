"""Fused audio-to-audio MVDR/LCMV: the CUDA kernel's wrapper and its
plain-torch version.

Counterpart of ``beamform_tpu/kernels/mega_stream.py``: :func:`mega_stream`
launches the kernel that replaces ``_kernel`` (reached there, and here,
through :func:`mvdr_mega` / :func:`lcmv_mega`). One call takes the chunk's
raw audio, the analysis tail, the overlap-add carry and the W-frame
in-band history, and returns the beamformed audio with the new history and
carry: analysis with the gate statistic, the sliding-covariance solve
(MVDR, or LCMV's constraint-space solve; one slot takes the MVDR form),
the combine (gated off: 0.01 * x[mic 0]; bin 0 passed through) and the
half-spectrum synthesis, all in one launch (``csrc/mega_stream.cu``; the
spectra stay in shared memory and L2).

Semantics kept from the TPU kernel: refinement off by default
(mega_stream.py:32-36); R at frame t is the sum of the W frames before it,
the carried history first; y is 0 where d^H R^-1 d == 0; inactive
constraint slots (all-zero columns) are found per bin; the returned history
is the last W in-band frames, oldest first. The TPU kernel skips the solve
of frames with no passing bin and gates per bin in the combine; the kernel
here and the plain version solve exactly the passing (frame, bin) pairs,
which gives the same output. The half-spectrum synthesis (y[0] once,
2 * y[k] for 0 < k < nfft / 2) is exact only for bands below the Nyquist
bin: :func:`band_fits` refuses the others on every device.

Routing: a CPU tensor takes the plain version (float32 or float64); a CUDA
tensor launches the kernel or raises. ``mega_stream.launches`` counts
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from beamform_tpu_torch.dsp.wola import overlap_add_carry, sqrt_hann
from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.kernels.lcmv_stream import lcmv_stream_plain
from beamform_tpu_torch.kernels.mvdr_stream import (MAX_MICS, MAX_SLOTS,
                                                    MAX_SMEM, _lanes,
                                                    solve_smem_elems)
from beamform_tpu_torch.kernels.wola import (MAX_NFFT, MIN_NFFT,
                                             _analysis_tables, _tables,
                                             wola_analysis_plain)

#: frames per segment of the kernel's march: the segment's spectra ring
#: (SEG_FRAMES + W frames of in-band bins) stays in L2, as the TPU kernel's
#: launches covered at most 96 frames
SEG_FRAMES = 96
#: stage A's analysis holds 256 / (nfft / 16) channel pairs of one frame a
#: block, each in nfft + nfft / 16 padded points: 17 x 256 for every nfft
_ANALYSIS_ELEMS = 17 * 256


def band_fits(ib, nfft: int) -> bool:
    """Whether the half-spectrum synthesis is exact for the in-band bins
    ``ib``: all in [1, nfft / 2), i.e. bin 0 handled apart and neither the
    Nyquist bin nor the extended layout's shadow bin in the band
    (mega_stream.py:663)."""
    ib = np.asarray(ib)
    return len(ib) > 0 and int(ib.min()) >= 1 and int(ib.max()) < nfft // 2


def smem_bytes(m: int, w_hist: int, s_cap: int, nfft: int) -> int:
    """Dynamic shared memory of one block: the largest of stage A's
    analysis frames, one nfft-point synthesis frame and stage B's solve
    (``mvdr_stream.solve_smem_elems``: the staged tile and column buffers
    on MP = max(M, S) rounded up to a power of two, plus LCMV's X scratch
    when ``s_cap`` > 1; one slot takes the MVDR form)."""
    lcmv = s_cap > 1
    mp = _lanes(max(m, s_cap) if lcmv else m)
    solve = solve_smem_elems(mp, w_hist, s_cap if lcmv else 0)
    return max(solve, _ANALYSIS_ELEMS, nfft) * 8


def mega_fits(m: int, ib, nfft: int, s_cap: int = 0,
              w_hist: int = 16) -> bool:
    """The CUDA kernel's capacity rule (``s_cap``: 0 for MVDR, else LCMV's
    constraint slot count): :func:`band_fits`, a power-of-two nfft in
    [256, 4096], M <= 32, S <= 16, and the block's shared memory within
    the card's (MVDR at 16 mics: W <= 162)."""
    return band_fits(ib, nfft) and _kernel_fits(m, nfft, s_cap, w_hist)


def _kernel_fits(m: int, nfft: int, s_cap: int, w_hist: int) -> bool:
    """:func:`mega_fits` without the band, which the kernel checks on the
    card."""
    return (not nfft & (nfft - 1) and MIN_NFFT <= nfft <= MAX_NFFT
            and 1 <= m <= MAX_MICS and 0 <= s_cap <= MAX_SLOTS
            and w_hist >= 1 and smem_bytes(m, w_hist, s_cap, nfft) <= MAX_SMEM)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def half_spectrum_synthesis(y_ib: torch.Tensor, dc: torch.Tensor,
                            ib: torch.Tensor, out_prev: torch.Tensor,
                            nfft: int):
    """(T, NIB) in-band output and (T,) bin-0 values -> ((T*hop,) audio,
    new out_prev): real(ifft(y[0], 2 y[k] for the band's k)) under the
    synthesis window, 50% overlap-add with the carry. irfft of the
    one-sided spectrum computes the same sum when bin nfft/2 is zero."""
    h = nfft // 2
    y = torch.zeros((y_ib.shape[0], h + 1), dtype=y_ib.dtype,
                    device=y_ib.device)
    y[:, 0] = dc
    y.index_copy_(1, ib, y_ib)
    win = torch.as_tensor(sqrt_hann(nfft), dtype=y.real.dtype,
                          device=y.device)
    p = torch.fft.irfft(y, n=nfft, dim=-1) * win
    return overlap_add_carry(p, h, out_prev)


def mega_plain(x: torch.Tensor, tail: torch.Tensor, out_prev: torch.Tensor,
               hist: torch.Tensor, ctrl: torch.Tensor, idx: torch.Tensor,
               ib: torch.Tensor, mag_threshold: float, refine: bool = False):
    """The kernel's plain version.

    x (M, T*hop) audio; tail (M, hop); out_prev (hop,); hist (W, M, NIB)
    in-band history; ctrl (U, S, M, NIB) constraint sets (S = 1: MVDR's
    steering); idx (T,) control row per frame; ib (NIB,) in-band bins.
    Returns ((T*hop,) audio, new hist, new out_prev). The solve is the
    stream solve's plain version with the refinement off; at S = 1 its
    constraint-space form is MVDR's w = R^-1 d / (d^H R^-1 d), with 0
    where d is all zero.
    """
    w = hist.shape[0]
    spec, mag, _ = wola_analysis_plain(x, tail, with_mag=True)
    gate = mag.index_select(1, ib) > mag_threshold
    y_ib = lcmv_stream_plain(spec, hist, ctrl, idx, gate, ib, refine=refine)
    new_hist = torch.cat([hist, spec.index_select(2, ib)])[-w:]
    audio, prev = half_spectrum_synthesis(
        y_ib, spec[:, 0, 0], ib, out_prev, 2 * tail.shape[-1])
    return audio, new_hist, prev


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


def mega_stream(x: torch.Tensor, tail: torch.Tensor, out_prev: torch.Tensor,
                hist: torch.Tensor, ctrl: torch.Tensor, idx: torch.Tensor,
                ib: torch.Tensor, mag_threshold: float, refine: bool = False,
                lcmv: bool = True):
    """The fused kernel; see :func:`mega_plain` for the contract
    (``lcmv`` False takes ``ctrl`` (U, 1, M, NIB) as MVDR steering). On
    CUDA: float32 audio and carries, complex64 hist and ctrl, int64 idx and
    ib, contiguous, within :func:`mega_fits` (the bins are checked on the
    card: one outside [1, nfft / 2) gives NaN output, so the call never
    synchronises)."""
    if not x.is_cuda:
        return mega_plain(x, tail, out_prev, hist, ctrl, idx, ib,
                          mag_threshold, refine)
    m, s = x.shape
    hop = tail.shape[-1]
    w, _, nib = hist.shape
    u, s_cap = ctrl.shape[:2]
    t = s // hop
    if t == 0 or s % hop or w == 0 or nib == 0 or u == 0:
        raise ValueError(f"empty or ragged chunk, history, band or control "
                         f"rows: S={s} (hop {hop}), W={w}, NIB={nib}, U={u}")
    if not (lcmv or s_cap == 1):
        raise ValueError(f"MVDR steering has one slot, got S={s_cap}")
    if not _kernel_fits(m, 2 * hop, s_cap if lcmv else 0, w):
        raise ValueError(
            f"the CUDA fused MVDR/LCMV kernel takes a power-of-two nfft in "
            f"[{MIN_NFFT}, {MAX_NFFT}], M <= {MAX_MICS}, S <= {MAX_SLOTS} "
            f"and a tile within {MAX_SMEM} bytes of shared memory, got "
            f"nfft={2 * hop}, M={m}, S={s_cap}, W={w}")
    dev = x.device
    check_tensor(x, "x", torch.float32, (m, s), dev)
    check_tensor(tail, "tail", torch.float32, (m, hop), dev)
    check_tensor(out_prev, "out_prev", torch.float32, (hop,), dev)
    check_tensor(hist, "hist", torch.complex64, (w, m, nib), dev)
    check_tensor(ctrl, "ctrl", torch.complex64, (u, s_cap, m, nib), dev)
    check_tensor(idx, "idx", torch.int64, (t,), dev)
    check_tensor(ib, "ib", torch.int64, (nib,), dev)
    seg = min(SEG_FRAMES, t)
    win, tw = _tables(2 * hop, dev)
    ptw = _analysis_tables(2 * hop, dev)[1]
    out = torch.empty((t * hop,), dtype=torch.float32, device=dev)
    new_prev = torch.empty((hop,), dtype=torch.float32, device=dev)
    new_hist = torch.empty_like(hist)
    ring = torch.empty((seg + w, m, nib), dtype=torch.complex64, device=dev)
    ys = torch.empty((seg, nib), dtype=torch.complex64, device=dev)
    dc = torch.empty((2, seg), dtype=torch.float32, device=dev)
    with device_guard(dev):
        lib, stream = launch_context(dev)
        code = lib.bf_mega_stream(
            x.data_ptr(), tail.data_ptr(), out_prev.data_ptr(),
            hist.data_ptr(), ctrl.data_ptr(), idx.data_ptr(), ib.data_ptr(),
            win.data_ptr(), tw.data_ptr(), ptw.data_ptr(), out.data_ptr(),
            new_prev.data_ptr(), new_hist.data_ptr(), ring.data_ptr(),
            ys.data_ptr(), dc.data_ptr(), m, t, hop, nib, w, u, s_cap, seg,
            float(mag_threshold), int(refine), int(lcmv), stream)
    check(lib, code, "mega_stream")
    mega_stream.launches += 1
    return out, new_hist, new_prev


mega_stream.launches = 0


def _empty_step(hist, out_prev):
    return (out_prev.new_zeros((0,)), hist, out_prev)


def mvdr_mega(x, tail, out_prev, hist, d_ib, w_idx, ib, nfft: int,
              w_hist: int, mag_threshold: float, refine: bool = False):
    """Fused MVDR step (the contract of the JAX package's ``mvdr_mega``):
    x (M, S) audio, S a multiple of hop; tail (M, hop); out_prev (hop,);
    hist (W, M, NIB) complex history; d_ib (U, M, NIB) steering over the
    in-band bins ``ib``; w_idx (T,) steering index per frame. Returns
    (audio (S,), hist', out_prev')."""
    _check_shape(x, tail, hist, nfft, w_hist)
    if x.shape[1] < nfft // 2:           # no whole hop: nothing to march
        return _empty_step(hist, out_prev)
    return mega_stream(x, tail, out_prev, hist, d_ib[:, None].contiguous(),
                       w_idx, ib, mag_threshold, refine, lcmv=False)


def lcmv_mega(x, tail, out_prev, hist, c_ib, idx, ib, nfft: int,
              w_hist: int, mag_threshold: float, refine: bool = False):
    """Fused LCMV step: as :func:`mvdr_mega` with c_ib (U, S, M, NIB)
    constraint sets (inactive slots all zero, found per bin) and idx (T,)
    the control row per frame."""
    _check_shape(x, tail, hist, nfft, w_hist)
    if x.shape[1] < nfft // 2:
        return _empty_step(hist, out_prev)
    return mega_stream(x, tail, out_prev, hist, c_ib, idx, ib,
                       mag_threshold, refine, lcmv=True)


def _check_shape(x, tail, hist, nfft: int, w_hist: int):
    if tail.shape[-1] != nfft // 2 or hist.shape[0] != w_hist:
        raise ValueError(f"nfft {nfft} / past_windows {w_hist} disagree with "
                         f"tail {tuple(tail.shape)} / hist "
                         f"{tuple(hist.shape)}")
    if x.shape[1] % (nfft // 2):
        raise ValueError(f"x length {x.shape[1]} is not a multiple of hop "
                         f"{nfft // 2}")
