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

Streams: one launch serves B streams that share the control rows: the
audio, carries, history and control index gain a leading stream axis
((B, M, S), (B, M, hop), (B, hop), (B, W, M, NIB), (B, T)), and so do the
outputs. The single-stream form is B = 1 of the same kernel. The kernel's
scratch grows with B (:func:`scratch_bytes`); past a quarter of the card's
memory the wrapper raises.

Routing: a CPU tensor takes the plain version (float32 or float64); a CUDA
tensor launches the kernel or raises. ``mega_stream.launches`` counts
launches.
"""

from __future__ import annotations

from functools import lru_cache

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
from beamform_tpu_torch.utils.profiling import span

#: frames per segment of the kernel's march: the segment's spectra ring
#: (SEG_FRAMES + W frames of in-band bins) stays in L2, as the TPU kernel's
#: launches covered at most 96 frames
SEG_FRAMES = 96
#: stage A's analysis holds 256 / (nfft / 16) channel pairs of one frame a
#: block, each in nfft + nfft / 16 padded points: 17 x 256 for every nfft
_ANALYSIS_ELEMS = 17 * 256


def scratch_bytes(b: int, m: int, nib: int, w_hist: int, seg: int) -> int:
    """Device scratch of one call on ``b`` streams: each stream's ring of
    SEG + W in-band frames, its segment's output and its bin-0 values."""
    return b * ((seg + w_hist) * m * nib * 8 + seg * nib * 8 + 2 * seg * 4)


@lru_cache(maxsize=8)
def _scratch_limit(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).total_memory // 4


def check_scratch(what: str, nbytes: int, device: torch.device):
    """Raise a ValueError naming the limit when a fused kernel's scratch
    exceeds a quarter of the card's memory."""
    limit = _scratch_limit(device)
    if nbytes > limit:
        raise ValueError(f"the CUDA {what} kernel's scratch for this batch "
                         f"({nbytes} bytes) exceeds a quarter of the card's "
                         f"memory ({limit} bytes); serve fewer streams a "
                         "call")


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
    where d is all zero. With a stream axis (x (B, M, T*hop), tail
    (B, M, hop), out_prev (B, hop), hist (B, W, M, NIB), idx (B, T)) each
    stream's plain version, stacked.
    """
    if x.dim() == 3:
        outs = [mega_plain(x[b], tail[b], out_prev[b], hist[b], ctrl,
                           idx[b], ib, mag_threshold, refine)
                for b in range(x.shape[0])]
        return tuple(torch.stack(parts) for parts in zip(*outs))
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
    """The fused kernel; see :func:`mega_plain` for the contract, with or
    without a stream axis: one launch either way (``lcmv`` False takes
    ``ctrl`` (U, 1, M, NIB) as MVDR steering). On CUDA: float32 audio and
    carries, complex64 hist and ctrl, int64 idx and ib, contiguous, within
    :func:`mega_fits` and :func:`check_scratch` (the bins are checked on
    the card: one outside [1, nfft / 2) gives NaN output, so the call never
    synchronises)."""
    if not x.is_cuda:
        return mega_plain(x, tail, out_prev, hist, ctrl, idx, ib,
                          mag_threshold, refine)
    with span("bf.kernel.mega_stream"):
        m, s = x.shape[-2:]
        lead = tuple(x.shape[:-2])              # (B,), or () for one stream
        b = lead[0] if lead else 1
        hop = tail.shape[-1]
        w, _, nib = hist.shape[-3:]
        u, s_cap = ctrl.shape[:2]
        t = s // hop
        if t == 0 or s % hop or w == 0 or nib == 0 or u == 0 or b == 0:
            raise ValueError(f"empty or ragged chunk, history, band, control "
                             f"rows or batch: S={s} (hop {hop}), W={w}, "
                             f"NIB={nib}, U={u}, B={b}")
        if not (lcmv or s_cap == 1):
            raise ValueError(f"MVDR steering has one slot, got S={s_cap}")
        if not _kernel_fits(m, 2 * hop, s_cap if lcmv else 0, w):
            raise ValueError(
                f"the CUDA fused MVDR/LCMV kernel takes a power-of-two nfft "
                f"in [{MIN_NFFT}, {MAX_NFFT}], M <= {MAX_MICS}, S <= "
                f"{MAX_SLOTS} and a tile within {MAX_SMEM} bytes of shared "
                f"memory, got nfft={2 * hop}, M={m}, S={s_cap}, W={w}")
        dev = x.device
        check_tensor(x, "x", torch.float32, lead + (m, s), dev)
        check_tensor(tail, "tail", torch.float32, lead + (m, hop), dev)
        check_tensor(out_prev, "out_prev", torch.float32, lead + (hop,), dev)
        check_tensor(hist, "hist", torch.complex64, lead + (w, m, nib), dev)
        check_tensor(ctrl, "ctrl", torch.complex64, (u, s_cap, m, nib), dev)
        check_tensor(idx, "idx", torch.int64, lead + (t,), dev)
        check_tensor(ib, "ib", torch.int64, (nib,), dev)
        seg = min(SEG_FRAMES, t)
        check_scratch("fused MVDR/LCMV", scratch_bytes(b, m, nib, w, seg), dev)
        win, tw = _tables(2 * hop, dev)
        ptw = _analysis_tables(2 * hop, dev)[1]
        out = torch.empty(lead + (t * hop,), dtype=torch.float32, device=dev)
        new_prev = torch.empty(lead + (hop,), dtype=torch.float32, device=dev)
        new_hist = torch.empty_like(hist)
        ring = torch.empty((b, seg + w, m, nib), dtype=torch.complex64,
                           device=dev)
        ys = torch.empty((b, seg, nib), dtype=torch.complex64, device=dev)
        dc = torch.empty((b, 2, seg), dtype=torch.float32, device=dev)
        with device_guard(dev):
            lib, stream = launch_context(dev)
            code = lib.bf_mega_stream(
                x.data_ptr(), tail.data_ptr(), out_prev.data_ptr(),
                hist.data_ptr(), ctrl.data_ptr(), idx.data_ptr(),
                ib.data_ptr(), win.data_ptr(), tw.data_ptr(), ptw.data_ptr(),
                out.data_ptr(), new_prev.data_ptr(), new_hist.data_ptr(),
                ring.data_ptr(),
                ys.data_ptr(), dc.data_ptr(), b, m, t, hop, nib, w, u, s_cap,
                seg, float(mag_threshold), int(refine), int(lcmv), stream)
        check(lib, code, "mega_stream")
    mega_stream.launches += 1
    return out, new_hist, new_prev


mega_stream.launches = 0


def _empty_step(hist, out_prev):
    return (out_prev.new_zeros(out_prev.shape[:-1] + (0,)), hist, out_prev)


def mvdr_mega(x, tail, out_prev, hist, d_ib, w_idx, ib, nfft: int,
              w_hist: int, mag_threshold: float, refine: bool = False):
    """Fused MVDR step (the contract of the JAX package's ``mvdr_mega``):
    x (M, S) audio, S a multiple of hop; tail (M, hop); out_prev (hop,);
    hist (W, M, NIB) complex history; d_ib (U, M, NIB) steering over the
    in-band bins ``ib``; w_idx (T,) steering index per frame. Returns
    (audio (S,), hist', out_prev'). B streams take a leading stream axis
    on x, tail, out_prev, hist and w_idx, and on the results."""
    _check_shape(x, tail, hist, nfft, w_hist)
    if x.shape[-1] < nfft // 2:          # no whole hop: nothing to march
        return _empty_step(hist, out_prev)
    return mega_stream(x, tail, out_prev, hist, d_ib[:, None].contiguous(),
                       w_idx, ib, mag_threshold, refine, lcmv=False)


def lcmv_mega(x, tail, out_prev, hist, c_ib, idx, ib, nfft: int,
              w_hist: int, mag_threshold: float, refine: bool = False):
    """Fused LCMV step: as :func:`mvdr_mega` with c_ib (U, S, M, NIB)
    constraint sets (inactive slots all zero, found per bin) and idx (T,)
    the control row per frame."""
    _check_shape(x, tail, hist, nfft, w_hist)
    if x.shape[-1] < nfft // 2:
        return _empty_step(hist, out_prev)
    return mega_stream(x, tail, out_prev, hist, c_ib, idx, ib,
                       mag_threshold, refine, lcmv=True)


def _check_shape(x, tail, hist, nfft: int, w_hist: int):
    if tail.shape[-1] != nfft // 2 or hist.shape[-3] != w_hist:
        raise ValueError(f"nfft {nfft} / past_windows {w_hist} disagree with "
                         f"tail {tuple(tail.shape)} / hist "
                         f"{tuple(hist.shape)}")
    if x.shape[-1] % (nfft // 2):
        raise ValueError(f"x length {x.shape[-1]} is not a multiple of hop "
                         f"{nfft // 2}")
