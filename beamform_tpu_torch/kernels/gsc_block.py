"""GSC's lookahead-8 adaptive stage (``solver="block"``): the CUDA kernel's
wrapper and its plain-torch version.

Counterpart of ``beamform_tpu/kernels/gsc_block.py``: the exact
lookahead-8 factorisation of the per-sample LMS recurrence
(gsc.cpp:120-179). Within each group of 8 samples the filters are frozen
at the group's start, so for the group's sample t

  out[t] = d[t] - sum_c <g_c, b_c(t)>                       (base dots)
           - sum_{s in group, s < t} sum_c w_c[s] <b_c(s), b_c(t)>

with w_c[s] = mu_c[s] out[s] (0 where the VAD gate holds the filters):
the 8 base dots are independent, and only a scalar chain with the
window-pair Grams <b_c(t-l), b_c(t)> (lags 1..7) stays serial. The rank-8
filter update g_c += sum_s w_c[s] b_c(s) lands at the group's end, where
NaN taps become 0: the one semantic deviation from the per-sample
recurrence, which scrubs per sample (only a diverging filter can tell).

Every power is a fresh sum over its window, not the TPU kernel's running
sums (which do not return to 0 when a window falls silent, see
``csrc/gsc_sample.cu``): the Grams (lag 0 is bsq_c) are input-only and
formed from the u stream; osq of the group's sample i is the sum of the
127 - i squared outputs before the group still in its window plus the
squares of the group's first i + 1 outputs.

:func:`gsc_block` replaces ``_kernel`` (via ``gsc_block_pallas_batched``),
with its signature and ``GscState``'s leaves: (aligned, block, filt,
last_out, gram, uold) -> (out, block', filt', last_out', gram', uold').
Both versions form their Grams from ``block`` and ``uold`` (every path
writes ``gram`` with ``models/gsc.py`` ``gram_refresh``, so it holds the
same values) and return the exact Grams at the last sample.

Routing: a CPU tensor takes :func:`gsc_block_plain` (float32 or float64);
a CUDA tensor launches ``csrc/gsc_block.cu`` (float32, K = 128, 2 to 16
mics, S a multiple of 128) or raises. The wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.kernels.gsc import (K, check_shape, coef_array,
                                            window_sums)
from beamform_tpu_torch.utils.profiling import span

L = 8              # lookahead: samples per group of frozen filters


def lag_grams(block, uold, u) -> torch.Tensor:
    """G (..., C, S, 8): G[..., t, l] = <b_c(t-l), b_c(t)> over K-tap
    windows after each of the chunk's samples, from the register (..., C,
    K) and the 8 samples before it (..., C, 8) ahead of the chunk's
    blocking-matrix samples u (..., C, S). Fresh windowed sums
    (:func:`window_sums`), so a silent window gives exactly 0."""
    k = block.shape[-1]
    ue = torch.cat([uold.to(u.dtype), block.to(u.dtype), u], dim=-1)
    n = ue.shape[-1]
    # q_l[j] = u[j] u[j-l] over [register | chunk]; sample t's window is
    # q_l[t+1 .. t+K]
    return torch.stack([window_sums((ue[..., L:] * ue[..., L - l:n - l])
                                    [..., 1:], k) for l in range(L)], dim=-1)


def gsc_block_plain(aligned, block, filt, last_out, gram, uold, params):
    """The lookahead-8 factorisation for B streams: aligned (B, M, S) with
    S a multiple of 8, block and filt (B, M-1, K), last_out (B, K), gram
    and uold (B, M-1, 8) -> (out (B, S), block', filt', last_out', gram',
    uold'), in the input's dtype, K > 8 taps. ``gram`` is not read (the
    Grams are formed fresh from ``block`` and ``uold``) and is returned as
    it is for S = 0. Vectorised over the streams and over each group's 8
    base dots; the 8-step chain is a loop (gsc_block.py:143-211)."""
    p = params
    b, m, s = aligned.shape
    k = filt.shape[-1]
    if s % L or k <= L:
        raise ValueError(f"the block factorisation takes a multiple of {L} "
                         f"samples and more than {L} taps, got S={s}, K={k}")
    if s == 0:
        return (aligned.new_zeros((b, 0)), block.clone(), filt.clone(),
                last_out.clone(), gram.clone(), uold.clone())
    dt = aligned.dtype
    u = aligned[:, 1:] - aligned[:, :-1]                   # (B, C, S)
    # the mic mean, summed mic by mic: a vectorised reduction's order
    # depends on the length, and chunks must give one call bit for bit
    das = sum(aligned.unbind(1)) / m                       # (B, S)
    block, uold = block.to(dt), uold.to(dt)
    grams = lag_grams(block, uold, u)                      # (B, C, S, 8)
    # the input-only terms of the step size, as the xmu mode forms them:
    # c_b bsq_c and the q-branch steps mu0 / sqrt(bsq_c / K)
    bsq = grams[..., 0]
    kinv = 1.0 / k
    qstep = p.mu0 * torch.rsqrt(torch.clamp_min(bsq * kinv, 0.0))
    qstep = torch.where(qstep < torch.inf, qstep, 0.0)
    cb = (p.mu0 * p.mu0) * bsq
    c_o = p.mu_max * p.mu_max
    # lags 7 .. 1: sample t's lags i .. 1 against the group's samples
    # 0 .. i-1 are lagr[:, :, t, 7-i:]
    lagr = grams[..., 1:].flip(-1)
    ue = torch.cat([block, u], dim=-1)                     # (B, C, K+S)
    wins = ue.unfold(-1, k, 1)          # (B, C, S+1, K): sample t's is t+1
    oe = torch.cat([last_out.to(dt), das.new_zeros((b, s))], dim=-1)
    flt = filt.to(dt)
    for t0 in range(0, s, L):
        gw = wins[:, :, t0 + 1:t0 + 1 + L]                 # (B, C, 8, K)
        dz = das[:, t0:t0 + L] - torch.einsum("bck,bcik->bi", flt, gw)
        # the squared outputs before the group still in sample i's window,
        # oe[t0+i+1 .. K+t0-1]: suffix sums, each of its window's terms only
        before = (oe[:, t0 + 1:k + t0] ** 2).flip(-1).cumsum(-1).flip(-1)
        q = das.new_zeros((b,))
        w = das.new_zeros((b, m - 1, L))
        for i in range(L):
            t = t0 + i
            out = dz[:, i] - (w[:, :, :i] * lagr[:, :, t, L - 1 - i:]).sum(
                (1, 2))
            oe[:, k + t] = out
            q = torch.addcmul(q, out, out)
            osq = before[:, i] + q
            # mu0 / sqrt(osq / K), 0 where not finite
            pstep = torch.nan_to_num(p.mu0 * torch.rsqrt(
                torch.clamp_min(osq * kinv, 0.0)), posinf=0.0)
            mu = torch.where(cb[:, :, t] < c_o * osq[:, None],
                             pstep[:, None], qstep[:, :, t])
            wi = mu * out[:, None]
            if p.use_vad:
                upd = torch.sqrt(torch.clamp_min(osq, 0.0) * kinv) \
                    < p.vad_threshold
                wi = torch.where(upd[:, None], wi, 0.0)
            w[:, :, i] = wi
        flt = flt + torch.einsum("bci,bcik->bck", w, gw)
        flt = torch.where(torch.isnan(flt), 0.0, flt)
    ext = torch.cat([uold, ue], dim=-1)[..., -(k + L):]
    return (oe[:, k:], ext[..., L:].clone(), flt, oe[:, -k:].clone(),
            grams[:, :, -1].clone(), ext[..., :L].clone())


def gsc_block(aligned, block, filt, last_out, gram, uold, params):
    """The lookahead-8 adaptive stage; see :func:`gsc_block_plain` for the
    contract. On CUDA: float32, contiguous, K = 128, 2 to 16 mics, S a
    multiple of 128; one launch, four warps per stream."""
    if not aligned.is_cuda:
        return gsc_block_plain(aligned, block, filt, last_out, gram, uold,
                               params)
    with span("bf.kernel.gsc_block"):
        b, m, s = aligned.shape
        c = m - 1
        dev = aligned.device
        check_shape(m, filt.shape[-1], s)
        check_tensor(aligned, "aligned", torch.float32, (b, m, s), dev)
        check_tensor(block, "block", torch.float32, (b, c, K), dev)
        check_tensor(filt, "filt", torch.float32, (b, c, K), dev)
        check_tensor(last_out, "last_out", torch.float32, (b, K), dev)
        check_tensor(gram, "gram", torch.float32, (b, c, L), dev)
        check_tensor(uold, "uold", torch.float32, (b, c, L), dev)
        if aligned.data_ptr() % 16:
            aligned = aligned.clone()    # the kernel copies 16-byte rows
        out = torch.empty((b, s), dtype=torch.float32, device=dev)
        blk_o, flt_o = torch.empty_like(block), torch.empty_like(filt)
        lo_o = torch.empty_like(last_out)
        gr_o, uo_o = torch.empty_like(gram), torch.empty_like(uold)
        if b and s:
            with device_guard(dev):
                lib, stream = launch_context(dev)
                code = lib.bf_gsc_block(
                    aligned.data_ptr(), block.data_ptr(), filt.data_ptr(),
                    last_out.data_ptr(), uold.data_ptr(), out.data_ptr(),
                    blk_o.data_ptr(), flt_o.data_ptr(), lo_o.data_ptr(),
                    gr_o.data_ptr(), uo_o.data_ptr(), b, m, s,
                    int(params.use_vad), coef_array(params, m), stream)
            check(lib, code, "gsc_block")
        else:
            for dst, src in ((blk_o, block), (flt_o, filt), (lo_o, last_out),
                             (gr_o, gram), (uo_o, uold)):
                dst.copy_(src)
    gsc_block.launches += 1
    return out, blk_o, flt_o, lo_o, gr_o, uo_o


gsc_block.launches = 0
