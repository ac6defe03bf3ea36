"""GSC's block-LMS adaptive stage (``solver="blocklms"``): the CUDA
kernel's wrapper and its plain-torch version.

Counterpart of ``beamform_tpu/kernels/gsc_blocklms.py``. EXPLICITLY
NON-FAITHFUL, as there: the reference updates the FIR bank after every
sample (gsc.cpp:162-169); block LMS freezes the filters for a block of
``block_samples`` l samples, computes every per-sample quantity of the
reference (output, dynamic mu, VAD gate) against the frozen filters, and
lands the l accumulated rank-1 updates at the block's end, NaN taps
scrubbed to 0. :func:`gsc_blocklms` replaces ``_kernel`` (via
``gsc_blocklms_pallas_batched``); its plain version :func:`gsc_blocklms_plain`
is ``gsc_blocklms_scan`` written for a batch of streams, and
:func:`gsc_blocklms_scan` keeps that function's single-stream signature.

Routing: a CPU tensor takes the plain version (float32 or float64); a CUDA
tensor launches ``csrc/gsc_blocklms.cu`` (float32, K = 128, 2 to 16 mics, S
a multiple of l) or raises. The wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.kernels.gsc import coef_array
from beamform_tpu_torch.utils.profiling import span

K = 128          # filter taps (reference default, gsc.cpp:219)
L = 128          # default block length
VALID_BLOCKS = (128, 256, 512, 1024)   # GscParams.block_samples choices
MAX_MICS = 16
MAX_CLUSTER = 8  # CTAs a stream: the portable thread-block cluster size


def cluster_plan(m: int) -> tuple[int, int]:
    """(CTAs a stream, channels a CTA) of the CUDA kernel for M mics: one
    channel a CTA up to MAX_CLUSTER channels, two beyond, so no cluster
    passes the portable 8 CTAs. CTA r owns channels [r cpc, min(C, (r+1)
    cpc)), C = M - 1: every channel once, every CTA at least one."""
    c = m - 1
    cpc = 1 if c <= MAX_CLUSTER else 2
    return -(-c // cpc), cpc


def smem_bytes(l: int, cpc: int) -> int:
    """Shared memory a CTA of the CUDA kernel takes at block length l with
    cpc channels (``Layout`` in ``csrc/gsc_blocklms.cu``, which refuses any
    other figure): its ucat rows (3 words of pad and 1 behind) and their
    prefix of squares, the outputs and their prefix, the filters, mu out,
    its part of the beam, two published shares, 8 cpc l partials of the
    correlations, cpc + 1 mic rows, 32 of scan scratch."""
    n = K + l
    floats = (cpc * (n + 4) + cpc * n + 2 * n + cpc * K + cpc * l + l
              + 2 * l + 8 * cpc * l + (cpc + 1) * l + 32)
    return 4 * floats


def block_len(params) -> int:
    """``params.block_samples``, checked against :data:`VALID_BLOCKS`."""
    l = int(getattr(params, "block_samples", L) or L)
    if l not in VALID_BLOCKS:
        raise ValueError(
            f"block_samples={l} unsupported; choose one of {VALID_BLOCKS}")
    return l


def gsc_blocklms_plain(aligned, block, filt, last_out, params):
    """Block LMS for B streams: aligned (B, M, S) with S % l == 0, block
    and filt (B, M-1, K), last_out (B, K) -> (out (B, S), block', filt',
    last_out'), in the input's dtype (gsc_blocklms.py:285-341)."""
    p = params
    b, m, s = aligned.shape
    k = filt.shape[-1]
    l = block_len(p)
    if k != K or s % l:
        raise ValueError(f"block LMS takes {K} taps and a multiple of "
                         f"block_samples={l} samples, got K={k}, S={s}")
    dt, dev = aligned.dtype, aligned.device
    u = aligned[:, 1:] - aligned[:, :-1]                   # (B, C, S)
    das = aligned.mean(dim=1)                              # (B, S)
    idx = (torch.arange(l, device=dev)[:, None]
           + torch.arange(K, device=dev)[None, :] + 1)    # (l, K)
    kinv = 1.0 / k
    c_b, c_o = p.mu0 * p.mu0, p.mu_max * p.mu_max
    blk, flt, lo = block.to(dt), filt.to(dt), last_out.to(dt)
    outs = []
    for t0 in range(0, s, l):
        u_t = u[:, :, t0:t0 + l]
        ucat = torch.cat([blk, u_t], dim=-1)               # (B, C, K+l)
        u3 = ucat[:, :, idx]                               # (B, C, l, K)
        fir = torch.einsum("bcjk,bck->bj", u3, flt)
        out = das[:, t0:t0 + l] - fir                      # (B, l)

        posq = torch.cumsum(torch.cat([lo, out], dim=-1) ** 2, dim=-1)
        osq = posq[:, K:] - posq[:, :l]                    # (B, l)
        pbsq = torch.cumsum(ucat * ucat, dim=-1)
        bsq = pbsq[..., K:] - pbsq[..., :l]                # (B, C, l)

        cond = c_b * bsq < c_o * osq[:, None]
        pst = p.mu0 * torch.rsqrt(torch.clamp_min(osq * kinv, 0.0))
        pst = torch.where(pst < torch.inf, pst, 0.0)
        q = p.mu0 * torch.rsqrt(torch.clamp_min(bsq * kinv, 0.0))
        q = torch.where(q < torch.inf, q, 0.0)
        mu = torch.where(cond, pst[:, None], q)            # (B, C, l)
        if p.use_vad:
            last_pow = torch.sqrt(torch.clamp_min(osq * kinv, 0.0))
            mu = torch.where((last_pow < p.vad_threshold)[:, None], mu, 0.0)

        grad = torch.einsum("bcj,bcjk->bck", mu * out[:, None], u3)
        fnew = flt + grad
        flt = torch.where(torch.isnan(fnew), 0.0, fnew)
        blk = u_t[..., l - K:]
        lo = out[:, l - K:]
        outs.append(out)
    out = (torch.cat(outs, dim=-1) if outs
           else aligned.new_zeros((b, 0)))
    return out, blk.clone(), flt, lo.clone()


def gsc_blocklms_scan(aligned, block, filt, last_out, params):
    """Single stream: aligned (M, S), block/filt (M-1, K), last_out (K,)
    -> (out (S,), block', filt', last_out'), as the JAX function."""
    out, blk, flt, lo = gsc_blocklms_plain(aligned[None], block[None],
                                           filt[None], last_out[None], params)
    return out[0], blk[0], flt[0], lo[0]


def gsc_blocklms(aligned, block, filt, last_out, params):
    """Block LMS; see :func:`gsc_blocklms_plain` for the contract. On CUDA:
    float32, contiguous, K = 128, 2 to 16 mics, S a positive multiple of
    l; one launch, a thread-block cluster per stream (:func:`cluster_plan`)."""
    if not aligned.is_cuda:
        return gsc_blocklms_plain(aligned, block, filt, last_out, params)
    with span("bf.kernel.gsc_blocklms"):
        l = block_len(params)
        b, m, s = aligned.shape
        c = m - 1
        dev = aligned.device
        if not 2 <= m <= MAX_MICS:
            raise ValueError(f"the CUDA block-LMS kernel takes 2 to "
                             f"{MAX_MICS} mics, got {m}; run on the CPU")
        if filt.shape[-1] != K:
            raise ValueError(f"the CUDA block-LMS kernel takes filter_size "
                             f"{K}, got {filt.shape[-1]}")
        if s == 0 or s % l:
            raise ValueError(f"the CUDA block-LMS kernel takes a positive "
                             f"multiple of block_samples={l} samples, got {s}")
        check_tensor(aligned, "aligned", torch.float32, (b, m, s), dev)
        check_tensor(block, "block", torch.float32, (b, c, K), dev)
        check_tensor(filt, "filt", torch.float32, (b, c, K), dev)
        check_tensor(last_out, "last_out", torch.float32, (b, K), dev)
        if aligned.data_ptr() % 16:
            aligned = aligned.clone()    # the kernel copies 16-byte rows
        cs, cpc = cluster_plan(m)
        out = torch.empty((b, s), dtype=torch.float32, device=dev)
        blk_o, flt_o = torch.empty_like(block), torch.empty_like(filt)
        lo_o = torch.empty_like(last_out)
        with device_guard(dev):
            lib, stream = launch_context(dev)
            code = lib.bf_gsc_blocklms(
                aligned.data_ptr(), block.data_ptr(), filt.data_ptr(),
                last_out.data_ptr(), out.data_ptr(), blk_o.data_ptr(),
                flt_o.data_ptr(), lo_o.data_ptr(), b, m, s, l,
                int(params.use_vad), cs, cpc, smem_bytes(l, cpc),
                coef_array(params, m), stream)
        check(lib, code, "gsc_blocklms")
    gsc_blocklms.launches += 1
    return out, blk_o, flt_o, lo_o


gsc_blocklms.launches = 0
