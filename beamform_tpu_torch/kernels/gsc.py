"""GSC's per-sample adaptive stage: the CUDA kernel's wrappers (the
faithful ``sample`` recurrence and its ``xmu`` mode) and their plain-torch
version.

Counterpart of ``beamform_tpu/kernels/gsc_pallas.py``:

* :func:`gsc_sample` replaces ``_kernel`` (via
  ``gsc_adaptive_pallas_batched``): per sample, the blocking matrix
  u_c = a_{c+1} - a_c shifts into a K-tap register per channel, the fixed
  beam is the mic mean, out = das - sum_c <g_c, b_c>; the dynamic step
  size in the squared domain, mu_c = mu0 / sqrt(osq / K) if
  mu0^2 bsq_c < mu_max^2 osq else mu0 / sqrt(bsq_c / K) (one rsqrt, a
  non-finite step is 0), g_c += mu_c out b_c, NaN filter taps to 0, and
  with ``use_vad`` the update only while sqrt(osq / K) < vad_threshold
  (gsc.cpp:120-179). bsq_c and osq are the powers of the K newest u_c and
  outputs, fresh sums as in the reference (the TPU kernel's running sums
  do not return to 0 when a window falls silent): the kernel forms each
  128-sample tile's bsq_c before the tile's chain and osq per sample.
* :func:`gsc_xmu` replaces ``_kernel_xmu`` (via
  ``gsc_adaptive_pallas_xmu``): the same recurrence, with the input-only
  terms (c_b bsq_c and the q-branch steps mu0 / sqrt(bsq_c / K), exact
  windowed sums) computed outside the kernel by :func:`xmu_inputs` and
  streamed in packed with the audio.

Both modes compute one function; :func:`gsc_sample_plain` is the plain
version of both (the per-sample recurrence of ``models/gsc.py``
``gsc_sample_step``, with fresh power sums each sample), in float32 or
float64 and for any tap count. With ``with_mu`` the kernel and the plain
version also return the reference's mu trace: channel 0's step size and
the update flag per sample (gsc.cpp:171-174).

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (float32, K = 128 taps, 2 to 16 mics, S a multiple of 128) or
raises. Each wrapper counts its launches in ``.launches``. The kernel runs
the recurrence in groups of 8 samples by an exact lookahead factorisation
and replays a group sample by sample where a step's output or step product
is not finite or a channel is on the q branch with a non-zero update
(``csrc/gsc_sample.cu``); ``gsc_sample.group_counts()`` synchronises and
returns the groups run factorised and those replayed, summed over every
launch of both modes and every device so far. The counts live on the
device, one atomic add each per block and launch, and are never read on
the hot path.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.utils.profiling import span

K = 128            # the kernel's taps (the reference default, gsc.cpp:219)
TILE = 128         # samples per tile of the kernel's staging
MAX_MICS = 16
_GROUP_COUNTS: dict = {}   # device -> (2,) int64: groups factorised, replayed


def window_sums(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = sum(x[..., i:i + k]) for i in 0 .. n - k, by doubling
    (pairs, fours, ...) over the binary digits of ``k``: every sum is
    formed fresh from its own terms, so no round-off accumulates along the
    signal as with differences of a cumulative sum."""
    n = x.shape[-1]
    out, off, width, level = None, 0, 1, x
    while True:
        if k & width:
            part = level[..., off:off + n - k + 1]
            out = part if out is None else out + part
            off += width
        if 2 * width > k:
            return out
        level = level[..., :-width] + level[..., width:]
        width *= 2


def block_powers(block: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """bsq (..., C, S): the power of each channel's K-tap register after
    each new sample, from the register before the chunk (..., C, K) and
    the chunk's blocking-matrix samples (..., C, S)."""
    k = block.shape[-1]
    ue = torch.cat([block[..., 1:].to(u.dtype), u], dim=-1)
    return window_sums(ue * ue, k)


def gsc_sample_plain(aligned, block, filt, last_out, params,
                     with_mu: bool = False):
    """The per-sample recurrence for B streams: aligned (B, M, S), block
    and filt (B, M-1, K), last_out (B, K) -> (out (B, S), block', filt',
    last_out'), and with ``with_mu`` also (mu of channel 0 (B, S), update
    flag (B, S) bool). Float32 or float64, any K.

    The registers are views into one [history | chunk] tensor per stream,
    so a step costs no copy: the K-tap window of sample t is
    ``ue[..., t+1:t+1+K]``."""
    p = params
    b, m, s = aligned.shape
    k = filt.shape[-1]
    dt = aligned.dtype
    u = aligned[:, 1:] - aligned[:, :-1]                   # (B, C, S)
    das = aligned.mean(dim=1)                              # (B, S)
    ue = torch.cat([block.to(dt), u], dim=-1)              # (B, C, K+S)
    bsq = block_powers(block.to(dt), u)                    # (B, C, S)
    oe = torch.cat([last_out.to(dt), das.new_zeros((b, s))], dim=-1)
    flt = filt.to(dt)
    kinv = 1.0 / k
    c_b, c_o = p.mu0 * p.mu0, p.mu_max * p.mu_max
    mu_tr, upd_tr = [], []
    upd = torch.ones((b,), dtype=torch.bool, device=das.device)
    for t in range(s):
        bw = ue[:, :, t + 1:t + 1 + k]
        out = das[:, t] - (flt * bw).sum(dim=(1, 2))
        oe[:, k + t] = out
        lo = oe[:, t + 1:t + 1 + k]
        osq = (lo * lo).sum(dim=-1)                        # (B,)
        bs = bsq[:, :, t]
        cond = c_b * bs < c_o * osq[:, None]
        den = torch.where(cond, osq[:, None], bs) * kinv
        mu = p.mu0 * torch.rsqrt(den)
        mu = torch.where(mu < torch.inf, mu, 0.0)          # (B, C)
        new = flt + (mu * out[:, None])[..., None] * bw
        new = torch.where(torch.isnan(new), 0.0, new)
        if p.use_vad:
            upd = torch.sqrt(osq * kinv) < p.vad_threshold
            flt = torch.where(upd[:, None, None], new, flt)
        else:
            flt = new
        if with_mu:
            mu_tr.append(mu[:, 0])
            upd_tr.append(upd)
    res = (oe[:, k:], ue[:, :, -k:].clone(), flt, oe[:, -k:].clone())
    if not with_mu:
        return res
    if s == 0:
        return res + ((das.new_zeros((b, 0)),
                       torch.ones((b, 0), dtype=torch.bool,
                                  device=das.device)),)
    return res + ((torch.stack(mu_tr, dim=-1),
                   torch.stack(upd_tr, dim=-1).expand(b, s)),)


def xmu_inputs(aligned, block, params) -> torch.Tensor:
    """The xmu mode's packed input (B, 3M-2, S): the audio (M rows), c_b
    bsq_c (M-1 rows; c_b = mu0^2 / K) and the q-branch steps
    mu0 / sqrt(bsq_c / K), 0 where not finite (M-1 rows), bsq_c exact
    windowed sums over [register | chunk] (gsc_pallas.py:304-314)."""
    k = block.shape[-1]
    u = aligned[:, 1:] - aligned[:, :-1]
    bsq = block_powers(block, u)
    q = params.mu0 * torch.rsqrt(torch.clamp_min(bsq * (1.0 / k), 0.0))
    q = torch.where(q < torch.inf, q, 0.0)
    cb = (params.mu0 * params.mu0 / k) * bsq
    return torch.cat([aligned, cb, q], dim=1).contiguous()


@lru_cache(maxsize=16)
def vad_power_threshold(vad: float, k: int = K) -> float:
    """The least float32 y >= 0 with sqrt(y * (1/k)) >= vad in float32
    arithmetic, found by bisection over the bit patterns of [0, inf]: for
    every float32 osq, ``osq < threshold`` decides as
    ``sqrtf(max(osq, 0) / k) < vad`` does (a NaN compares false in both),
    so the kernel takes no square root. -inf when no y qualifies (a NaN
    ``vad``: no sample updates)."""
    v = np.float32(vad)
    kinv = np.float32(1.0 / k)

    def reaches(bits: int) -> bool:
        y = np.array(bits, dtype=np.uint32).view(np.float32)
        return bool(np.sqrt(y * kinv) >= v)

    lo, hi = 0, 0x7F800000                    # +0.0 .. +inf
    if not reaches(hi):
        return float("-inf")
    while lo < hi:
        mid = (lo + hi) // 2
        if reaches(mid):
            hi = mid
        else:
            lo = mid + 1
    return float(np.array(lo, dtype=np.uint32).view(np.float32))


def coef_array(params, m: int):
    """The GSC kernels' float coefficients: 1/K, mu0^2/K, mu_max^2/K, mu0,
    vad_threshold, 1/M, and the VAD threshold on osq that the kernels test
    (:func:`vad_power_threshold`)."""
    vals = (1.0 / K, params.mu0 * params.mu0 / K,
            params.mu_max * params.mu_max / K, params.mu0,
            params.vad_threshold, 1.0 / m,
            vad_power_threshold(params.vad_threshold))
    return (ctypes.c_float * len(vals))(*vals)


def check_shape(m: int, k: int, s: int):
    """Raise unless the CUDA per-sample kernels take M mics, K taps and S
    samples (the lookahead-8 kernel takes the same)."""
    if not 2 <= m <= MAX_MICS:
        raise ValueError(f"the CUDA GSC kernel takes 2 to {MAX_MICS} mics, "
                         f"got {m}; run on the CPU")
    if k != K:
        raise ValueError(f"the CUDA GSC kernel takes filter_size {K}, got "
                         f"{k}; other sizes run on the CPU")
    if s % TILE:
        raise ValueError(f"the CUDA GSC kernel takes a multiple of {TILE} "
                         f"samples, got {s}")


def _launch(inp, aligned_shape, block, filt, last_out, params, xmu: bool,
            with_mu: bool, what: str):
    b, m, s = aligned_shape
    c = m - 1
    dev = inp.device
    check_shape(m, filt.shape[-1], s)
    rows = 3 * m - 2 if xmu else m
    check_tensor(inp, "packed input" if xmu else "aligned", torch.float32,
                 (b, rows, s), dev)
    check_tensor(block, "block", torch.float32, (b, c, K), dev)
    check_tensor(filt, "filt", torch.float32, (b, c, K), dev)
    check_tensor(last_out, "last_out", torch.float32, (b, K), dev)
    if inp.data_ptr() % 16:
        inp = inp.clone()            # the kernel copies 16-byte rows
    out = torch.empty((b, s), dtype=torch.float32, device=dev)
    blk_o, flt_o = torch.empty_like(block), torch.empty_like(filt)
    lo_o = torch.empty_like(last_out)
    mu = torch.empty((b, s), dtype=torch.float32, device=dev) if with_mu \
        else None
    upd = torch.empty((b, s), dtype=torch.bool, device=dev) if with_mu \
        else None
    if b and s:
        with device_guard(dev):
            counts = _GROUP_COUNTS.get(dev)
            if counts is None:
                counts = _GROUP_COUNTS[dev] = torch.zeros(
                    2, dtype=torch.int64, device=dev)
            lib, stream = launch_context(dev)
            code = lib.bf_gsc_sample(
                inp.data_ptr(), block.data_ptr(), filt.data_ptr(),
                last_out.data_ptr(), out.data_ptr(), blk_o.data_ptr(),
                flt_o.data_ptr(), lo_o.data_ptr(),
                mu.data_ptr() if with_mu else None,
                upd.data_ptr() if with_mu else None, counts.data_ptr(), b,
                m, s, int(xmu), int(params.use_vad), coef_array(params, m),
                stream)
        check(lib, code, what)
    else:
        blk_o.copy_(block)
        flt_o.copy_(filt)
        lo_o.copy_(last_out)
    res = (out, blk_o, flt_o, lo_o)
    return res + ((mu, upd),) if with_mu else res


def gsc_sample(aligned, block, filt, last_out, params,
               with_mu: bool = False):
    """The faithful per-sample adaptive stage; see :func:`gsc_sample_plain`
    for the contract. On CUDA: float32, contiguous, K = 128, 2 to 16 mics,
    S a multiple of 128; one launch, six warps per stream (one on the
    scalar chain, five on the taps and the tables)."""
    if not aligned.is_cuda:
        return gsc_sample_plain(aligned, block, filt, last_out, params,
                                with_mu)
    with span("bf.kernel.gsc_sample"):
        res = _launch(aligned, aligned.shape, block, filt, last_out, params,
                      False, with_mu, "gsc_sample")
    gsc_sample.launches += 1
    return res


def gsc_xmu(aligned, block, filt, last_out, params, with_mu: bool = False):
    """The xmu mode: :func:`xmu_inputs` in plain torch, then the kernel
    reads c_b bsq_c and the q-branch steps from its input instead of
    forming them per tile. Same contract as :func:`gsc_sample`; on the CPU
    the plain recurrence."""
    if not aligned.is_cuda:
        return gsc_sample_plain(aligned, block, filt, last_out, params,
                                with_mu)
    with span("bf.kernel.gsc_xmu"):
        if aligned.dtype != torch.float32:
            raise ValueError(f"aligned has dtype {aligned.dtype}, the CUDA "
                             "GSC kernel takes float32; float64 runs on the "
                             "CPU only")
        packed = xmu_inputs(aligned, block, params)
        res = _launch(packed, aligned.shape, block, filt, last_out, params,
                      True, with_mu, "gsc_xmu")
    gsc_xmu.launches += 1
    return res


def group_counts() -> tuple[int, int]:
    """(groups run factorised, groups replayed sample by sample) by the
    CUDA kernel so far, in both modes, over every launch and device;
    (0, 0) before the first. Synchronises."""
    fact = rep = 0
    for counts in _GROUP_COUNTS.values():
        f, r = counts.tolist()
        fact, rep = fact + f, rep + r
    return fact, rep


gsc_sample.launches = 0
gsc_sample.group_counts = group_counts
gsc_xmu.launches = 0
