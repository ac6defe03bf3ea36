"""Fused audio-to-audio GSS: the CUDA kernel's wrapper, its plain-torch
version, and the natural-gradient demixing update they share with the
model's ``scan`` path.

Counterpart of ``beamform_tpu/kernels/gss_stream.py``: :func:`gss_mega`
replaces ``_kernel`` (reached through ``gss_mega``). One call takes the
chunk's raw audio, the analysis tail, the overlap-add carry and the
demixing state W (NIB, S, M), and returns the separated audio (source 0)
with the new state and carry: analysis with the gate statistic, per frame
the reset W <- A^H on the frame's flag, y = W x with the pre-update W and
the update of :func:`gss_update` where the gate passes (gss.cpp:90-156),
and the half-spectrum synthesis, all in one launch
(``csrc/gss_stream.cu``; the spectra stay in L2, the active slots' W in
registers).

A slot is active when its row of A^H is nonzero (over the in-band bins and
mics, per control row); S_act, the number of active slots, scales the
gradient. A caller that already knows the active slots passes them as
``act_bits`` (:func:`active_bits`, built once with its cached controls);
without them both versions derive the bits from A^H. The band must hold neither bin 0 (GSS has no DC special case,
gss.cpp:110, and a complex y[0] would break the half-spectrum fold) nor the
Nyquist or shadow bin: :func:`gss_fits`.

Streams: one launch serves B streams that share the control rows (A^H and
the active bits): the audio, carries, W, control index and reset flags
gain a leading stream axis ((B, M, S), (B, M, hop), (B, hop),
(B, NIB, S, M), (B, T), (B, T)), and so do the outputs. The single-stream
form is B = 1 of the same kernel.

Routing: a CPU tensor takes the plain version (float32 or float64); a CUDA
tensor launches the kernel or raises. ``gss_mega.launches`` counts
launches.
"""

from __future__ import annotations

import torch

from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.kernels.mega_stream import (SEG_FRAMES, band_fits,
                                                    check_scratch,
                                                    half_spectrum_synthesis)
from beamform_tpu_torch.kernels.mvdr_stream import (MAX_MICS, MAX_SLOTS,
                                                    MAX_SMEM)
from beamform_tpu_torch.kernels.wola import (MAX_NFFT, MIN_NFFT,
                                             _analysis_tables, _tables,
                                             wola_analysis_plain)
from beamform_tpu_torch.utils.profiling import span


def gss_fits(m: int, ib, nfft: int, s_cap: int) -> bool:
    """The fused kernel's capacity rule: the band in [1, nfft / 2)
    (:func:`kernels.mega_stream.band_fits`), a power-of-two nfft in
    [256, 4096], M <= 32 mics and S = ``s_cap`` <= 16 source slots."""
    return band_fits(ib, nfft) and _kernel_fits(m, nfft, s_cap)


def _kernel_fits(m: int, nfft: int, s_cap: int) -> bool:
    """:func:`gss_fits` without the band, which the kernel checks on the
    card."""
    return (not nfft & (nfft - 1) and MIN_NFFT <= nfft <= MAX_NFFT
            and 1 <= m <= MAX_MICS and 1 <= s_cap <= MAX_SLOTS)


def smem_bytes(b: int, s_cap: int, nfft: int, seg: int) -> int:
    """Dynamic shared memory of one block (``csrc/gss_stream.cu``
    launch_gss): the larger of the analysing blocks' (17 x 256 padded FFT
    points, or one nfft-point frame) and the marching blocks' (the spectra
    ring, the slow path's rows past four slots, and each of the ``b``
    streams' ``seg`` control rows and reset flags)."""
    march = (4 + (2 * 16 if s_cap > 4 else 0)) * 256 * 8 + b * seg * 5
    return -(-max(17 * 256 * 8, nfft * 8, march) // 16) * 16


def active_bits(active) -> torch.Tensor:
    """(U, S) 0/1 or bool active slots -> (U,) int32, bit k of row u set
    when slot k of control row u is active."""
    bits = torch.arange(active.shape[-1], dtype=torch.int32,
                        device=active.device)
    return ((active != 0).to(torch.int32) << bits).sum(-1, dtype=torch.int32)


def _slot_bits(ah_ib, act_bits):
    """``act_bits``, or the bits of the rows of A^H (U, S, M, NIB) that are
    nonzero."""
    if act_bits is not None:
        return act_bits
    return active_bits((ah_ib != 0).flatten(2).any(-1))


def gss_update(w_sep, a_mat, a_h, x, gate, mu, lam, active_ext=None):
    """One GSS step over all carried bins (the JAX package's
    ``models/gss.gss_update``).

    w_sep (NIB, S, M); a_mat (NIB, M, S); a_h (NIB, S, M); x (M, NIB);
    gate (NIB,) bool. ``active_ext`` (S,) 0/1 masks source slots of the
    fixed-capacity design: the identity in dJ2 becomes diag(active_ext)
    and the source count S in the gradient constants the ACTIVE count
    (gss.cpp:132-133). Returns (new_w, y of source 0 (NIB,)).
    """
    s_cap = w_sep.shape[-2]
    eye = torch.eye(s_cap, dtype=w_sep.dtype, device=w_sep.device)
    if active_ext is None:
        eye_s, s_act = eye, float(s_cap)
    else:
        eye_s = torch.diag_embed(active_ext).to(w_sep.dtype)
        s_act = active_ext.sum()
    xt = x.movedim(0, -1)                                # (NIB, M)
    yf = torch.einsum("nsm,nm->ns", w_sep, xt)           # (NIB, S)
    e = yf[:, :, None] * yf.conj()[:, None, :] * (1.0 - eye)
    alpha = (xt.abs() ** 2).sum(-1) ** 2                 # (NIB,)
    ey = torch.einsum("nsk,nk->ns", e, yf)
    dj1 = (4.0 * s_act) * torch.einsum("ns,nm->nsm", ey, xt.conj())
    dj1 = dj1 / alpha[:, None, None]
    wa = torch.einsum("nsm,nmk->nsk", w_sep, a_mat)
    dj2 = (2.0 / s_act) * torch.einsum("nsk,nkm->nsm", wa - eye_s, a_h)
    w_new = (1.0 - lam * mu) * w_sep - mu * (dj1 + dj2)
    return torch.where(gate[:, None, None], w_new, w_sep), yf[:, 0]


def gss_march(x_ib, gate, w0, a_h, active, idx, reset, mu, lam):
    """The frame march of the scan path and of the plain version:
    x_ib (T, M, NIB) in-band spectra, gate (T, NIB), w0 (NIB, S, M), a_h
    (U, NIB, S, M) A^H per control row, active (U, S) 0/1, idx (T,) row
    per frame, reset (T,) bool. Per frame: W <- A^H on reset, then
    :func:`gss_update`; gated-off bins output 0.01 * x[mic 0]. Returns
    ((T, NIB) output, final W)."""
    a_mat = a_h.conj().transpose(-1, -2)                 # (U, NIB, M, S)
    w, ys = w0, []
    for t in range(x_ib.shape[0]):
        u = idx[t]
        w = torch.where(reset[t], a_h[u], w)             # gss.cpp:90-93
        w, y = gss_update(w, a_mat[u], a_h[u], x_ib[t], gate[t], mu, lam,
                          active[u])
        ys.append(torch.where(gate[t], y, 0.01 * x_ib[t, 0]))
    return torch.stack(ys), w


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def gss_mega_plain(x, tail, out_prev, w0, ah_ib, idx, reset, ib,
                   mag_threshold: float, mu: float, lam: float,
                   act_bits=None):
    """The kernel's plain version.

    x (M, T*hop) audio; tail (M, hop); out_prev (hop,); w0 (NIB, S, M)
    demixing state over the in-band bins ``ib``; ah_ib (U, S, M, NIB) A^H
    per control row; idx (T,) row per frame; reset (T,) bool; act_bits
    (U,) int32 active slots (:func:`active_bits`), derived from A^H when
    None. Returns ((T*hop,) audio, new W, new out_prev). With a stream axis
    (x (B, M, T*hop), tail (B, M, hop), out_prev (B, hop), w0 (B, NIB, S,
    M), idx and reset (B, T)) each stream's plain version, stacked.
    """
    if x.dim() == 3:
        outs = [gss_mega_plain(x[b], tail[b], out_prev[b], w0[b], ah_ib,
                               idx[b], reset[b], ib, mag_threshold, mu, lam,
                               act_bits)
                for b in range(x.shape[0])]
        return tuple(torch.stack(parts) for parts in zip(*outs))
    spec, mag, _ = wola_analysis_plain(x, tail, with_mag=True)
    x_ib = spec.index_select(2, ib)
    gate = mag.index_select(1, ib) > mag_threshold
    slots = torch.arange(w0.shape[1], dtype=torch.int32, device=x.device)
    active = ((_slot_bits(ah_ib, act_bits)[:, None] >> slots) & 1).to(
        x.dtype)                                          # (U, S)
    y_ib, w = gss_march(x_ib, gate, w0, ah_ib.permute(0, 3, 1, 2), active,
                        idx, reset, mu, lam)
    audio, prev = half_spectrum_synthesis(
        y_ib, y_ib.new_zeros(y_ib.shape[0]), ib, out_prev,
        2 * tail.shape[-1])
    return audio, w, prev


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


def gss_mega(x, tail, out_prev, w0, ah_ib, idx, reset, ib, nfft: int,
             mag_threshold: float, mu: float, lam: float, act_bits=None):
    """Fused GSS step (the contract of the JAX package's ``gss_mega``); see
    :func:`gss_mega_plain`. x (M, S) with S a multiple of hop; returns
    (audio (S,), w (NIB, S, M), out_prev' (hop,)); with a stream axis one
    launch serves the B streams. On CUDA: float32 audio and carries,
    complex64 state and A^H, int64 idx and ib, bool reset, int32 act_bits,
    contiguous, within :func:`gss_fits`, a block's shared memory
    (:func:`smem_bytes`) and the scratch limit
    (``mega_stream.check_scratch``); the bins are checked on the card (one
    outside [1, nfft / 2) gives NaN output), so the call never
    synchronises."""
    hop = nfft // 2
    if tail.shape[-1] != hop or x.shape[-1] % hop:
        raise ValueError(f"nfft {nfft} disagrees with tail "
                         f"{tuple(tail.shape)} or x {tuple(x.shape)}")
    if x.shape[-1] < hop:                # no whole hop: nothing to march
        return out_prev.new_zeros(out_prev.shape[:-1] + (0,)), w0, out_prev
    if not x.is_cuda:
        return gss_mega_plain(x, tail, out_prev, w0, ah_ib, idx, reset, ib,
                              mag_threshold, mu, lam, act_bits)
    with span("bf.kernel.gss_mega"):
        m, s = x.shape[-2:]
        lead = tuple(x.shape[:-2])              # (B,), or () for one stream
        b = lead[0] if lead else 1
        t = s // hop
        nib, s_cap = w0.shape[-3:-1]
        u = ah_ib.shape[0]
        if not (_kernel_fits(m, nfft, s_cap) and nib >= 1 and u >= 1
                and b >= 1):
            raise ValueError(
                f"the CUDA fused GSS kernel takes a power-of-two nfft in "
                f"[{MIN_NFFT}, {MAX_NFFT}], M <= {MAX_MICS} mics, S <= "
                f"{MAX_SLOTS} source slots and a nonempty band, control and "
                f"batch, got nfft={nfft}, M={m}, S={s_cap}, NIB={nib}, U={u}, "
                f"B={b}")
        seg = min(SEG_FRAMES, t)
        if smem_bytes(b, s_cap, nfft, seg) > MAX_SMEM:
            raise ValueError(
                f"the CUDA fused GSS kernel stages each stream's control "
                f"rows in a block's shared memory: {b} streams of {seg} "
                f"frames take {smem_bytes(b, s_cap, nfft, seg)} bytes, past "
                f"{MAX_SMEM}; serve fewer streams a call")
        dev = x.device
        check_tensor(x, "x", torch.float32, lead + (m, s), dev)
        check_tensor(tail, "tail", torch.float32, lead + (m, hop), dev)
        check_tensor(out_prev, "out_prev", torch.float32, lead + (hop,), dev)
        check_tensor(w0, "w0", torch.complex64, lead + (nib, s_cap, m), dev)
        check_tensor(ah_ib, "ah_ib", torch.complex64, (u, s_cap, m, nib), dev)
        check_tensor(idx, "idx", torch.int64, lead + (t,), dev)
        check_tensor(reset, "reset", torch.bool, lead + (t,), dev)
        check_tensor(ib, "ib", torch.int64, (nib,), dev)
        act = _slot_bits(ah_ib, act_bits)
        check_tensor(act, "act_bits", torch.int32, (u,), dev)
        check_scratch("fused GSS", 2 * b * seg * nib * (m + 1) * 8, dev)
        win, tw = _tables(nfft, dev)
        ptw = _analysis_tables(nfft, dev)[1]
        out = torch.empty(lead + (t * hop,), dtype=torch.float32, device=dev)
        new_prev = torch.empty(lead + (hop,), dtype=torch.float32, device=dev)
        w_out = torch.empty_like(w0)
        xsc = torch.empty((2, b, seg, nib, m), dtype=torch.complex64,
                          device=dev)
        ys = torch.empty((2, b, seg, nib), dtype=torch.complex64, device=dev)
        with device_guard(dev):
            lib, stream = launch_context(dev)
            code = lib.bf_gss_stream(
                x.data_ptr(), tail.data_ptr(), out_prev.data_ptr(),
                w0.data_ptr(), ah_ib.data_ptr(), act.data_ptr(),
                idx.data_ptr(), reset.data_ptr(), ib.data_ptr(),
                win.data_ptr(), tw.data_ptr(), ptw.data_ptr(),
                out.data_ptr(), new_prev.data_ptr(), w_out.data_ptr(),
                xsc.data_ptr(), ys.data_ptr(), b, m, t, hop, nib, u, s_cap,
                seg, float(mag_threshold), float(mu), float(lam), stream)
        check(lib, code, "gss_stream")
    gss_mega.launches += 1
    return out, w_out, new_prev


gss_mega.launches = 0
