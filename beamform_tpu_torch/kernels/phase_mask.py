"""Phase-mask, MPF and MCRA kernels: the CUDA kernels' wrappers, their
plain-torch versions, and the MCRA/MPF recurrences they share with the
models.

Counterpart of ``beamform_tpu/kernels/phase_mask.py``:

* :func:`phase_mask` replaces ``_phase_kernel`` (via ``phase_mask_pallas``):
  per (frame, bin) conj(w) x per mic, the atan2 of each aligned product,
  the mean wrapped pair distance over the M(M-1)/2 mic pairs, the mean |X|,
  the gate ``mag_mean / nfft > mag_threshold and diff < min_phase``, the
  mean magnitude kept or times ``mag_mult`` at mic 0's phase, rebuilt
  without trigonometry as x0 / |x0|; bin 0 carries X0[0]
  (phase.cpp:70-134).
* :func:`mpf_march` replaces ``_mpf_kernel`` (via
  ``phasempf_march_pallas``): the same front end, the dual SOI and
  interference beams (phasempf.cpp:210-248), the buggy frequency smoothing
  (bin 1 x 0.75, bin 0 = |X0[0]|, phasempf.cpp:144-153) and the per-frame
  MCRA + MPF march (phasempf.cpp:140-191, 255-295). On CUDA one call is two
  launches (``csrc/phase_mask.cu``): the front end over every (frame, bin),
  then the march (``csrc/march.cuh``), whose serial chain a frame is the
  noise update alone.
* :func:`mcra_march` replaces the MCRA node's ``lax.scan``
  (``beamform_tpu/models/mcra.py``), which has no Pallas kernel: the MCRA
  recurrence per bin over the frames and the spectral subtraction at the
  input phase (mcra.cpp:95-127).

The recurrences are written once, here, on the models' states
(:class:`McraState`, :class:`MpfState`: per-bin vectors, ``current_l`` a
0-d int32 and ``first_l`` a 0-d bool, in the JAX package's field order).
The CUDA marches read the state's float32 vectors and its ``current_l``
and ``first_l`` in place and write a new state (its vectors rows of one
buffer); ``csrc/march.cuh`` holds their algebra, each op rounded in the
order ``_mcra_step`` takes it, so that no rounding depends on where a
segment or a call starts.

Numerics: the plain versions repeat the kernels' algebra (torch's atan2,
the output phase as x0 / |x0|). The kernels take atan2 from
``csrc/atan2_fast.cuh`` (the TPU kernel's branch-free form, within 3.5
ulp of float64's) and sum min(|d|, 2 pi - |d|) over the pairs as the
plain version sums its wrapped distances, so a binary mask flips where a bin's mean pair distance lies within ~1e-6 rad
of ``min_phase``; in the MPF march such a flip also enters the state and
decays over the following frames.
Kernel and plain version are held to each other, and to the JAX package,
under the JAX package's contract for this (tests/test_phase_mask.py
``assert_close_mod_flips``).

Streams: each function takes one stream or B, as the JAX package's vmap
gives each kernel a grid axis. B streams' spectra are (T, B, M, NB) as
``models/common.stft_streams_carry`` returns them (MCRA's inputs (T, B,
NB), mic 0's), read in place; ``w_idx`` is (B, T) into one shared
steering; outputs are (B, T, NB), the synthesis' channels; a state's
vectors are (B, NB) and its ``current_l`` and ``first_l`` (B,). One launch
serves the B streams, and each stream's output equals its own call's bit
for bit. The plain versions take the stream axis as a leading broadcast
dimension, with no loop over streams.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``.launches``, one a
call whatever B is.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from beamform_tpu_torch.kernels._build import (check, check_tensor,
                                               device_guard, launch_context)
from beamform_tpu_torch.utils.profiling import span

MAX_MICS = 32
#: streams one launch takes (the marches' grid y extent)
MAX_STREAMS = 65535
# flags of the MPF and MCRA march kernels
_ONLY_NOISE, _ONLY_MCRA, _DC_ZERO = 1, 2, 4


class McraState(NamedTuple):
    s_prev: torch.Tensor     # (N,), or (B, N) for B streams
    s_tmp: torch.Tensor      # (N,)
    s_min: torch.Tensor      # (N,)
    lam: torch.Tensor        # (N,) noise estimate
    current_l: torch.Tensor  # 0-d int32, or (B,)
    first_l: torch.Tensor    # 0-d bool, or (B,)


class MpfState(NamedTuple):
    s_prev: torch.Tensor
    s_tmp: torch.Tensor
    s_min: torch.Tensor
    lam_noise: torch.Tensor
    z: torch.Tensor
    lam_rev0: torch.Tensor
    lam_rev1: torch.Tensor
    current_l: torch.Tensor  # 0-d int32
    first_l: torch.Tensor    # 0-d bool


def init_state(cls, nb: int, rdtype, device=None):
    """A fresh :class:`McraState` or :class:`MpfState`: zero vectors of
    ``nb`` bins, ``current_l`` 0, ``first_l`` True."""
    vecs = [torch.zeros((nb,), dtype=rdtype, device=device)
            for _ in range(len(cls._fields) - 2)]
    return cls(*vecs, torch.tensor(0, dtype=torch.int32, device=device),
               torch.tensor(True, device=device))


# ---------------------------------------------------------------------------
# the recurrences (plain torch; the models' batched paths use them too)
# ---------------------------------------------------------------------------


def _mcra_step(s_prev, s_tmp, s_min, lam, current_l, first_l, s_f, sq,
               a_s, a_d, a_d2, delta, big_l):
    """One MCRA step over all bins (mcra.cpp:95-124): temporal smoothing,
    minima tracking with rollover past ``big_l`` windows, the gated
    two-rate noise update. Returns the six new state fields. Elementwise
    over bins: B streams' vectors (B, N) take ``current_l`` and
    ``first_l`` as (B, 1)."""
    s = a_s * s_prev + (1.0 - a_s) * s_f
    rollover = current_l > big_l
    s_min = torch.where(rollover, torch.minimum(s_tmp, s),
                        torch.minimum(s_min, s))
    s_tmp = torch.where(rollover, s, torch.minimum(s_tmp, s))
    current_l = torch.where(rollover, torch.ones_like(current_l),
                            current_l + 1)
    first_l = first_l & ~rollover
    cond = first_l | (s < s_min * delta) | (lam > sq)
    inv_l = 1.0 / current_l.to(sq.dtype)
    use_first = first_l & (inv_l > a_d)
    lam_first = inv_l * lam + (1.0 - inv_l) * sq
    lam_norm = a_d2 * lam + (1.0 - a_d) * sq
    lam = torch.where(cond, torch.where(use_first, lam_first, lam_norm), lam)
    return s, s_tmp, s_min, lam, current_l, first_l


def mcra_update(state: McraState, s_f, sq, p):
    """One MCRA recurrence step over all bins (mcra.cpp:95-124) with the
    node's :class:`McraParams` ``p``. Returns (new_state, lambda after the
    update)."""
    new = McraState(*_mcra_step(*state, s_f, sq, p.alphaS, p.alphaD,
                                p.alphaD2, p.delta, p.L))
    return new, new.lam


def mpf_update(st: MpfState, s_f, soi_sq, int_sq, p):
    """One PhaseMPF step over all bins with :class:`PhasempfParams` ``p``:
    the embedded MCRA on the SOI power (phasempf.cpp:140-191), the leakage
    and the two reverberation estimates (phasempf.cpp:255-270, with the
    reference's ``1 - gamma/delta``). Returns (new_state, lambda = sqrt(
    noise + leak + rev0 + rev1))."""
    mc = _mcra_step(st.s_prev, st.s_tmp, st.s_min, st.lam_noise,
                    st.current_l, st.first_l, s_f, soi_sq, p.MCRA_alphaS,
                    p.MCRA_alphaD, p.MCRA_alphaD2, p.MCRA_delta, p.MCRA_L)
    z = p.MPF_alphaS * st.z + (1 - p.MPF_alphaS) * int_sq
    leak = p.MPF_eta * z
    rev_c = 1.0 - p.MPF_rev_gamma / p.MPF_rev_delta   # faithful quirk
    rev0 = p.MPF_rev_gamma * st.lam_rev0 + rev_c * soi_sq
    rev1 = p.MPF_rev_gamma * st.lam_rev1 + rev_c * int_sq
    lam = torch.sqrt(mc[3] + leak + rev0 + rev1)
    return MpfState(*mc[:4], z, rev0, rev1, *mc[4:]), lam


def mpf_out_mag(mag_soi, lam, lam_noise, p):
    """The PhaseMPF output magnitude (phasempf.cpp:273-295): the noise
    estimate alone, or the SOI magnitude less it (``out_only_mcra``: less
    the MCRA noise alone), with the noise floor where that is negative."""
    if p.out_only_noise:
        return lam * p.out_amp
    sub = torch.sqrt(lam_noise) if p.out_only_mcra else lam
    mag = (mag_soi - sub) * p.out_amp
    return torch.where(mag < 0, p.noise_floor, mag)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def _abs(z: torch.Tensor) -> torch.Tensor:
    """|z| as the kernels compute it, sqrt(re^2 + im^2)."""
    return torch.sqrt(z.real * z.real + z.imag * z.imag)


def _unit(z: torch.Tensor) -> torch.Tensor:
    """z / |z|, and 1 where z is 0: cos and sin of atan2(z) without
    trigonometry."""
    a = _abs(z)
    inv = torch.where(a > 0, 1.0 / a, torch.zeros_like(a))
    return torch.complex(torch.where(a > 0, z.real * inv,
                                     torch.ones_like(a)), z.imag * inv)


def _front_end(spec, w_uniq, w_idx):
    """(T, M, NB) spectra, (U, M, NB) steering, (T,) row per frame -> the
    mean wrapped pair distance of the aligned phases (T, NB), the mean
    |X| over mics (T, NB) and mic 0's spectrum (T, NB); or B streams:
    (T, B, M, NB) spectra and (B, T) rows -> (T, B, NB) each."""
    m = spec.shape[-2]
    if m < 2:
        raise ValueError(f"the phase mask needs at least 2 mics, got {m}")
    # the streams' rows in the spectra's (T, B) order
    w = (w_uniq if w_uniq.shape[0] == 1
         else w_uniq[w_idx if spec.dim() == 3 else w_idx.T])
    ar = w.real * spec.real + w.imag * spec.imag        # conj(w) * x
    ai = w.real * spec.imag - w.imag * spec.real
    ph = torch.atan2(ai, ar)
    acc = torch.zeros_like(ph[..., 0, :])
    for i in range(m - 1):                               # phase.cpp:57-61
        d = (ph[..., i:i + 1, :] - ph[..., i + 1:, :]).abs()
        acc = acc + torch.where(d > math.pi, 2.0 * math.pi - d, d).sum(-2)
    diff_mean = acc * (1.0 / (m * (m - 1) // 2))
    mag_mean = _abs(spec).sum(-2) * (1.0 / m)
    return diff_mean, mag_mean, spec[..., 0, :]


def _streams_first(y):
    """A plain version's (T, B, ...) result -> (B, T, ...), contiguous; one
    stream's (T, NB) as it is."""
    return y if y.dim() == 2 else y.movedim(0, 1).contiguous()


def phase_mask_plain(spec, w_uniq, w_idx, min_phase_rad: float,
                     mag_threshold: float, mag_mult: float, nfft: int):
    """The phase-mask kernel's plain version: spec (T, M, NB) complex,
    w_uniq (U, M, NB) steering, w_idx (T,) -> y (T, NB) complex; or B
    streams, spec (T, B, M, NB) and w_idx (B, T) -> y (B, T, NB)."""
    diff, mag, x0 = _front_end(spec, w_uniq, w_idx)
    keep = (mag * (1.0 / nfft) > mag_threshold) & (diff < min_phase_rad)
    y = torch.where(keep, mag, mag * mag_mult) * _unit(x0)
    y[..., 0] = x0[..., 0]                               # phase.cpp:87
    return _streams_first(y)


def _mpf_planes(spec, w_uniq, w_idx, min_phase_rad: float, min_mag: float):
    """The MPF front end: (SOI magnitude, interference power (0 at bin 0),
    mic 0's unit phase (X0[0] itself at bin 0)), each (T, NB), or (T, B,
    NB) for B streams."""
    diff, mag, x0 = _front_end(spec, w_uniq, w_idx)
    is_soi = diff < min_phase_rad
    soi_mag = torch.where(is_soi, mag, mag * min_mag)
    int_mag = torch.where(is_soi, mag * min_mag, mag)
    int_sq = int_mag * int_mag
    int_sq[..., 0] = 0.0
    u = _unit(x0)
    u[..., 0] = x0[..., 0]
    return soi_mag, int_sq, u


def march_frames(state, frames: int, step):
    """A march's frame loop from ``state``: ``step(state, t) -> (state,
    outputs)`` for t in 0 .. frames - 1, with ``current_l`` and
    ``first_l`` as (B, 1) where the state holds B streams (as (1,) where
    they are 0-d), so that they broadcast over the bins. Returns (the new
    state, its counters in their own shape again, and each output stacked
    over the frames on a leading axis)."""
    lead = tuple(state.current_l.shape)
    state = state._replace(current_l=state.current_l.reshape(lead + (1,)),
                           first_l=state.first_l.reshape(lead + (1,)))
    outs = []
    for t in range(frames):
        state, o = step(state, t)
        outs.append(o)
    state = state._replace(current_l=state.current_l.reshape(lead),
                           first_l=state.first_l.reshape(lead))
    return state, [torch.stack(z) for z in zip(*outs)]


def mpf_march_plain(spec, w_uniq, w_idx, state: MpfState, p,
                    bug_dc_zero: bool):
    """The MPF kernels' plain version: spec (T, M, NB), w_uniq (U, M, NB),
    w_idx (T,), the state, :class:`PhasempfParams` ``p`` -> (y (T, NB),
    new state); or B streams, spec (T, B, M, NB), w_idx (B, T), the
    state's vectors (B, NB) -> y (B, T, NB)."""
    soi_mag, int_sq, u = _mpf_planes(spec, w_uniq, w_idx,
                                     p.min_phase * math.pi / 180.0, p.min_mag)
    soi_sq = soi_mag * soi_mag
    soi_sq[..., 0] = 0.0
    s_f = soi_sq.clone()
    s_f[..., 1] *= 0.75                    # phasempf.cpp:150's scaling
    s_f[..., 0] = _abs(u[..., 0])

    def step(st, t):
        st, lam = mpf_update(st, s_f[t], soi_sq[t], int_sq[t], p)
        return st, (lam, st.lam_noise)

    state, (lams, noises) = march_frames(state, spec.shape[0], step)
    y = mpf_out_mag(soi_mag, lams, noises, p) * u
    y[..., 0] = 0.0 if bug_dc_zero else u[..., 0]
    return _streams_first(y), state


def mcra_march_plain(s_f, sq, x, state: McraState, p, bug_dc_zero: bool):
    """The MCRA march kernel's plain version: s_f (T, NB) smoothed power,
    sq (T, NB) power, x (T, NB) mic 0's spectrum, the state,
    :class:`McraParams` ``p`` -> (y (T, NB), new state); or B streams,
    s_f, sq and x (T, B, NB), the state's vectors (B, NB) -> y (B, T,
    NB)."""
    def step(st, t):
        st, lam = mcra_update(st, s_f[t], sq[t], p)
        return st, (lam,)

    state, (lams,) = march_frames(state, x.shape[0], step)
    noise = torch.sqrt(lams)
    if p.out_only_noise:
        mag = noise * p.out_amp
    else:
        mag = torch.clamp_min(_abs(x) - noise, 0.0) * p.out_amp
    y = mag * _unit(x)
    y[..., 0] = 0.0 if bug_dc_zero else x[..., 0]
    return _streams_first(y), state


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _floats(*vals):
    return (ctypes.c_float * len(vals))(*vals)


def _state_in(state, lead: tuple, nb: int, dev):
    """A typed state -> (its vectors, float32 ``lead + (NB,)`` each,
    current_l int32 and first_l bool of shape ``lead``), contiguous on
    ``dev``: the kernels read them in place (a field of another type or
    layout is converted first). ``lead`` is () for one stream, (B,) for
    B."""
    vecs = [v.to(torch.float32).contiguous() for v in state[:-2]]
    for name, v in zip(state._fields, vecs):
        check_tensor(v, f"state.{name}", torch.float32, lead + (nb,), dev)
    cur = state.current_l.to(torch.int32).contiguous()
    first = state.first_l.to(torch.bool).contiguous()
    check_tensor(cur, "state.current_l", torch.int32, lead, dev)
    check_tensor(first, "state.first_l", torch.bool, lead, dev)
    return vecs, cur, first


def _state_out(cls, lead: tuple, nb: int, dev):
    """The kernels' new state: (its vectors as rows of one float32 buffer,
    current_l, first_l)."""
    return (torch.empty((len(cls._fields) - 2,) + lead + (nb,),
                        dtype=torch.float32, device=dev),
            torch.empty(lead, dtype=torch.int32, device=dev),
            torch.empty(lead, dtype=torch.bool, device=dev))


def _ptrs(tensors):
    """A pointer to a host array of the tensors' device pointers (the
    pointer holds the array)."""
    return ctypes.cast((ctypes.c_void_p * len(tensors))(
        *(t.data_ptr() for t in tensors)), ctypes.c_void_p)


def _new_state(cls, out, rdtype):
    """:func:`_state_out`'s tensors, filled -> a typed state of
    ``rdtype`` vectors."""
    vecs, cur, first = out
    return cls(*(v.to(rdtype) for v in vecs.unbind(0)), cur, first)


def _check_front(spec, w_uniq, w_idx, what: str):
    """Check the front end's operands; returns (T, lead, M, NB, U), lead
    () for one stream and (B,) for B."""
    if spec.dim() not in (3, 4) or w_uniq.dim() != 3:
        raise ValueError(f"spec and w_uniq must be (T, M, NB) or (T, B, M, "
                         f"NB) and (U, M, NB), got {tuple(spec.shape)} and "
                         f"{tuple(w_uniq.shape)}")
    t, m, nb = spec.shape[0], spec.shape[-2], spec.shape[-1]
    lead = tuple(spec.shape[1:-2])
    u = w_uniq.shape[0]
    if not 2 <= m <= MAX_MICS:
        raise ValueError(f"the CUDA {what} kernel takes 2 to {MAX_MICS} "
                         f"mics, got {m}")
    if u < 1 or nb < 2:
        raise ValueError(f"the CUDA {what} kernel needs a steering row and "
                         f"2 bins or more, got U={u}, NB={nb}")
    _check_streams(lead, t, nb, what)
    dev = spec.device
    check_tensor(spec, "spec", torch.complex64, (t,) + lead + (m, nb), dev)
    check_tensor(w_uniq, "w_uniq", torch.complex64, (u, m, nb), dev)
    check_tensor(w_idx, "w_idx", torch.int64, lead + (t,), dev)
    return t, lead, m, nb, u


def _check_streams(lead: tuple, t: int, nb: int, what: str):
    """Raise unless the streams fit one launch: 1 to MAX_STREAMS of them,
    fewer than 2^31 (stream, frame, bin) triples."""
    b = lead[0] if lead else 1
    if not 1 <= b <= MAX_STREAMS or b * t * nb >= 2 ** 31:
        raise ValueError(f"the CUDA {what} kernel takes 1 to {MAX_STREAMS} "
                         f"streams and fewer than 2^31 (stream, frame, bin) "
                         f"triples, got B={b}, T={t}, NB={nb}")


def phase_mask(spec, w_uniq, w_idx, min_phase_rad: float,
               mag_threshold: float, mag_mult: float, nfft: int):
    """The phase mask; see :func:`phase_mask_plain`, one stream or B. On
    CUDA: complex64 spec and w_uniq, int64 w_idx, contiguous, 2 to 32 mics
    (a w_idx entry outside [0, U) gives NaN output for its frame); one
    launch for the B streams."""
    if not spec.is_cuda:
        return phase_mask_plain(spec, w_uniq, w_idx, min_phase_rad,
                                mag_threshold, mag_mult, nfft)
    with span("bf.kernel.phase_mask"):
        t, lead, m, nb, u = _check_front(spec, w_uniq, w_idx, "phase-mask")
        y = torch.empty(lead + (t, nb), dtype=torch.complex64,
                        device=spec.device)
        if t == 0:
            return y
        with device_guard(spec.device):
            lib, stream = launch_context(spec.device)
            code = lib.bf_phase_mask(
                spec.data_ptr(), w_uniq.data_ptr(), w_idx.data_ptr(),
                y.data_ptr(), m, t, nb, u, lead[0] if lead else 1,
                _floats(min_phase_rad, mag_threshold, mag_mult, 1.0 / nfft),
                stream)
        check(lib, code, "phase_mask")
    phase_mask.launches += 1
    return y


def _mcra_coefs(a_s, a_d, a_d2, delta, big_l):
    """The MCRA constants as the kernels take them; the complements are
    formed in double precision, as the plain version forms them."""
    return (a_s, 1.0 - a_s, a_d, 1.0 - a_d, a_d2, delta, float(big_l))


def mpf_march(spec, w_uniq, w_idx, state: MpfState, p, bug_dc_zero: bool):
    """The MPF front end and march; see :func:`mpf_march_plain`, one
    stream or B. On CUDA: complex64 spec and w_uniq, int64 w_idx,
    contiguous, 2 to 32 mics; the state's vectors go through float32. Two
    launches per call whatever B is: the dual beams over every (stream,
    frame, bin) into (4, B, T, NB) planes, then the march."""
    if not spec.is_cuda:
        return mpf_march_plain(spec, w_uniq, w_idx, state, p, bug_dc_zero)
    with span("bf.kernel.mpf_march"):
        t, lead, m, nb, u = _check_front(spec, w_uniq, w_idx, "MPF")
        dev = spec.device
        vecs, cur, first = _state_in(state, lead, nb, dev)
        if t == 0:
            return (torch.empty(lead + (0, nb), dtype=torch.complex64,
                                device=dev), state)
        planes = torch.empty((4,) + lead + (t, nb), dtype=torch.float32,
                             device=dev)
        y = torch.empty(lead + (t, nb), dtype=torch.complex64, device=dev)
        out = _state_out(MpfState, lead, nb, dev)
        coef = _floats(
            p.min_phase * math.pi / 180.0, p.min_mag,
            *_mcra_coefs(p.MCRA_alphaS, p.MCRA_alphaD, p.MCRA_alphaD2,
                         p.MCRA_delta, p.MCRA_L),
            p.MPF_alphaS, 1 - p.MPF_alphaS, p.MPF_eta, p.MPF_rev_gamma,
            1.0 - p.MPF_rev_gamma / p.MPF_rev_delta, p.out_amp, p.noise_floor)
        flags = ((_ONLY_NOISE if p.out_only_noise else 0)
                 | (_ONLY_MCRA if p.out_only_mcra else 0)
                 | (_DC_ZERO if bug_dc_zero else 0))
        with device_guard(dev):
            lib, stream = launch_context(dev)
            code = lib.bf_mpf_march(
                spec.data_ptr(), w_uniq.data_ptr(), w_idx.data_ptr(),
                _ptrs(vecs), cur.data_ptr(), first.data_ptr(),
                planes.data_ptr(), y.data_ptr(), _ptrs(out[0]),
                out[1].data_ptr(), out[2].data_ptr(), m, t, nb, u,
                lead[0] if lead else 1, coef, flags, stream)
        check(lib, code, "mpf_march")
    mpf_march.launches += 1
    return y, _new_state(MpfState, out, state[0].dtype)


def mcra_march(s_f, sq, x, state: McraState, p, bug_dc_zero: bool):
    """The MCRA march; see :func:`mcra_march_plain`, one stream ((T, NB)
    inputs) or B ((T, B, NB), mic 0 of B streams' analysis read in place).
    On CUDA: float32 s_f and sq, complex64 x, contiguous; the state's
    vectors go through float32; one launch for the B streams."""
    if not x.is_cuda:
        return mcra_march_plain(s_f, sq, x, state, p, bug_dc_zero)
    with span("bf.kernel.mcra_march"):
        if x.dim() not in (2, 3):
            raise ValueError(f"x must be (T, NB) or (T, B, NB), got "
                             f"{tuple(x.shape)}")
        t, nb = x.shape[0], x.shape[-1]
        lead = tuple(x.shape[1:-1])
        _check_streams(lead, t, nb, "MCRA")
        dev = x.device
        check_tensor(s_f, "s_f", torch.float32, x.shape, dev)
        check_tensor(sq, "sq", torch.float32, x.shape, dev)
        check_tensor(x, "x", torch.complex64, x.shape, dev)
        vecs, cur, first = _state_in(state, lead, nb, dev)
        if t == 0:
            return (torch.empty(lead + (0, nb), dtype=torch.complex64,
                                device=dev), state)
        y = torch.empty(lead + (t, nb), dtype=torch.complex64, device=dev)
        out = _state_out(McraState, lead, nb, dev)
        coef = _floats(*_mcra_coefs(p.alphaS, p.alphaD, p.alphaD2, p.delta,
                                    p.L), p.out_amp)
        flags = ((_ONLY_NOISE if p.out_only_noise else 0)
                 | (_DC_ZERO if bug_dc_zero else 0))
        with device_guard(dev):
            lib, stream = launch_context(dev)
            code = lib.bf_mcra_march(
                s_f.data_ptr(), sq.data_ptr(), x.data_ptr(), _ptrs(vecs),
                cur.data_ptr(), first.data_ptr(), y.data_ptr(), _ptrs(out[0]),
                out[1].data_ptr(), out[2].data_ptr(), t, nb,
                lead[0] if lead else 1, coef, flags, stream)
        check(lib, code, "mcra_march")
    mcra_march.launches += 1
    return y, _new_state(McraState, out, state[0].dtype)


def march_resources(node: str, device=None) -> dict:
    """The CUDA march kernel of ``node`` ("mpf" or "mcra") as the card
    compiled it: registers a thread, dynamic shared memory a block
    (bytes), local memory a thread (bytes: spills) and resident blocks an
    SM (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor``)."""
    if node not in ("mpf", "mcra"):
        raise ValueError(f"node must be 'mpf' or 'mcra', got {node!r}")
    dev = torch.device("cuda" if device is None else device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = (ctypes.c_int * 4)()
    with device_guard(dev):
        lib, _ = launch_context(dev)
        code = lib.bf_march_resources(0 if node == "mpf" else 1, out)
    check(lib, code, "march_resources")
    return dict(zip(("registers", "smem_bytes", "local_bytes",
                     "blocks_per_sm"), out))


phase_mask.launches = 0
mpf_march.launches = 0
mcra_march.launches = 0
