"""The port's WOLA layer against the JAX package's.

The plain versions of the CUDA kernels' wrappers (the CPU path) are held
against the Pallas kernels run in interpret mode, as test_wola_pallas.py
runs them, within 1e-5 of peak in float32 (sums run in another order), and
against the JAX package's float64 carry path within 1e-12. The kernels
themselves are checked against these plain versions on the card
(test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.dsp import wola as jwola
from beamform_tpu.kernels.wola_pallas import istft_ext_fused, stft_planes
from beamform_tpu.models import common as jcommon
from beamform_tpu_torch.config import EngineConfig
from beamform_tpu_torch.dsp import wola as twola
from beamform_tpu_torch.kernels import wola as kw
from beamform_tpu_torch.models import common as tcommon

HOP = 128
NB = HOP + 2
F32_REL = 1e-5
F64_ABS = 1e-12


def _jengine(dtype="float32", **kw_):
    return JEngine(sample_rate=48000, window_size=HOP, dtype=dtype, **kw_)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _analysis_inputs(m, t, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, t * HOP)).astype(dtype),
            rng.standard_normal((m, HOP)).astype(dtype))


def _synthesis_inputs(c, t, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    shape = (c, t, NB) if c else (t, NB)
    y = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(dtype)
    prev = rng.standard_normal(shape[:-2] + (HOP,)).real
    return y, prev.astype(np.float64 if dtype == np.complex128
                          else np.float32)


@pytest.mark.parametrize("m", [1, 5])
def test_analysis_plain_matches_pallas_kernel(m):
    engine = _jengine()
    x, tail = _analysis_inputs(m, 12, seed=m)
    window = jcommon.make_window(engine, jnp.float32)
    sr, si, mag, new_tail = jax.jit(
        lambda *a: stft_planes(*a, engine, interpret=True)
    )(jnp.asarray(x), jnp.asarray(tail), window)
    ref = np.asarray(sr)[..., :NB] + 1j * np.asarray(si)[..., :NB]

    before = kw.wola_analysis.launches
    spec, tmag, ttail = kw.wola_analysis(torch.as_tensor(x),
                                         torch.as_tensor(tail), True)
    assert spec.shape == (12, m, NB) and spec.dtype == torch.complex64
    assert _rel(spec, ref) < F32_REL
    assert _rel(tmag, np.asarray(mag)[:, :NB]) < F32_REL
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(new_tail))
    assert kw.wola_analysis.launches == before  # CPU tensors: plain path


@pytest.mark.parametrize("c", [None, 5])
def test_synthesis_plain_matches_pallas_kernel(c):
    engine = _jengine()
    y, prev = _synthesis_inputs(c, 10, seed=3)
    window = jcommon.make_window(engine, jnp.float32)
    ref, ref_prev = jax.jit(
        lambda yy, pp: istft_ext_fused(yy, engine, window, pp,
                                       interpret=True)
    )(jnp.asarray(y), jnp.asarray(prev))

    before = kw.wola_synthesis.launches
    ty, tprev = torch.as_tensor(y), torch.as_tensor(prev)
    if c is None:                               # single stream: C = 1
        ty, tprev = ty[None], tprev[None]
    out, new_prev = kw.wola_synthesis(ty, tprev)
    assert out.shape == (c or 1, 10 * HOP)
    scale = np.abs(np.asarray(ref)).max()
    assert np.abs(out.numpy().reshape(np.shape(ref))
                  - np.asarray(ref)).max() / scale < F32_REL
    assert np.abs(new_prev.numpy().reshape(np.shape(ref_prev))
                  - np.asarray(ref_prev)).max() / scale < F32_REL
    assert kw.wola_synthesis.launches == before


def test_plain_kernels_match_jax_carry_path_float64():
    engine = _jengine("float64")
    x, tail = _analysis_inputs(3, 9, seed=5, dtype=np.float64)
    window = jcommon.make_window(engine, jnp.float64)
    ref, ref_tail = jcommon.stft_ext_carry(
        jnp.asarray(x), engine, window, jnp.complex128, jnp.asarray(tail))
    spec, mag, new_tail = kw.wola_analysis(torch.as_tensor(x),
                                           torch.as_tensor(tail), True)
    assert spec.dtype == torch.complex128
    np.testing.assert_allclose(spec.numpy(), np.asarray(ref), rtol=0,
                               atol=F64_ABS)
    np.testing.assert_array_equal(new_tail.numpy(), np.asarray(ref_tail))
    np.testing.assert_allclose(
        mag.numpy(), np.asarray(jcommon.mag_mean_over_mics(ref, 2 * HOP)),
        rtol=0, atol=F64_ABS)

    y, prev = _synthesis_inputs(4, 7, seed=6, dtype=np.complex128)
    ref_out, ref_prev = jcommon.istft_ext_carry(
        jnp.asarray(y), engine, window, jnp.asarray(prev))
    out, new_prev = kw.wola_synthesis(torch.as_tensor(y),
                                      torch.as_tensor(prev))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0,
                               atol=F64_ABS)
    np.testing.assert_allclose(new_prev.numpy(), np.asarray(ref_prev),
                               rtol=0, atol=F64_ABS)


def test_shadow_bin_is_conj_of_bin_h_minus_1():
    x, tail = _analysis_inputs(2, 6, seed=7)
    spec, _, _ = kw.wola_analysis(torch.as_tensor(x), torch.as_tensor(tail))
    s = spec.numpy()
    np.testing.assert_allclose(s[..., HOP + 1], np.conj(s[..., HOP - 1]),
                               rtol=0, atol=np.abs(s).max() * 1e-6)


def test_roundtrip_reconstructs_delayed_input():
    """analysis -> mic 0 -> synthesis is the input delayed by one hop (the
    WOLA identity of the periodic sqrt-Hann pair)."""
    x, _ = _analysis_inputs(1, 16, seed=8)
    spec, _, _ = kw.wola_analysis(torch.as_tensor(x), torch.zeros(1, HOP))
    out, _ = kw.wola_synthesis(spec[:, 0][None].contiguous(),
                               torch.zeros(1, HOP))
    err = np.abs(out[0, HOP:].numpy() - x[0, :-HOP])[HOP:]
    assert err.max() < 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("full_fft", [False, True])
def test_common_carry_path_matches_jax_float64(full_fft):
    """The CPU carry path (the one DAS runs off the card) in both layouts,
    chunk after chunk."""
    jeng = _jengine("float64", full_fft=full_fft)
    teng = EngineConfig(sample_rate=48000, window_size=HOP,
                        dtype="float64", full_fft=full_fft)
    jwin = jcommon.make_window(jeng, jnp.float64)
    twin = tcommon.make_window(teng, torch.float64)
    x, _ = _analysis_inputs(3, 8, seed=9, dtype=np.float64)
    jtail, ttail = jnp.zeros((3, HOP)), torch.zeros(1, 3, HOP,
                                                    dtype=torch.float64)
    jprev, tprev = jnp.zeros(HOP), torch.zeros(1, HOP, dtype=torch.float64)
    for i in range(0, 8 * HOP, 4 * HOP):
        jspec, jtail = jcommon.stft_ext_carry(
            jnp.asarray(x[:, i:i + 4 * HOP]), jeng, jwin, jnp.complex128,
            jtail)
        # the port's carries take a leading stream axis: one stream here
        tspec, _, ttail = tcommon.stft_streams_carry(
            torch.as_tensor(x[None, :, i:i + 4 * HOP]), teng, twin,
            torch.complex128, ttail)
        np.testing.assert_allclose(tspec[:, 0].numpy(), np.asarray(jspec),
                                   rtol=0, atol=F64_ABS)
        y = jspec[:, 0]
        jout, jprev = jcommon.istft_ext_carry(y, jeng, jwin, jprev)
        tout, tprev = tcommon.istft_channels_carry(
            torch.as_tensor(np.array(y))[None], teng, twin, tprev)
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout),
                                   rtol=0, atol=F64_ABS)


def test_dsp_helpers_match_jax_float64():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 6 * HOP))
    win = twola.sqrt_hann(2 * HOP)
    np.testing.assert_array_equal(win, jwola.sqrt_hann(2 * HOP))
    tx, twin = torch.as_tensor(x), torch.as_tensor(win)
    for got, ref in [
            (twola.frame_signal(tx, HOP), jwola.frame_signal(x, HOP)),
            (twola.analyze(tx, HOP, twin, cdtype=torch.complex128),
             jwola.analyze(x, HOP, win, cdtype=jnp.complex128)),
            (twola.pad_to_hop(tx[:, :-5], HOP),
             jwola.pad_to_hop(x[:, :-5], HOP))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=F64_ABS)
    spec = jwola.analyze(x, HOP, win, cdtype=jnp.complex128)
    np.testing.assert_allclose(
        twola.synthesize(torch.as_tensor(np.array(spec)), HOP,
                         twin).numpy(),
        np.asarray(jwola.synthesize(spec, HOP, win)), rtol=0, atol=F64_ABS)
    p = rng.standard_normal((2, 5, 2 * HOP))
    np.testing.assert_allclose(
        twola.overlap_add(torch.as_tensor(p), HOP).numpy(),
        np.asarray(jwola.overlap_add(p, HOP)), rtol=0, atol=F64_ABS)


@pytest.mark.parametrize("nfft", [128, 384, 8192])
def test_kernel_size_gate_names_roadmap(nfft):
    with pytest.raises(ValueError, match="ROADMAP"):
        kw._check_nfft(nfft)


def _run_plan(z: np.ndarray, passes, table: np.ndarray,
              dtype=np.complex64) -> np.ndarray:
    """The register FFT's Stockham passes (csrc/reg_fft.cuh) in numpy, in
    ``dtype``: pass (R, Ns) reads point b + r n/R of butterfly b,
    multiplies it by the table's entry r * Ns + b mod Ns, takes an R-point
    DFT and writes output r to (b // Ns) Ns R + b mod Ns + r Ns. The table
    holds exactly the passes' twiddles."""
    n = z.shape[-1]
    tw = (table[:, 0] + 1j * table[:, 1]).astype(dtype)
    data, off = z.astype(dtype), 0
    for r_, ns in passes:
        b = np.arange(n // r_)[:, None]
        r = np.arange(r_)[None, :]
        v = data[b + r * (n // r_)]
        if ns > 1:
            v = v * tw[off + r * ns + b % ns]
            off += r_ * ns
        dft = np.exp(-2j * np.pi * np.outer(np.arange(r_), np.arange(r_))
                     / r_).astype(dtype)
        out = np.empty_like(data)
        out[(b // ns) * ns * r_ + b % ns + r * ns] = v @ dft
        data = out
    assert off == len(tw)
    return data


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048, 4096])
def test_analysis_kernel_pass_plan_is_the_fft(nfft):
    """The pass plan and the float32 twiddle tables the analysis kernel
    reads give np.fft.fft within 1e-5 of peak, with natural-order output
    (no digit reversal left over)."""
    passes, table = kw.analysis_plan(nfft)
    assert table.dtype == np.float32
    assert np.prod([r for r, _ in passes]) == nfft
    rng = np.random.default_rng(nfft)
    z = (rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft))
    got = _run_plan(z, passes, table)
    assert _rel(got, np.fft.fft(z)) < F32_REL


def _syn_frames_per_block(nfft: int) -> int:
    """Frames a synthesis block owns (csrc/wola.cu syn_threads): a block of
    256 threads, or of four frames' groups where a frame takes more than
    64 threads, holds one group of n' / 16 threads per frame (n' = nfft / 2
    points, nfft at 256) and recomputes one frame."""
    n = nfft // 2 if nfft >= 512 else nfft
    tpf = n // 16
    return max(256, 4 * tpf) // tpf - 1


def _plan_synthesis(y_ext: np.ndarray, prev: np.ndarray, nfft: int):
    """The synthesis kernel (csrc/wola.cu, csrc/reg_irfft.cuh) in numpy,
    float64: per frame the fold, then for nfft >= 512 the pre-twiddle and
    one complex FFT of nfft / 2 points run as conj(FFT(conj Z)) on the
    plan's passes, the even and odd samples as its real and imaginary
    parts (at nfft 256 the full Hermitian frame through a 256-point FFT);
    x 1/nfft, the window, and the overlap-add as the blocks own it: block
    b writes hops bG .. bG + G - 1 from its frames and frame bG - 1,
    recomputed, or the carry at b = 0."""
    c, t, nb = y_ext.shape
    hop = nb - 2
    half, passes, table = kw.synthesis_plan(nfft)
    n = nfft // 2 if half else nfft
    rows = len(table) - (n if half else 0)
    win = twola.sqrt_hann(nfft)

    def frame(yf):
        x = yf[:hop + 1].copy()                       # fold_ext
        x[hop - 1] = 0.5 * (yf[hop - 1] + np.conj(yf[hop + 1]))
        x[0], x[hop] = x[0].real, x[hop].real
        if half:
            k = np.arange(n)
            a, b = x[k], x[hop - k]
            pre = table[rows:, 0] + 1j * table[rows:, 1]
            z = (a + np.conj(b)) + 1j * pre * (a - np.conj(b))
        else:
            z = np.concatenate([x, np.conj(x[1:hop][::-1])])
        f = np.conj(_run_plan(np.conj(z), passes, table[:rows],
                              np.complex128)) / nfft
        if half:
            s = np.empty(nfft)
            s[0::2], s[1::2] = f.real, f.imag
        else:
            s = f.real
        return s * win

    g = _syn_frames_per_block(nfft)
    out = np.empty((c, t * hop))
    new_prev = np.empty((c, hop))
    for ch in range(c):
        for t0 in range(0, t, g):
            frames = {tf: frame(y_ext[ch, tf])
                      for tf in range(max(t0 - 1, 0), min(t0 + g, t))}
            for tf in range(t0, min(t0 + g, t)):
                carry = prev[ch] if tf == 0 else frames[tf - 1][hop:]
                out[ch, tf * hop:(tf + 1) * hop] = frames[tf][:hop] + carry
            if t0 + g >= t:
                new_prev[ch] = frames[t - 1][hop:]
    return out, new_prev


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048, 4096])
def test_synthesis_kernel_plan_is_the_irfft(nfft):
    """The synthesis kernel's plan (kernels/wola.py synthesis_plan: its
    passes, pass twiddles and pre-twiddles, in float64) run in numpy as the
    kernel runs it, blocks and recomputed frames included, gives
    wola_synthesis_plain and np.fft.irfft within 1e-12 of peak, and its
    table is laid out as csrc/wola.cu reads it."""
    half, passes, table = kw.synthesis_plan(nfft)
    n = nfft // 2 if half else nfft
    assert half == (nfft >= 512) and table.dtype == np.float64
    assert np.prod([r for r, _ in passes]) == n
    # wola_inv_kernel: pass rows 256 + (R3 > 1 ? 256 R3 : 0), R3 = n / 256
    assert len(table) == 256 + (n if n > 256 else 0) + (n if half else 0)
    hop = nfft // 2
    g = _syn_frames_per_block(nfft)
    t = 2 * g + 3                         # three blocks, the last ragged
    rng = np.random.default_rng(nfft)
    y = (rng.standard_normal((2, t, hop + 2))
         + 1j * rng.standard_normal((2, t, hop + 2)))
    prev = rng.standard_normal((2, hop))
    got, got_prev = _plan_synthesis(y, prev, nfft)
    ref, ref_prev = kw.wola_synthesis_plain(torch.as_tensor(y),
                                            torch.as_tensor(prev))
    scale = np.abs(ref.numpy()).max()
    assert np.abs(got - ref.numpy()).max() / scale < 1e-12
    assert np.abs(got_prev - ref_prev.numpy()).max() / scale < 1e-12
    # np.fft.irfft of the folded frames, windowed and overlap-added
    folded = kw.fold_ext(torch.as_tensor(y), nfft).numpy()
    p = np.fft.irfft(folded, n=nfft, axis=-1) * twola.sqrt_hann(nfft)
    ola = p[..., :hop].copy()
    ola[:, 1:] += p[:, :-1, hop:]
    ola[:, 0] += prev
    assert np.abs(got - ola.reshape(2, -1)).max() / scale < 1e-12
    assert np.abs(got_prev - p[:, -1, hop:]).max() / scale < 1e-12
