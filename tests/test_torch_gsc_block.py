"""The port's lookahead-8 GSC adaptive stage (``solver="block"``) on the
CPU: the plain version of ``kernels/gsc_block.py`` (``gsc_block_plain``,
the CUDA kernel's oracle) against the JAX package's block kernel and the
per-sample recurrence.

Every input is made with numpy from a seed. Bars:

* vs ``gsc_block_pallas_batched`` in interpret mode, float32, from a zero
  state: the JAX package's block-vs-scan tolerances
  (tests/test_gsc_block.py): outputs and output history 3e-5 of peak,
  filters 2e-5 / 1e-3 relative, Grams 2e-4 / 2e-3 relative; the
  registers exact.
* vs ``gsc_sample_plain`` (the same function: the factorisation is exact,
  only the order of the sums and the NaN scrub's timing differ): float32
  3e-5 of peak, float64 1e-9.
* chunked vs one call: bit for bit.

The JAX kernel costs about a minute a call in interpret mode, so it runs
twice (VAD off and on); the other cases hold the plain version to the
per-sample recurrence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beamform_tpu import config as jcfg
from beamform_tpu.kernels.gsc_block import gsc_block_pallas_batched
from beamform_tpu_torch.config import GscParams
from beamform_tpu_torch.kernels import gsc as tk
from beamform_tpu_torch.kernels import gsc_block as tb
from beamform_tpu_torch.models import gsc as tgsc

K = 128


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _zero(b, m, dtype):
    """A zero state: block, filt, last_out, gram, uold."""
    return (torch.zeros((b, m - 1, K), dtype=dtype),
            torch.zeros((b, m - 1, K), dtype=dtype),
            torch.zeros((b, K), dtype=dtype),
            torch.zeros((b, m - 1, 8), dtype=dtype),
            torch.zeros((b, m - 1, 8), dtype=dtype))


def _carried(rng, b, m, dtype):
    """A carried state: registers and outputs at the audio's scale, small
    filters, and gram as every path writes it (gram_refresh)."""
    blk = _t(0.2 * rng.standard_normal((b, m - 1, K)), dtype)
    uold = _t(0.2 * rng.standard_normal((b, m - 1, 8)), dtype)
    gram, _ = tgsc.gram_refresh(blk[..., :0], uold, blk, K)
    return (blk, _t(0.01 * rng.standard_normal((b, m - 1, K)), dtype),
            _t(0.1 * rng.standard_normal((b, K)), dtype), gram, uold)


def _max(x):
    return float(x.abs().max())


@pytest.mark.parametrize("use_vad", [False, True])
def test_plain_matches_the_jax_block_kernel(use_vad):
    """tests/test_gsc_block.py's case: b 2, m 4, s 256, chunk 128."""
    b, m, s = 2, 4, 2 * 128
    kw = dict(mu0=0.05, mu_max=0.1, filter_size=K, use_vad=use_vad,
              vad_threshold=0.05)
    rng = np.random.default_rng(0)
    a = (0.3 * rng.standard_normal((b, m, s))).astype(np.float32)
    z = [v.numpy() for v in _zero(b, m, torch.float32)]
    want = gsc_block_pallas_batched(jnp.asarray(a), *z, jcfg.GscParams(**kw),
                                    chunk=128, interpret=True)
    got = tb.gsc_block_plain(_t(a, torch.float32),
                             *_zero(b, m, torch.float32), GscParams(**kw))
    want = [np.asarray(v) for v in want]
    scale = float(np.abs(want[0]).max())
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=3e-5 * scale)
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=2e-5,
                               rtol=1e-3)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[3].numpy(), want[3], atol=3e-5 * scale)
    np.testing.assert_allclose(got[4].numpy(), want[4], atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_array_equal(got[5].numpy(), want[5])


@pytest.mark.parametrize("use_vad", [False, True])
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 3e-5),
                                       (torch.float64, 1e-9)],
                         ids=["float32", "float64"])
def test_plain_matches_the_recurrence_at_16_mics(dtype, bar, use_vad):
    """Three tiles of the main path's width (15 blocking channels) from a
    carried state, two streams: outputs (bar of peak in float32, absolute
    in float64), filters, and the registers."""
    rng = np.random.default_rng(4 + use_vad)
    b, m, s = 2, 16, 3 * 128
    a = _t(0.2 * rng.standard_normal((b, m, s)), dtype)
    st = _carried(rng, b, m, dtype)
    p = GscParams(mu0=0.001, mu_max=0.05, use_vad=use_vad,
                  vad_threshold=0.2)
    got = tb.gsc_block_plain(a, *st, p)
    want = tk.gsc_sample_plain(a, *st[:3], p)
    tol = bar * (_max(want[0]) if dtype == torch.float32 else 1.0)
    assert _max(got[0] - want[0]) <= tol
    assert _max(got[2] - want[2]) <= tol
    assert torch.equal(got[1], want[1])
    gram, uold = tgsc.gram_refresh(st[0], st[4], a[:, 1:] - a[:, :-1], K)
    assert _max(got[4] - gram) <= 1e-5 * _max(gram)
    assert torch.equal(got[5], uold)


@pytest.mark.parametrize("use_vad", [False, True])
def test_two_calls_equal_one(use_vad):
    """Fresh sums: a split at any group boundary gives one call's output
    and state bit for bit."""
    rng = np.random.default_rng(6)
    a = _t(0.2 * rng.standard_normal((2, 5, 512)), torch.float32)
    st = _carried(rng, 2, 5, torch.float32)
    p = GscParams(mu0=0.001, mu_max=0.05, use_vad=use_vad,
                  vad_threshold=0.15)
    full = tb.gsc_block_plain(a, *st, p)
    one = tb.gsc_block_plain(a[..., :200], *st, p)
    two = tb.gsc_block_plain(a[..., 200:], *one[1:], p)
    assert torch.equal(torch.cat([one[0], two[0]], -1), full[0])
    for x, y in zip(two[1:], full[1:]):
        assert torch.equal(x, y)


def test_zero_lead_in_gives_zeros_not_nan():
    """tests/test_gsc_block.py's cold start: every power 0 over the
    lead-in, every step scrubbed to 0, so zeros, not NaN."""
    rng = np.random.default_rng(2)
    a = np.zeros((1, 3, 2 * 128), np.float32)
    a[..., 128:] = 0.2 * rng.standard_normal((1, 3, 128))
    a = _t(a, torch.float32)
    p = GscParams(mu0=0.001, mu_max=0.05)
    got = tb.gsc_block_plain(a, *_zero(1, 3, torch.float32), p)
    want = tk.gsc_sample_plain(a, *_zero(1, 3, torch.float32)[:3], p)
    assert torch.isfinite(got[0]).all()
    assert torch.equal(got[0][:, :128], torch.zeros((1, 128)))
    assert _max(got[0] - want[0]) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_a_window_that_falls_silent(dtype):
    """Signal, then 256 zero samples, then signal again. The TPU kernel's
    running sums did not return to 0 there; the fresh sums do: the Grams
    and the output history at the silence's end are exactly 0, and the
    output, through the silence and the resumed signal, is the per-sample
    recurrence's."""
    rng = np.random.default_rng(8)
    a = 0.2 * rng.standard_normal((2, 16, 640))
    a[..., 256:512] = 0.0
    a = _t(a, dtype)
    st = _carried(rng, 2, 16, dtype)
    p = GscParams(mu0=0.001, mu_max=0.05, use_vad=True, vad_threshold=0.3)
    head = tb.gsc_block_plain(a[..., :512], *st, p)
    assert torch.equal(head[4], torch.zeros_like(head[4]))
    assert torch.equal(head[3], torch.zeros_like(head[3]))
    assert torch.equal(head[0][:, 384:], torch.zeros((2, 128), dtype=dtype))
    tail = tb.gsc_block_plain(a[..., 512:], *head[1:], p)
    got = torch.cat([head[0], tail[0]], -1)
    want = tk.gsc_sample_plain(a, *st[:3], p)[0]
    bar = 3e-5 * _max(want) if dtype == torch.float32 else 1e-9
    assert _max(got - want) <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_sample_state_resumes_on_the_block_version(dtype):
    """A state the per-sample path wrote (its gram and uold from
    gram_refresh, as models/gsc.py writes them) resumes on the block
    version with no transient."""
    rng = np.random.default_rng(3)
    b, m, half = 1, 4, 256
    a = _t(0.3 * rng.standard_normal((b, m, 2 * half)), dtype)
    p = GscParams(mu0=0.05, mu_max=0.1)
    st = tgsc.gsc_init_state(m, K, dtype)
    full = tk.gsc_sample_plain(a, *_zero(b, m, dtype)[:3], p)[0]
    out1, blk, flt, lo = tk.gsc_sample_plain(
        a[..., :half], st.block[None], st.filt[None], st.last_out[None], p)
    at = a[0, :, :half]
    gram, uold = tgsc.gram_refresh(st.block, st.uold, at[1:] - at[:-1], K)
    out2 = tb.gsc_block_plain(a[..., half:], blk, flt, lo, gram[None],
                              uold[None], p)[0]
    got = torch.cat([out1, out2], -1)
    bar = 3e-5 * max(_max(full), 1.0) if dtype == torch.float32 else 1e-9
    assert _max(got - full) <= bar


def test_wrapper_takes_plain_on_cpu_and_refuses_what_it_cannot_take():
    rng = np.random.default_rng(7)
    a = _t(0.1 * rng.standard_normal((1, 3, 256)), torch.float32)
    st = _zero(1, 3, torch.float32)
    p = GscParams(solver="block")
    before = tb.gsc_block.launches
    for x, y in zip(tb.gsc_block(a, *st, p), tb.gsc_block_plain(a, *st, p)):
        assert torch.equal(x, y)
    assert tb.gsc_block.launches == before
    with pytest.raises(ValueError, match="multiple of 8"):
        tb.gsc_block_plain(a[..., :100], *st, p)
    with pytest.raises(ValueError, match="more than 8 taps"):
        tb.gsc_block_plain(a, *(v[..., :8] for v in st[:3]), *st[3:], p)
    empty = tb.gsc_block_plain(a[..., :0], *st, p)
    assert empty[0].shape == (1, 0)
    for x, y in zip(empty[1:], st):
        assert torch.equal(x, y)
