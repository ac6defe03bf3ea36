"""The port's GSC node and its adaptive-stage kernels' plain versions
against the JAX package and the float64 oracle, on the CPU.

Every input is made with numpy from a seed and fed to both packages. On
the CPU the node runs the per-sample recurrence (``kernels/gsc.py``
``gsc_sample_plain``) or the block scan (``kernels/gsc_blocklms.py``
``gsc_blocklms_plain``) around the WOLA path. Bars:

* float64 vs ``GscOracle``: 1e-9 (test_parity.py's); vs the JAX model and
  its functions (the block scan, ``gram_refresh``, the step, the mu
  trace): 1e-12.
* float32 plain versions vs the Pallas kernels in interpret mode: the JAX
  package's own kernel-vs-scan tolerances (tests/test_gsc_pallas.py,
  tests/test_gsc_blocklms.py).
* chunked vs offline, checkpoints across the packages and solvers: 1e-12
  (float64).

The recurrence is serial, ~150 us a sample in plain torch here, so each
case keeps its serial length to a few thousand samples.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beamform_tpu import config as jcfg
from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.geometry import ArrayGeometry as JGeom
from beamform_tpu.kernels import gsc_blocklms as jbl
from beamform_tpu.kernels import gsc_pallas as jgp
from beamform_tpu.models import gsc as jgsc
from beamform_tpu.oracle import nodes as on
from beamform_tpu.runtime.cli import main as jax_cli
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch import config as tcfg
from beamform_tpu_torch.config import EngineConfig, GscParams
from beamform_tpu_torch.convert import state_from_jax
from beamform_tpu_torch.geometry import ArrayGeometry
from beamform_tpu_torch.kernels import gsc as tk
from beamform_tpu_torch.kernels import gsc_blocklms as tb
from beamform_tpu_torch.models import gsc as tgsc
from beamform_tpu_torch.runtime import cli, wav
from beamform_tpu_torch.runtime.streaming import StreamingSession

from conftest import AIRA3, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
FS = 48000
THETA = 25.0
# test_parity.py's parameters
PARITY = dict(use_vad=False, vad_threshold=0.1, mu0=0.0001, mu_max=0.1,
              filter_size=32)
# the VAD gate closes on about half of this scene's samples
VAD = dict(PARITY, use_vad=True, vad_threshold=0.05)


def _models(params, dtype="float64", xy=AIRA3):
    """(port model on the CPU, JAX model) with the same parameters."""
    kw = dict(sample_rate=FS, window_size=HOP, dtype=dtype)
    return (tgsc.GscModel(EngineConfig(**kw), ArrayGeometry.from_xy(xy),
                          GscParams(**params), device="cpu"),
            jgsc.GscModel(JEngine(**kw), JGeom.from_xy(xy),
                          jcfg.GscParams(**params)))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _zero_state(b, m, k, dtype):
    return (torch.zeros((b, m - 1, k), dtype=dtype),
            torch.zeros((b, m - 1, k), dtype=dtype),
            torch.zeros((b, k), dtype=dtype))


@pytest.mark.parametrize("params", [PARITY, VAD], ids=["parity", "vad"])
def test_gsc_float64_matches_oracle_and_jax(params):
    x = make_scene(AIRA3, fs=FS, hop=HOP, seconds=0.3, theta_deg=THETA)
    tm, jm = _models(params)
    y = tm.process(x, THETA).numpy()
    y_j = np.asarray(jm.process(x, THETA))
    o = on.GscOracle(AIRA3, HOP, FS, THETA, **params)
    ref = np.concatenate([o.callback(x[:, k * HOP:(k + 1) * HOP])
                          for k in range(x.shape[1] // HOP)])
    assert np.isfinite(y).all() and np.abs(y).max() > 1e-2
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-12)


def test_gsc_sample_step_and_gram_refresh_match_jax():
    """One step from a carried state, with and without the VAD gate and
    the trace; the block kernel's lookahead state from a chunk."""
    rng = np.random.default_rng(5)
    m, k = 5, 16
    leaves = [0.2 * rng.standard_normal(s)
              for s in ((m - 1, k), (m - 1, k), (k,), (m - 1, 8),
                        (m - 1, 8))]
    a_t = 0.3 * rng.standard_normal(m)
    for params in (PARITY, dict(VAD, vad_threshold=0.25)):
        p = dict(params, filter_size=k)
        st, (out, mu, upd) = tgsc.gsc_sample_step(
            tgsc.GscState(*map(_t, leaves)), _t(a_t), GscParams(**p),
            with_mu=True)
        st_j, (out_j, mu_j, upd_j) = jgsc.gsc_sample_step(
            jgsc.GscState(*map(jnp.asarray, leaves)), jnp.asarray(a_t),
            jcfg.GscParams(**p), with_mu=True)
        for a, b in zip(st, st_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-12)
        assert abs(float(out) - float(out_j)) <= 1e-12
        assert abs(float(mu) - float(mu_j)) <= 1e-12
        assert bool(upd) == bool(upd_j)
    u_new = 0.2 * rng.standard_normal((m - 1, 40))
    for u in (u_new, u_new[:, :5]):        # longer and shorter than K + 8
        g, uo = tgsc.gram_refresh(_t(leaves[0]), _t(leaves[4]), _t(u), k)
        g_j, uo_j = jgsc.gram_refresh(jnp.asarray(leaves[0]),
                                      jnp.asarray(leaves[4]),
                                      jnp.asarray(u), k)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(uo.numpy(), np.asarray(uo_j), rtol=0,
                                   atol=1e-15)


def _pallas_case(use_vad, seed=0, m=4, s=512):
    params = dict(mu0=0.0005, mu_max=0.05, filter_size=128,
                  use_vad=use_vad, vad_threshold=0.05)
    rng = np.random.default_rng(seed)
    return params, (0.2 * rng.standard_normal((m, s))).astype(np.float32)


@pytest.mark.parametrize("use_vad", [False, True])
@pytest.mark.parametrize("xmu", [False, True], ids=["sample", "xmu"])
def test_sample_plain_matches_pallas(use_vad, xmu):
    """Rows 9 and 10: the plain recurrence in float32 against
    gsc_adaptive_pallas and gsc_adaptive_pallas_xmu in interpret mode
    (M = 4, K = 128, S = 512, chunk 128)."""
    params, a = _pallas_case(use_vad)
    m, k = a.shape[0], 128
    st = jgsc.gsc_init_state(m, k, jnp.float32)
    fn = jgp.gsc_adaptive_pallas_xmu if xmu else jgp.gsc_adaptive_pallas_batched
    ref = fn(jnp.asarray(a)[None], st.block[None], st.filt[None],
             st.last_out[None], jcfg.GscParams(**params), chunk=128,
             interpret=True)
    fn_t = tk.gsc_xmu if xmu else tk.gsc_sample
    got = fn_t(_t(a, torch.float32)[None], *_zero_state(1, m, k,
                                                        torch.float32),
               GscParams(**params))
    for g, r, tol in zip(got, ref, (2e-5, 1e-6, 2e-5, 2e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol,
                                   rtol=1e-4)


def test_xmu_inputs_match_jax():
    """The packed input (audio, c_b bsq_c, q-branch steps) against the JAX
    wrapper's reduce_window formulation, from a carried register."""
    rng = np.random.default_rng(2)
    m, k, s = 4, 128, 384
    a = (0.2 * rng.standard_normal((2, m, s))).astype(np.float32)
    blk = (0.2 * rng.standard_normal((2, m - 1, k))).astype(np.float32)
    blk[1] = 0.0                                  # q = 0 where bsq is 0
    a[1, :, :10] = 0.0
    p = GscParams(mu0=0.0005, mu_max=0.05)
    got = tk.xmu_inputs(_t(a, torch.float32), _t(blk, torch.float32), p)
    u = a[:, 1:] - a[:, :-1]
    u_ext = jnp.concatenate([jnp.asarray(blk)[:, :, 1:], u], axis=-1)
    bsq = jax.lax.reduce_window(u_ext * u_ext, 0.0, jax.lax.add, (1, 1, k),
                                (1, 1, 1), "valid")
    q = np.float32(p.mu0) * jax.lax.rsqrt(
        jnp.maximum(bsq * np.float32(1.0 / k), 0.0))
    q = jnp.where(q < jnp.inf, q, 0.0)
    ref = jnp.concatenate([a, np.float32(p.mu0 * p.mu0 / k) * bsq, q], 1)
    assert got.shape == (2, 3 * m - 2, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=1e-12)
    assert not got[1, 2 * m - 1:, 0].any()


@pytest.mark.parametrize("use_vad", [False, True])
@pytest.mark.parametrize("block", [128, 256, 512])
def test_blocklms_plain_matches_pallas(use_vad, block):
    """Row 11: the plain block scan in float32 against
    gsc_blocklms_pallas_batched in interpret mode."""
    params = dict(mu0=0.0005, mu_max=0.01, filter_size=128, use_vad=use_vad,
                  vad_threshold=0.05, solver="blocklms", block_samples=block)
    rng = np.random.default_rng(0)
    m, k = 4, 128
    a = (0.2 * rng.standard_normal((m, 2048))).astype(np.float32)
    st = jgsc.gsc_init_state(m, k, jnp.float32)
    ref = jbl.gsc_blocklms_pallas_batched(
        jnp.asarray(a)[None], st.block[None], st.filt[None],
        st.last_out[None], jcfg.GscParams(**params), chunk=1024,
        interpret=True)
    got = tb.gsc_blocklms(_t(a, torch.float32)[None],
                          *_zero_state(1, m, k, torch.float32),
                          GscParams(**params))
    for g, r, tol in zip(got, ref, (5e-6, 1e-7, 2e-6, 5e-6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol,
                                   rtol=1e-4)


@pytest.mark.parametrize("use_vad", [False, True])
@pytest.mark.parametrize("block", [128, 512, 1024])
def test_blocklms_scan_matches_jax_float64(use_vad, block):
    params = dict(mu0=0.001, mu_max=0.01, filter_size=128, use_vad=use_vad,
                  vad_threshold=0.08, solver="blocklms", block_samples=block)
    rng = np.random.default_rng(block)
    m, k = 5, 128
    a = 0.2 * rng.standard_normal((m, 2048))
    leaves = [0.2 * rng.standard_normal((m - 1, k)),
              0.01 * rng.standard_normal((m - 1, k)),
              0.1 * rng.standard_normal(k)]
    ref = jbl.gsc_blocklms_scan(jnp.asarray(a), *map(jnp.asarray, leaves),
                                jcfg.GscParams(**params))
    got = tb.gsc_blocklms_scan(_t(a), *map(_t, leaves), GscParams(**params))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("solver", ["sample", "blocklms"])
def test_plain_versions_chain_state(solver):
    """Two calls chain their state like one long call, bit for bit."""
    rng = np.random.default_rng(1)
    a = _t(0.1 * rng.standard_normal((2, 3, 1024)))
    st = _zero_state(2, 3, 128, torch.float64)
    p = GscParams(mu0=0.001, mu_max=0.05, use_vad=True, vad_threshold=0.08,
                  solver=solver)
    fn = tb.gsc_blocklms if solver == "blocklms" else tk.gsc_sample
    full = fn(a, *st, p)
    one = fn(a[..., :512], *st, p)
    two = fn(a[..., 512:], *one[1:], p)
    assert torch.equal(torch.cat([one[0], two[0]], -1), full[0])
    for x, y in zip(two[1:], full[1:]):
        assert torch.equal(x, y)


def test_wrappers_take_plain_on_cpu():
    rng = np.random.default_rng(3)
    a = _t(0.1 * rng.standard_normal((1, 3, 256)), torch.float32)
    st = _zero_state(1, 3, 128, torch.float32)
    p = GscParams(solver="blocklms")
    before = (tk.gsc_sample.launches, tk.gsc_xmu.launches,
              tb.gsc_blocklms.launches)
    for fn, plain in ((tk.gsc_sample, tk.gsc_sample_plain),
                      (tk.gsc_xmu, tk.gsc_sample_plain),
                      (tb.gsc_blocklms, tb.gsc_blocklms_plain)):
        assert torch.equal(fn(a, *st, p)[0], plain(a, *st, p)[0])
    assert (tk.gsc_sample.launches, tk.gsc_xmu.launches,
            tb.gsc_blocklms.launches) == before


def _vad_decisions_agree(vad: float):
    """The per-sample kernel's VAD test (osq < vad_power_threshold) against
    the reference's sqrt(osq / K) < vad in float32, on every float32
    within 64 ulps of the threshold, and on 0, inf and NaN."""
    thr = np.float32(tk.vad_power_threshold(vad))
    kinv, v = np.float32(1.0 / tk.K), np.float32(vad)
    base = int(np.array(thr).view(np.uint32)) if thr > 0 else 0
    bits = np.arange(max(base - 64, 0), base + 65, dtype=np.int64)
    y = np.concatenate([bits.astype(np.uint32).view(np.float32),
                        np.float32([0.0, np.inf, np.nan])])
    with np.errstate(invalid="ignore"):
        want = np.sqrt(y * kinv) < v
        got = np.maximum(y, np.float32(0)) < thr
    assert np.array_equal(got, want)
    return want


@pytest.mark.parametrize("vad", [0.1, 0.05, 0.025])
def test_vad_power_threshold_decides_as_the_sqrt(vad):
    """At the launch preset's vad_threshold (0.1), the tests' (0.05) and
    chip_smoke.py's (0.025): both decisions occur around the threshold."""
    want = _vad_decisions_agree(vad)
    assert want.any() and not want.all()


def test_vad_power_threshold_random():
    """25 float32 vad_threshold values drawn by hypothesis."""
    hypothesis = pytest.importorskip("hypothesis")
    hst = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=25, deadline=None)
    @hypothesis.given(hst.floats(min_value=2.0 ** -40, max_value=1024.0,
                                 width=32))
    def agree(vad):
        _vad_decisions_agree(vad)

    agree()


@pytest.mark.parametrize("form", ["block", "blocklms"])
@pytest.mark.parametrize("vad", [0.1, 0.05, 0.025])
def test_vad_power_threshold_decides_as_the_block_versions(form, vad):
    """The block kernels test max(osq, 0) < vad_power_threshold where
    their plain versions take sqrt(max(osq, 0) / K) (lookahead-8) or
    sqrt(max(osq / K, 0)) (block LMS, whose osq is a difference of prefix
    sums and may come out slightly negative) < vad_threshold: the same
    decision on every float32 within 64 ulps of the threshold, on negative
    values, 0, inf and NaN."""
    thr = np.float32(tk.vad_power_threshold(vad))
    kinv, v = np.float32(1.0 / tk.K), np.float32(vad)
    base = int(np.array(thr).view(np.uint32))
    bits = np.arange(base - 64, base + 65, dtype=np.int64)
    y = np.concatenate([bits.astype(np.uint32).view(np.float32),
                        np.float32([0.0, -0.0, -1e-30, -1e-7, -3.0,
                                    np.inf, -np.inf, np.nan])])
    z = np.float32(0)
    with np.errstate(invalid="ignore"):
        want = (np.sqrt(np.maximum(y, z) * kinv) < v if form == "block"
                else np.sqrt(np.maximum(y * kinv, z)) < v)
        # NaN-keeping clamp, as the kernels' clamp0: x < 0 ? 0 : x
        got = np.where(y < z, z, y) < thr
    assert np.array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("m", range(2, 17))
@pytest.mark.parametrize("l", tb.VALID_BLOCKS)
def test_blocklms_cluster_plan_and_shared_memory(m, l):
    """What the block-LMS kernel launches with (``cluster_plan``,
    ``smem_bytes``): every channel of M mics owned by exactly one CTA of
    the stream's cluster, each CTA owning one or two, at most the
    portable 8 CTAs, and no CTA's shared memory past the H100's 227 KB."""
    cs, cpc = tb.cluster_plan(m)
    assert 1 <= cs <= tb.MAX_CLUSTER and cpc in (1, 2)
    owned = [c for r in range(cs)
             for c in range(r * cpc, min(m - 1, (r + 1) * cpc))]
    assert owned == list(range(m - 1))
    assert all(r * cpc < m - 1 for r in range(cs))
    smem = tb.smem_bytes(l, cpc)
    assert smem <= 227 * 1024      # a CTA's shared memory on an H100
    # the layout's fixed parts: two ucat rows a channel (one with 4 words
    # of pad) and the partials of the correlations, 8 cpc l floats
    assert smem > 4 * (2 * cpc * (128 + l) + 8 * cpc * l)


def test_gsc_write_mu_trace_matches_jax(tmp_path):
    """The mu trace file, line for line, with the VAD gate overwriting the
    running sum (the reference's accumulate-or-overwrite fold), over two
    streaming chunks appended to one file."""
    x = make_scene(AIRA3, fs=FS, hop=HOP, seconds=0.2, theta_deg=THETA)
    params = dict(VAD, filter_size=16, write_mu=True, vad_threshold=0.06)
    tm, jm = _models(params)
    tm.mu_file_path = str(tmp_path / "port.txt")
    jm.mu_file_path = str(tmp_path / "jax.txt")
    half = (x.shape[1] // HOP // 2) * HOP
    for model, sess in ((tm, StreamingSession(tm)), (jm, JSession(jm))):
        sess.process(x[:, :half], THETA)
        sess.process(x[:, half:], THETA)
    got = open(tm.mu_file_path).read().splitlines()
    ref = open(jm.mu_file_path).read().splitlines()
    assert len(got) == len(ref) == x.shape[1] // HOP
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in ref], rtol=0, atol=1e-12)
    assert len(set(got)) > 3


@pytest.mark.parametrize("solver", ["sample", "blocklms"])
def test_gsc_chunked_equals_offline(solver):
    params = dict(PARITY, filter_size=128, solver=solver)
    x = make_scene(AIRA3, fs=FS, hop=HOP, seconds=0.1, theta_deg=THETA)
    tm, _ = _models(params)
    offline = tm.process(x, THETA).numpy()
    sess = StreamingSession(tm)
    t = x.shape[1] // HOP
    outs = [sess.process(x[:, f0 * HOP:(f0 + 4) * HOP], THETA).numpy()
            for f0 in range(0, t, 4)]
    np.testing.assert_allclose(np.concatenate(outs), offline, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_gsc_checkpoints_move_between_packages(direction, tmp_path):
    """The state (WolaCarry(tail, out_prev (M, hop)), GscState) saves as
    leaf_0..leaf_6 in jax.tree.flatten order; a session resumes in the
    other package, and resumes on the block scan (solver="blocklms") as
    the same package's blocklms session does."""
    x = make_scene(AIRA3, fs=FS, hop=HOP, seconds=0.12, theta_deg=THETA)
    half = (x.shape[1] // HOP // 2) * HOP
    params = dict(PARITY, filter_size=128)
    tm, jm = _models(params)
    full = np.asarray(jm.process(x, THETA))
    first, second = ((JSession(jm), StreamingSession(tm))
                     if direction == "jax_to_port"
                     else (StreamingSession(tm), JSession(jm)))
    y1 = np.asarray(first.process(x[:, :half], THETA))
    ckpt = str(tmp_path / "state.npz")
    first.save(ckpt)
    with np.load(ckpt) as data:
        shapes = [data[f"leaf_{i}"].shape for i in range(7)]
    assert shapes == [(3, HOP), (3, HOP), (2, 128), (2, 128), (128,),
                      (2, 8), (2, 8)]
    second.load(ckpt)
    y2 = np.asarray(second.process(x[:, half:], THETA))
    np.testing.assert_allclose(np.concatenate([y1, y2]), full, rtol=0,
                               atol=1e-12)
    # resume on the block scan, in each package, from the same checkpoint
    lms = dict(params, solver="blocklms")
    tl, jl = _models(lms)
    ts, js = StreamingSession(tl), JSession(jl)
    ts.load(ckpt)
    js.load(ckpt)
    np.testing.assert_allclose(ts.process(x[:, half:], THETA).numpy(),
                               np.asarray(js.process(x[:, half:], THETA)),
                               rtol=0, atol=1e-12)
    if direction == "jax_to_port":
        state = state_from_jax([np.asarray(a) for a in
                                jax.tree.leaves(first.state)],
                               like=tm.stream_init())
        assert isinstance(state[1], tgsc.GscState)
        out, _ = tm.process_chunk(x[:, half:], THETA, state)
        np.testing.assert_allclose(out.numpy(), y2, rtol=0, atol=1e-12)


def test_port_state_resumes_on_the_jax_block_kernel():
    """gram/uold written by the port's per-sample path are exact: the JAX
    package's block kernel (interpret mode) resumes from the port's state
    with no correction transient (tests/test_gsc_block.py's bar)."""
    from beamform_tpu.kernels.gsc_block import gsc_block_pallas_batched
    b, m, k, half = 1, 4, 128, 128
    p = dict(mu0=0.05, mu_max=0.1, filter_size=k)
    rng = np.random.default_rng(3)
    a = (0.3 * rng.standard_normal((b, m, 2 * half))).astype(np.float32)
    full = tk.gsc_sample(_t(a, torch.float32),
                         *_zero_state(b, m, k, torch.float32),
                         GscParams(**p))[0].numpy()
    st = tgsc.gsc_init_state(m, k, torch.float32)
    at = _t(a[0, :, :half], torch.float32)
    out1, blk, flt, lo = tk.gsc_sample(at[None], st.block[None],
                                       st.filt[None], st.last_out[None],
                                       GscParams(**p))
    gram, uold = tgsc.gram_refresh(st.block, st.uold, at[1:] - at[:-1], k)
    out2, *_ = gsc_block_pallas_batched(
        jnp.asarray(a[..., half:]), *(jnp.asarray(v.numpy()) for v in (
            blk, flt, lo, gram[None], uold[None])), jcfg.GscParams(**p),
        chunk=128, interpret=True)
    got = np.concatenate([out1.numpy(), np.asarray(out2)], axis=1)
    np.testing.assert_allclose(got, full,
                               atol=3e-5 * max(float(np.abs(full).max()), 1))


def test_gsc_solver_routing_on_the_cpu():
    """xmu and block run the per-sample recurrence off the card (equal to
    sample), blocklms the block scan; block_samples outside the valid set
    raises, and blocklms falls back to the recurrence only where the JAX
    package does (write_mu, other tap counts, partial blocks)."""
    x = make_scene(AIRA3, fs=FS, hop=HOP, seconds=0.05, theta_deg=THETA)
    outs = {s: _models(dict(PARITY, filter_size=128, solver=s))[0].process(
        x, THETA).numpy() for s in ("sample", "xmu", "block", "blocklms")}
    assert np.array_equal(outs["xmu"], outs["sample"])
    assert np.array_equal(outs["block"], outs["sample"])
    assert np.abs(outs["blocklms"] - outs["sample"]).max() > 1e-9
    with pytest.raises(ValueError, match="block_samples"):
        _models(dict(PARITY, solver="blocklms", block_samples=200))
    with pytest.raises(ValueError, match="unknown GSC solver"):
        _models(dict(PARITY, solver="fast"))
    tm, _ = _models(dict(PARITY, filter_size=128, solver="blocklms",
                         block_samples=1024))
    assert tm._strategy(512) == "sample" and tm._strategy(2048) == "blocklms"
    tm, _ = _models(dict(PARITY, solver="blocklms"))
    assert tm._strategy(1024) == "sample"               # 32 taps


def test_gsc_params_match():
    for kw in ({}, tcfg.load_launch_params("gsc"),
               {"solver": "blocklms", "block_samples": 512}):
        assert (dataclasses.asdict(tcfg.make_params("gsc", kw))
                == dataclasses.asdict(jcfg.make_params("gsc", kw)))


def _cli_pair(tmp_path, monkeypatch, node, extra, x):
    """Run both CLIs on the same WAV (float64, aira3, hop 128) with HOME
    in ``tmp_path``; returns (JAX output, port output)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    cfg = os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira3.yaml")
    args = [node, "--in", src, "--array-config", cfg, "--window-size",
            str(HOP), "--theta", str(THETA), "--dtype", "float64",
            "--out-format", "float32", *extra]
    assert jax_cli(args + ["--out", str(tmp_path / "j.wav")]) == 0
    mu = tmp_path / "mu_behavior.txt"
    if mu.exists():
        mu.rename(tmp_path / "jax_mu.txt")
    assert cli.main(args + ["--out", str(tmp_path / "t.wav"), "--device",
                            "cpu"]) == 0
    ref, _ = wav.read_wav(str(tmp_path / "j.wav"))
    got, fs = wav.read_wav(str(tmp_path / "t.wav"))
    assert fs == FS and got.shape == ref.shape
    return ref, got


@pytest.mark.parametrize("extra", [[], ["--param", "write_mu=false",
                                        "--stream", "4"]],
                         ids=["preset", "no_mu_stream"])
def test_cli_gsc_matches_jax_cli(extra, tmp_path, monkeypatch):
    """Both CLIs with the gsc launch preset (128 taps, write_mu on: each
    writes ~/mu_behavior.txt under its HOME) and with write_mu off."""
    x = make_scene(AIRA3, fs=FS, hop=HOP, seconds=0.08, theta_deg=THETA,
                   seed=4)
    ref, got = _cli_pair(tmp_path, monkeypatch, "gsc", extra, x)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    jax_mu, port_mu = tmp_path / "jax_mu.txt", tmp_path / "mu_behavior.txt"
    if extra:
        assert not jax_mu.exists() and not port_mu.exists()
    else:
        assert port_mu.read_text() == jax_mu.read_text()
        assert len(port_mu.read_text().splitlines()) == x.shape[1] // HOP


def _param_lines(text: str):
    """The warn-and-default lines, with the package's logger name
    normalised."""
    return [ln.replace("beamform_tpu_torch.config", "beamform_tpu.config")
            for ln in text.splitlines() if "argument not found" in ln]


@pytest.mark.parametrize("node", ["gsc", "phase", "ref", "read"])
def test_cli_prints_the_reference_parameter_lines(node, tmp_path,
                                                  monkeypatch, capsys):
    """Both CLIs print the same warn-and-default line for each parameter
    the launch preset does not give (here: none given), at the default
    --log-level; --log-level error silences them in both. ``ref`` and
    ``read`` take DasParams, which has no parameter: no line in either."""
    x = make_scene(AIRA3, fs=FS, hop=HOP, seconds=0.03, theta_deg=THETA)
    extra = ["--launch-preset", "off"]
    if node == "gsc":
        extra += ["--param", "filter_size=16"]
    capsys.readouterr()
    monkeypatch.setenv("HOME", str(tmp_path))
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    args = [node, "--in", src, "--window-size", str(HOP), "--dtype",
            "float64", *extra]
    assert jax_cli(args + ["--out", str(tmp_path / "j.wav")]) == 0
    jax_lines = _param_lines(capsys.readouterr().err)
    assert cli.main(args + ["--out", str(tmp_path / "t.wav"), "--device",
                            "cpu"]) == 0
    port_lines = _param_lines(capsys.readouterr().err)
    assert port_lines == jax_lines
    assert len(port_lines) >= (3 if node in ("gsc", "phase") else 0)
    assert all(ln.startswith("[WARNING] [beamform_tpu.config]: ")
               for ln in port_lines)
    assert cli.main(args + ["--out", str(tmp_path / "t.wav"), "--device",
                            "cpu", "--log-level", "error"]) == 0
    assert not _param_lines(capsys.readouterr().err)


def test_gsc_float32_error_is_the_jax_packages(tmp_path):
    """The JAX package's own float32 error against its float64 path on the
    window chip_smoke.py compares: the first GSC_REF_HOPS hops of its 30 s
    noise and speech inputs, under the launch preset: the max sample
    deviation of the per-sample recurrence (write_mu on, which leaves the
    output as it is) and of the block scan at l = 128 and 512, and the mu
    trace's max relative deviation per line (chip_smoke.mu_trace_dev).
    Printed for chip_smoke.JAX_F32_DEV; the port's float32 plain path is
    held to 1e-3 of float64 on the first 8 hops of each."""
    import chip_smoke
    jcfg16 = jcfg.load_array_config(os.path.join(
        ROOT, "beamform_tpu", "configs", "aira16.yaml"))
    tcfg16 = tcfg.load_array_config(os.path.join(
        ROOT, "beamform_tpu_torch", "configs", "aira16.yaml"))
    from beamform_tpu.models import get_model as jget
    from beamform_tpu_torch.models import get_model as tget
    n = chip_smoke.GSC_REF_HOPS * chip_smoke.HOP
    for scene, make in (("noise", chip_smoke.make_input),
                        ("speech", chip_smoke.make_speech_input)):
        x = make(16, chip_smoke.SECONDS)[:, :n].copy()
        for solver in ("sample", "blocklms128", "blocklms512"):
            p = dict(chip_smoke.preset("gsc", write_mu=solver == "sample"))
            if solver != "sample":
                p.update(solver="blocklms", block_samples=int(solver[8:]))
            ys, traces = {}, {}
            for dt in ("float32", "float64"):
                model = jget("gsc", JEngine(dtype=dt), jcfg16, p)
                model.mu_file_path = str(tmp_path / f"mu_{dt}.txt")
                ys[dt] = np.asarray(model.process(x, chip_smoke.THETA))
                if p["write_mu"]:
                    traces[dt] = np.loadtxt(model.mu_file_path)
            dev = float(np.abs(ys["float32"] - ys["float64"]).max())
            print(f"gsc {solver} {scene} JAX float32 vs float64, "
                  f"{chip_smoke.GSC_REF_HOPS} hops aira16: {dev!r} (peak "
                  f"{float(np.abs(ys['float64']).max())!r})")
            assert dev < 1e-4
            if traces:
                rel = chip_smoke.mu_trace_dev(traces["float32"],
                                              traces["float64"])
                print(f"gsc mu trace {scene} JAX float32 vs float64, "
                      f"{len(traces['float64'])} lines: {rel!r}")
                assert len(traces["float64"]) == chip_smoke.GSC_REF_HOPS
                assert rel < 1e-2
            short = 8 * chip_smoke.HOP
            y = tget("gsc", EngineConfig(), tcfg16, p, device="cpu").process(
                x[:, :short], chip_smoke.THETA).numpy()
            assert np.abs(y - ys["float64"][:short]).max() <= 1e-3
