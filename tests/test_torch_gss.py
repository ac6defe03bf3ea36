"""The port's GSS node against the JAX package and the float64 oracle, on
the CPU.

Every input is made with numpy from a seed and fed to both packages. On
the CPU ``solver="auto"`` and ``"scan"`` run the plain per-frame march
around the WOLA path and ``"mega"`` the fused kernel's plain version
(``kernels/gss_stream.gss_mega``); the JAX package's ``mega`` runs its
Pallas kernel in interpret mode. Bars:

* float64 ``scan`` and ``mega`` vs the JAX ``GssModel`` (``scan``): 1e-9;
  vs ``GssOracle``: 1e-8 for a static set and 1e-7 under events,
  test_parity.py's and test_timeline.py's GSS bars.
* plain ``gss_mega`` vs the JAX kernel, float32: 5e-5 of peak, the bar of
  tests/test_gss_stream.py.
* float32 port vs the JAX model: 5e-5 of peak.
* chunked vs offline, checkpoints across the packages: 1e-12 (float64).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beamform_tpu import config as jcfg
from beamform_tpu import geometry as jgeom
from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.kernels import gss_stream as jgss
from beamform_tpu.models.gss import GssModel as JGss
from beamform_tpu.oracle import nodes as on
from beamform_tpu.oracle.engine import run_oracle
from beamform_tpu.runtime import timeline as jtl
from beamform_tpu.runtime.cli import main as jax_cli
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch import config as tcfg
from beamform_tpu_torch import geometry as tgeom
from beamform_tpu_torch import run_offline
from beamform_tpu_torch.config import EngineConfig, GssParams
from beamform_tpu_torch.config import load_array_config
from beamform_tpu_torch.convert import state_from_jax
from beamform_tpu_torch.kernels import gss_stream as tgss
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.models.gss import GssModel
from beamform_tpu_torch.runtime import cli, wav
from beamform_tpu_torch.runtime.streaming import StreamingSession
from beamform_tpu_torch.runtime.timeline import (InterfEvent,
                                                 replay_interference_events,
                                                 static_interference)

from conftest import AIRA3, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
FS = 48000
THETA = 25.0
PARAMS = dict(freq_mag_threshold=0.0008, freq_max=16000.0, freq_min=100.0,
              out_amp=0.1, mu=0.001, lam=0.0)
XY4 = AIRA3 + [(0.12, 0.07)]
GSS_REL = 5e-5


def _cfg(name):
    return os.path.join(ROOT, "beamform_tpu_torch", "configs", name)


def _engine(dtype):
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)


def _jengine(dtype):
    return JEngine(sample_rate=FS, window_size=HOP, dtype=dtype)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _event_scene():
    """test_timeline.py::test_gss_event_parity_vs_oracle's scene: 4 mics,
    an add at T/3 and a move at 2T/3, threshold 5, capacity 3."""
    x = make_scene(XY4, seconds=0.3, theta_deg=THETA, hop=HOP, seed=11)
    t = x.shape[1] // HOP
    return x, [(t // 3, 1, 60.0), (2 * t // 3, 1, -40.0)]


def _timelines(t, events, capacity=3):
    """The same replay in both packages."""
    return (replay_interference_events(
                t, [], [InterfEvent(*e) for e in events], threshold=5.0,
                capacity=capacity),
            jtl.replay_interference_events(
                t, [], [jtl.InterfEvent(*e) for e in events], threshold=5.0,
                capacity=capacity))


def _models(xy, dtype, solver="scan", interf=(), capacity=None):
    """(port model, JAX model ``scan``) with the same parameters."""
    return (GssModel(_engine(dtype), tgeom.ArrayGeometry.from_xy(xy),
                     GssParams(**PARAMS, solver=solver),
                     interference_angles=interf, capacity=capacity,
                     device="cpu"),
            JGss(_jengine(dtype), jgeom.ArrayGeometry.from_xy(xy),
                 jcfg.GssParams(**PARAMS, solver="scan"),
                 interference_angles=interf, capacity=capacity))


# ---------------------------------------------------------- float64 oracle


@pytest.mark.parametrize("solver", ["scan", "mega"])
@pytest.mark.parametrize("scene", ["static", "timeline", "events"])
def test_gss_float64_matches_jax_and_oracle(solver, scene):
    """test_parity.py's static and theta-change scenes and
    test_timeline.py's event scene, float64, both strategies."""
    if scene == "events":
        x, events = _event_scene()
        t = x.shape[1] // HOP
        tl, tl_j = _timelines(t, events)
        tm, jm = _models(XY4, "float64", solver)
        y = tm.process(x, THETA, interference=tl).numpy()
        y_j = np.asarray(jm.process(x, THETA, interference=tl_j))
        o = on.GssOracle(XY4, HOP, FS, THETA, interference_angles=(),
                         **PARAMS)
        outs = []
        for k in range(t):
            for f, i, a in events:
                if f == k:
                    o.interf_event(i, a, threshold=5.0)
            outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
        ref, bar = np.concatenate(outs), 1e-7
    else:
        x = make_scene(AIRA3, seconds=0.35 if scene == "static" else 0.3,
                       theta_deg=THETA, hop=HOP)
        t = x.shape[1] // HOP
        interf = (60.0,) if scene == "static" else (70.0,)
        th = THETA
        if scene == "timeline":
            th = np.full(t, 10.0)
            th[t // 2:] = -50.0
        tm, jm = _models(AIRA3, "float64", solver, interf)
        y = tm.process(x, th).numpy()
        y_j = np.asarray(jm.process(x, th))
        o = on.GssOracle(AIRA3, HOP, FS, float(np.atleast_1d(th)[0]),
                         interference_angles=interf, **PARAMS)
        outs = []
        for k in range(t):
            if scene == "timeline" and k == t // 2:
                o.set_theta(-50.0)
            outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
        ref, bar = np.concatenate(outs), 1e-8
    assert np.isfinite(y).all() and np.abs(y).max() > 1e-3
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(y, ref, rtol=0, atol=bar)


def test_gss_masked_capacity_equals_exact():
    """test_timeline.py's scene: a capacity-4 static timeline with one
    active slot equals the one-interferer model (the inactive slots are
    zero rows of W and of A^H)."""
    x = make_scene(AIRA3, seconds=0.3, theta_deg=THETA, hop=HOP, seed=5,
                   quiet_hops=4)
    t = x.shape[1] // HOP
    geom = tgeom.ArrayGeometry.from_xy(AIRA3)
    exact = GssModel(_engine("float64"), geom, GssParams(**PARAMS),
                     interference_angles=(60.0,), device="cpu")
    padded = GssModel(_engine("float64"), geom, GssParams(**PARAMS),
                      device="cpu")
    y_masked = padded.process(
        x, THETA, interference=static_interference(t, [60.0], capacity=4))
    np.testing.assert_allclose(y_masked.numpy(),
                               exact.process(x, THETA).numpy(), rtol=0,
                               atol=1e-9)


# ----------------------------------------------------------------- kernel


@pytest.mark.parametrize("case", ["static", "rows_and_resets"])
def test_gss_mega_plain_matches_jax_kernel(case):
    """The plain version against gss_stream.py's kernel in interpret mode on
    the same numpy operands: a carried W with an inactive slot, two control
    rows (one with the slot active) and resets, lambda > 0."""
    rng = np.random.default_rng(41)
    m, t, s = 3, 20, 3
    nfft = 2 * HOP
    x = (0.1 * rng.standard_normal((m, t * HOP))).astype(np.float32)
    x[:, :3 * HOP] *= 1e-4
    tail = (0.1 * rng.standard_normal((m, HOP))).astype(np.float32)
    prev = rng.standard_normal(HOP).astype(np.float32)
    ib = np.arange(3, 100)
    ah = np.exp(1j * rng.uniform(0, 2 * np.pi, (2, s, m, len(ib))))
    ah = ah.astype(np.complex64)
    ah[0, 2] = 0
    w0 = 0.1 * _cplx(rng, (len(ib), s, m))
    w0[:, 2] = 0
    idx = np.zeros(t, np.int64)
    reset = np.zeros(t, bool)
    if case == "rows_and_resets":
        idx[8:15] = 1
        reset[[0, 8, 15]] = True
    args_j = (*(jnp.asarray(a) for a in (x, tail, prev, w0, ah)),
              jnp.asarray(idx.astype(np.int32)), jnp.asarray(reset))
    ref = jgss.gss_mega(*args_j, ib, nfft, 0.0008, 0.01, 0.1,
                        interpret=True)
    got = tgss.gss_mega(*(torch.as_tensor(a) for a in (
        x, tail, prev, w0, ah, idx, reset, ib)), nfft, 0.0008, 0.01, 0.1)
    audio, w_new, prev_new = (g.numpy() for g in got)
    assert audio.dtype == np.float32 and audio.shape == (t * HOP,)
    assert w_new.dtype == np.complex64 and w_new.shape == w0.shape
    assert np.isfinite(audio).all()
    assert _rel(audio, ref[0]) < GSS_REL
    assert _rel(w_new, ref[1]) < GSS_REL
    assert _rel(prev_new, ref[2]) < GSS_REL
    if case == "static":
        assert not w_new[:, 2].any()        # an inactive slot stays zero


def test_gss_mega_short_chunk_keeps_carries():
    w0 = torch.ones((5, 2, 3), dtype=torch.complex64)
    prev = torch.zeros(HOP)
    audio, w, p = tgss.gss_mega(
        torch.zeros((3, 0)), torch.zeros((3, HOP)), prev, w0,
        torch.ones((1, 2, 3, 5), dtype=torch.complex64),
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool),
        torch.arange(1, 6), 2 * HOP, 0.0, 0.01, 0.0)
    assert audio.shape == (0,) and w is w0 and p is prev


def test_gss_fits_band_edges():
    """gss_fits: bin 0 (GSS has no DC special case; the half-spectrum
    fold needs y[0] real) and the Nyquist / shadow bins are out, M <= 32,
    S <= 16, a power-of-two nfft in [256, 4096]."""
    assert tgss.gss_fits(3, np.arange(1, 128), 256, 1)
    assert not tgss.gss_fits(3, np.arange(0, 128), 256, 1)
    assert not tgss.gss_fits(3, np.array([1, 128]), 256, 1)
    assert not tgss.gss_fits(3, np.array([1, 129]), 256, 1)
    assert tgss.gss_fits(16, np.arange(5, 683), 2048, 16)
    assert not tgss.gss_fits(33, np.arange(5, 683), 2048, 3)
    assert not tgss.gss_fits(16, np.arange(5, 683), 2048, 17)
    assert not tgss.gss_fits(16, np.arange(5, 683), 8192, 3)
    for ib, nfft in ((np.arange(1, 128), 256), (np.arange(0, 128), 256),
                     (np.array([1, 128]), 256), (np.arange(5, 683), 2048)):
        assert (tgss.gss_fits(3, ib, nfft, 2)
                == jgss.gss_fits(3, ib, nfft, 2))


def test_gss_strategy():
    """On the CPU ``auto`` and ``scan`` march in plain torch and ``mega``
    takes the fused kernel's plain version; a band with bin 0 refuses
    ``mega``. On CUDA only the kernel runs: ``scan``, float64 and bands it
    cannot take raise (checked without a card: the policy reads only the
    model's device)."""
    geom = tgeom.ArrayGeometry.from_xy(AIRA3)
    for solver, want in (("auto", "scan"), ("scan", "scan"),
                         ("mega", "mega")):
        m = GssModel(_engine("float32"), geom, GssParams(**PARAMS,
                                                         solver=solver),
                     device="cpu")
        assert m._strategy(1) == want
    m = GssModel(_engine("float64"), geom, GssParams(**PARAMS,
                                                     solver="mega"),
                 device="cpu")
    assert m._strategy(2) == "mega"
    dc = GssModel(_engine("float32"), geom,
                  GssParams(**dict(PARAMS, freq_min=0.0), solver="mega"),
                  device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        dc._strategy(1)
    with pytest.raises(ValueError, match="unknown"):
        GssModel(_engine("float32"), geom, GssParams(**PARAMS,
                                                     solver="dense"),
                 device="cpu")

    class OnCuda(GssModel):
        device = torch.device("cuda")

    on_cuda = OnCuda(_engine("float32"), geom, GssParams(**PARAMS),
                     device="cpu")
    assert on_cuda._strategy(16) == "mega"
    for engine, params, match in (
            (_engine("float32"), dict(PARAMS, solver="scan"), "CPU only"),
            (_engine("float64"), PARAMS, "float32"),
            (_engine("float32"), dict(PARAMS, freq_min=0.0), "cannot take")):
        with pytest.raises(ValueError, match=match):
            OnCuda(engine, geom, GssParams(**params),
                   device="cpu")._strategy(1)


def test_gss_params_match():
    for kw in ({}, tcfg.load_launch_params("gss"), {"solver": "mega"},
               {"lambda": 0.5}):
        assert (dataclasses.asdict(tcfg.make_params("gss", kw))
                == dataclasses.asdict(jcfg.make_params("gss", kw)))
    p = tcfg.make_params("gss", tcfg.load_launch_params("gss"))
    assert (p.mu, p.lam, p.out_amp) == (0.001, 0.0, 0.1)
    assert tcfg.make_params("gss", {"lambda": 0.5}).lam == 0.5


# ------------------------------------------------------------ JAX model


@pytest.mark.parametrize("solver", ["scan", "mega"])
@pytest.mark.parametrize("scene", ["static", "events"])
def test_gss_float32_matches_jax_model(solver, scene):
    """float32, the same numpy input: the port's ``scan`` against the JAX
    ``scan``, the port's ``mega`` (plain version) against the JAX ``mega``
    (its kernel in interpret mode)."""
    x = make_scene(XY4, seconds=0.2, theta_deg=THETA, hop=HOP, seed=9,
                   quiet_hops=4).astype(np.float32)
    t = x.shape[1] // HOP
    interf, tl, tl_j = (60.0,), None, None
    if scene == "events":
        interf = ()
        tl, tl_j = _timelines(t, [(t // 3, 1, -70.0), (2 * t // 3, 1, 40.0)])
    tm, _ = _models(XY4, "float32", solver, interf)
    jm = JGss(_jengine("float32"), jgeom.ArrayGeometry.from_xy(XY4),
              jcfg.GssParams(**PARAMS, solver=solver),
              interference_angles=interf)
    ref = np.asarray(jm.process(x, THETA, interference=tl_j))
    got = tm.process(x, THETA, interference=tl)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < GSS_REL


# ------------------------------------------------------------- behaviour


def test_gss_theta_change_resets_w():
    """A theta change resets W to A^H (update_weights, gss.cpp:90-93): the
    state after a change equals that of a fresh session at the new theta
    that saw the same frames, from the reset frame on."""
    x = make_scene(AIRA3, seconds=0.2, theta_deg=THETA, hop=HOP, seed=2)
    t = x.shape[1] // HOP
    geom = tgeom.ArrayGeometry.from_xy(AIRA3)
    model = GssModel(_engine("float64"), geom, GssParams(**PARAMS),
                     interference_angles=(60.0,), device="cpu")
    th = np.full(t, 10.0)
    th[t // 2:] = -30.0
    y, state = model.process_chunk(torch.as_tensor(x[:, :t * HOP]), th,
                                   model.stream_init())
    w_ref = None
    for solver in ("scan", "mega"):
        fresh = GssModel(_engine("float64"), geom,
                         GssParams(**PARAMS, solver=solver),
                         interference_angles=(60.0,), device="cpu")
        st = fresh.stream_init()
        st = (st[0]._replace(tail=torch.as_tensor(
            x[:, (t // 2 - 1) * HOP:(t // 2) * HOP])), st[1], st[2])
        _, st = fresh.process_chunk(torch.as_tensor(x[:, t // 2 * HOP:
                                                      t * HOP]), -30.0, st)
        np.testing.assert_allclose(st[1].numpy(), state[1].numpy(),
                                   rtol=0, atol=1e-12)
        w_ref = st[1] if w_ref is None else w_ref
    assert float(state[2]) == -30.0
    # without the change W carries on from the old steering
    _, same = model.process_chunk(torch.as_tensor(x[:, :t * HOP]), 10.0,
                                  model.stream_init())
    assert np.abs(same[1].numpy() - w_ref.numpy()).max() > 1e-3


@pytest.mark.parametrize("solver", ["scan", "mega"])
def test_gss_inactive_slots_stay_zero(solver):
    """At the CLI's capacity (15 interference slots, S = 16) with one
    event, the state keeps its shape and the inactive slots' rows of W stay
    exactly zero; the output equals the capacity-3 run."""
    x, events = _event_scene()
    t = x.shape[1] // HOP
    outs, states = [], []
    for cap in (3, 15):
        tl, _ = _timelines(t, events[:1], capacity=cap)
        model = GssModel(_engine("float64"), tgeom.ArrayGeometry.from_xy(XY4),
                         GssParams(**PARAMS, solver=solver), device="cpu")
        y, st = model.process_chunk(torch.as_tensor(x[:, :t * HOP]), THETA,
                                    model.stream_init(capacity=cap),
                                    interference=tl)
        outs.append(y.numpy())
        states.append(st[1])
    assert states[1].shape == (states[1].shape[0], 16, 4)
    assert not states[1][:, 2:].any()
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-12)


def test_gss_control_holds_conjugated_values():
    """A^H reaches the kernel as memory that holds the conjugate: a lazy
    ``conj()`` view keeps the unconjugated values behind its data pointer,
    which a kernel reads as they are, so the model resolves it and every
    kernel's tensor check refuses such a view."""
    from beamform_tpu_torch.kernels._build import check_tensor
    model = GssModel(_engine("float32"), tgeom.ArrayGeometry.from_xy(XY4),
                     GssParams(**PARAMS), interference_angles=(60.0,),
                     device="cpu")
    (ah, _, _, _), _, _ = model._controls(np.full((1, 4), THETA))
    assert not ah.is_conj()
    cpu = torch.device("cpu")
    check_tensor(ah, "ah", torch.complex64, ah.shape, cpu)
    with pytest.raises(ValueError, match="conjugate"):
        check_tensor(ah.conj(), "ah", torch.complex64, ah.shape, cpu)


def test_gss_active_bits_come_with_the_cached_control():
    """The model decides which slots are active once, with its cached
    controls: the bits it passes equal those the wrapper derives from A^H
    (capacity 15, one slot active from frame 2), the same control returns
    the same tensor, and the output is the same with or without them."""
    rng = np.random.default_rng(44)
    t = 6
    x = (0.1 * rng.standard_normal((4, t * HOP))).astype(np.float32)
    tl, _ = _timelines(t, [(2, 2, 60.0)], capacity=15)
    model = GssModel(_engine("float32"), tgeom.ArrayGeometry.from_xy(XY4),
                     GssParams(**PARAMS, solver="mega"), capacity=15,
                     device="cpu")
    ctrl, idx, reset = model._controls(np.full((1, t), THETA), tl)
    ah, act, _, bits = ctrl
    assert bits.dtype == torch.int32 and bits.shape == (ah.shape[0],)
    assert torch.equal(bits, tgss._slot_bits(ah, None))
    assert sorted(bits.tolist()) == [0b1, 0b11]
    assert model._controls(np.full((1, t), THETA), tl)[0][3] is bits
    args = (torch.as_tensor(x), torch.zeros((4, HOP)), torch.zeros(HOP),
            torch.zeros((ah.shape[-1], 16, 4), dtype=torch.complex64), ah,
            idx[0], reset | (torch.arange(t) == 0), model.ib, 2 * HOP,
            model.params.freq_mag_threshold, model.params.mu,
            model.params.lam)
    for a, b in zip(tgss.gss_mega(*args, bits), tgss.gss_mega(*args)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- streaming


@pytest.mark.parametrize("solver", ["scan", "mega"])
def test_gss_chunked_equals_offline(solver):
    """Chunks of 4 frames with their own timeline rows and a theta change
    at a chunk boundary's middle equal one offline call (prev_theta and W
    carry across)."""
    x, events = _event_scene()
    t = x.shape[1] // HOP
    tl, _ = _timelines(t, events)
    th = np.full(t, THETA)
    th[t // 2 + 1:] = -10.0
    model = GssModel(_engine("float64"), tgeom.ArrayGeometry.from_xy(XY4),
                     GssParams(**PARAMS, solver=solver), capacity=3,
                     device="cpu")
    offline = model.process(x, th, interference=tl).numpy()
    sess = StreamingSession(model)
    outs = []
    for f0 in range(0, t, 4):
        rows = type(tl)(*(a[f0:f0 + 4] for a in (tl.angles, tl.active,
                                                 tl.row0, tl.reset)))
        outs.append(sess.process(x[:, f0 * HOP:(f0 + 4) * HOP],
                                 th[f0:f0 + 4], interference=rows).numpy())
    np.testing.assert_allclose(np.concatenate(outs), offline, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "fresh_state"])
def test_gss_checkpoints_move_between_packages(direction, tmp_path):
    """The GSS state (WolaCarry, W (NIB, S, M) complex, prev_theta 0-d)
    saves as leaf_0..leaf_3 in jax.tree.flatten order; a session stopped
    under an active timeline resumes in the other package. A fresh
    session's checkpoint carries prev_theta = NaN."""
    x, events = _event_scene()
    t = x.shape[1] // HOP
    half = t // 2
    tl, tl_j = _timelines(t, events)
    tm, jm = _models(XY4, "float64", capacity=3)
    ckpt = str(tmp_path / "state.npz")
    if direction == "fresh_state":
        for first, second in ((StreamingSession(tm), JSession(jm)),
                              (JSession(jm), StreamingSession(tm))):
            first.save(ckpt)
            with np.load(ckpt) as data:
                assert np.isnan(data["leaf_3"]) and data["leaf_3"].ndim == 0
                assert data["leaf_2"].shape == (len(tm.ib_host), 4, 4)
            second.load(ckpt)
            assert np.isnan(np.asarray(second.state[2]))
        return
    full = np.asarray(jm.process(x, THETA, interference=tl_j))

    def rows(timeline, a, b):
        return type(timeline)(*(v[a:b] for v in (
            timeline.angles, timeline.active, timeline.row0,
            timeline.reset)))

    if direction == "jax_to_port":
        first, second = JSession(jm), StreamingSession(tm)
        tl1, tl2 = rows(tl_j, 0, half), rows(tl, half, t)
    else:
        first, second = StreamingSession(tm), JSession(jm)
        tl1, tl2 = rows(tl, 0, half), rows(tl_j, half, t)
    y1 = np.asarray(first.process(x[:, :half * HOP], THETA,
                                  interference=tl1))
    first.save(ckpt)
    with np.load(ckpt) as data:
        assert data["leaf_2"].dtype == np.complex128
        assert float(data["leaf_3"]) == THETA
    second.load(ckpt)
    y2 = np.asarray(second.process(x[:, half * HOP:], interference=tl2))
    assert second.frames_done == t
    np.testing.assert_allclose(np.concatenate([y1, y2]), full, rtol=0,
                               atol=1e-12)
    if direction == "jax_to_port":
        leaves = [np.asarray(a) for a in jax.tree.leaves(first.state)]
        state = state_from_jax(leaves, like=tm.stream_init())
        assert state[1].dtype == torch.complex128 and state[2].ndim == 0
        out, _ = tm.process_chunk(x[:, half * HOP:], THETA, state,
                                  interference=tl2)
        np.testing.assert_allclose(out.numpy(), y2, rtol=0, atol=1e-12)


# -------------------------------------------------------------------- CLI


def _cli_inputs(tmp_path):
    x = make_scene(XY4, seconds=0.3, theta_deg=THETA, hop=HOP, seed=7,
                   quiet_hops=4)
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    cfg = tmp_path / "xy4_interf.yaml"
    cfg.write_text("".join(f"mic{i}: {{id: {i}, x: {px}, y: {py}}}\n"
                           for i, (px, py) in enumerate(XY4))
                   + "angle_interf1: 60.0\n")
    return src, str(cfg)


def _both_clis(tmp_path, args):
    assert jax_cli(args + ["--out", str(tmp_path / "j.wav")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "t.wav"),
                            "--device", "cpu"]) == 0
    ref, _ = wav.read_wav(str(tmp_path / "j.wav"))
    got, fs = wav.read_wav(str(tmp_path / "t.wav"))
    assert fs == FS and got.shape == ref.shape
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    return got


@pytest.mark.parametrize("stream", [[], ["--stream", "8"]])
def test_cli_gss_interference_events_matches_jax_cli(stream, tmp_path):
    """Both CLIs run the gss launch preset, replay the events at capacity
    15 (S = 16 in the state) and apply out_amp; float64. The port's CLI
    equals its run_offline."""
    src, cfg = _cli_inputs(tmp_path)
    events = "0.08:1:-70,0.15:2:30,0.22:2:-70.5"
    got = _both_clis(tmp_path, [
        "gss", "--in", src, "--array-config", cfg, "--window-size",
        str(HOP), "--theta", str(THETA), "--dtype", "float64",
        "--out-format", "float32", "--interference-events", events,
        *stream])
    xin, _ = wav.read_wav(src)
    t = -(-xin.shape[1] // HOP)
    ref = run_offline("gss", xin, engine=_engine("float64"),
                      array_cfg=load_array_config(cfg), theta=THETA,
                      params=tcfg.load_launch_params("gss"), device="cpu",
                      interference=cli.interference_from_spec(
                          events, t, HOP, FS, (60.0,), 1.0))
    np.testing.assert_allclose(got[0], ref, rtol=0, atol=1e-6)


def test_cli_gss_interf_control_matches_jax_cli(tmp_path):
    src, cfg = _cli_inputs(tmp_path)
    ctl = tmp_path / "interf.txt"
    ctl.write_text("1:-50\nbad line\n2:30\n")
    _both_clis(tmp_path, [
        "gss", "--in", src, "--array-config", cfg, "--window-size",
        str(HOP), "--theta", str(THETA), "--dtype", "float64",
        "--out-format", "float32", "--stream", "8", "--interf-control",
        str(ctl)])


def test_cli_gss_static_and_mega(tmp_path):
    """Without events the CLI holds the config's static set; ``--param
    solver=mega`` takes the fused path's plain version on the CPU, equal to
    the scan in float64."""
    src, cfg = _cli_inputs(tmp_path)
    common = ["gss", "--in", src, "--array-config", cfg, "--window-size",
              str(HOP), "--theta", str(THETA), "--dtype", "float64",
              "--out-format", "float32"]
    got = _both_clis(tmp_path, common)
    assert cli.main(common + ["--out", str(tmp_path / "m.wav"), "--device",
                              "cpu", "--param", "solver=mega"]) == 0
    mega, _ = wav.read_wav(str(tmp_path / "m.wav"))
    np.testing.assert_allclose(mega, got, rtol=0, atol=1e-6)


def test_gss_float32_drift_is_the_jax_packages():
    """The float32 march's distance from float64 over 10 s of the aira16
    main-path input (16 mics, hop 1024, 469 dependent frames per bin, the
    gss launch preset, two static interferers), in the JAX package's scan
    and in the port: the port drifts no further than twice the JAX
    package's own float32 scan, and both stay far inside the 1e-3 budget
    (``pytest -s`` prints the numbers)."""
    cfg = dataclasses.replace(load_array_config(_cfg("aira16.yaml")),
                              interference_angles=(70.0, -60.0))
    x = 0.1 * np.random.default_rng(0).standard_normal(
        (16, 10 * FS), dtype=np.float32)
    x[:, :12 * 1024] *= 1e-4
    params = dict(tcfg.load_launch_params("gss"), solver="scan")
    jcfg_ = jcfg.load_array_config(_cfg("aira16.yaml"))
    jgeo = jgeom.ArrayGeometry.from_config(jcfg_)
    drift = {}
    for pkg in ("jax", "port"):
        out = {}
        for dt in ("float32", "float64"):
            if pkg == "jax":
                m = JGss(JEngine(dtype=dt), jgeo, jcfg.make_params(
                    "gss", params), interference_angles=(70.0, -60.0))
                out[dt] = np.asarray(m.process(x, 20.0))
            else:
                out[dt] = run_offline("gss", x, engine=EngineConfig(dtype=dt),
                                      array_cfg=cfg, theta=20.0,
                                      params=params, device="cpu")
        drift[pkg] = np.abs(out["float32"] - out["float64"]).max()
        peak = np.abs(out["float64"]).max()
    print(f"gss float32 vs float64, 10 s aira16: jax {drift['jax']:.3e}, "
          f"port {drift['port']:.3e} (peak {peak:.3e})")
    assert drift["jax"] < 1e-5
    assert drift["port"] <= 2 * drift["jax"]
