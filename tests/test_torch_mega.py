"""The port's fused MVDR/LCMV path (``solver="mega"``) against the JAX
package and the float64 oracle, on the CPU.

Every input is made with numpy from a seed and fed to both packages. On
the CPU the port's ``mvdr_mega``/``lcmv_mega`` run their plain versions
(analysis, gate, unrefined sliding-covariance solve, half-spectrum
synthesis); the JAX package's run its Pallas kernel in interpret mode.
Bars:

* plain ``mvdr_mega``/``lcmv_mega`` vs the JAX kernel, float32: 2e-4 of
  peak, the bar of tests/test_mega_stream.py::test_mega_equals_dense; the
  returned history and carry as well.
* float64 ``solver="mega"`` vs ``MvdrOracle``/``LcmvOracle``: 1e-7,
  test_parity.py's bar.
* float32 port ``mega`` vs the JAX model's ``mega``: 2e-4 of peak.
* chunked vs offline and checkpoints across the packages, float64: 1e-12
  (same package) and 1e-9 (JAX dense path on the other side).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beamform_tpu import geometry as jgeom
from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.config import LcmvParams as JLcmvParams
from beamform_tpu.config import MvdrParams as JMvdrParams
from beamform_tpu.kernels import mega_stream as jmega
from beamform_tpu.models.lcmv import LcmvModel as JLcmv
from beamform_tpu.models.mvdr import MvdrModel as JMvdr
from beamform_tpu.oracle import nodes as on
from beamform_tpu.oracle.engine import run_oracle
from beamform_tpu.runtime import timeline as jtl
from beamform_tpu.runtime.cli import main as jax_cli
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch import geometry as tgeom
from beamform_tpu_torch import run_offline
from beamform_tpu_torch.config import (EngineConfig, LcmvParams, MvdrParams,
                                       load_array_config)
from beamform_tpu_torch.convert import state_from_jax
from beamform_tpu_torch.kernels import mega_stream as tmega
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.models.lcmv import LcmvModel
from beamform_tpu_torch.models.mvdr import MvdrModel, select_solver_strategy
from beamform_tpu_torch.runtime import cli, wav
from beamform_tpu_torch.runtime.streaming import StreamingSession
from beamform_tpu_torch.runtime.timeline import (InterfEvent,
                                                 replay_interference_events)

from conftest import AIRA3, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
FS = 48000
THETA = 25.0
PARAMS = dict(past_windows=6, freq_mag_threshold=0.0008, freq_max=16000.0,
              freq_min=100.0, out_amp=1.0)
XY4 = AIRA3 + [(0.12, 0.07)]
MEGA_REL = 2e-4


def _cfg(name):
    return os.path.join(ROOT, "beamform_tpu_torch", "configs", name)


def _engine(dtype):
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _timeline(t):
    th = np.full(t, 10.0)
    th[t // 2:] = -40.0                       # mid-stream /theta message
    return th


def _event_scene():
    """test_torch_lcmv.py's add / add / remove scene on 4 mics."""
    x = make_scene(XY4, seconds=0.3, theta_deg=THETA, hop=HOP, seed=9,
                   quiet_hops=8)
    t = x.shape[1] // HOP
    events = [(t // 4, 1, 60.0), (t // 2, 2, -80.0), (3 * t // 4, 2, 57.0)]
    return x, events


def _events_timeline(t, events, capacity=4):
    return replay_interference_events(
        t, [], [InterfEvent(f, i, a) for f, i, a in events], threshold=5.0,
        capacity=capacity)


# ----------------------------------------------------------------- kernel


@pytest.mark.parametrize("kind", ["mvdr", "mvdr_timeline", "lcmv"])
def test_mega_plain_matches_jax_kernel(kind):
    """The plain version against mega_stream.py's kernel in interpret mode
    on the same numpy operands: a quiet lead-in (frames whose gate fails
    everywhere skip their solve on the TPU), a carried history and
    carries, a band that starts above bin 1; LCMV with three slots, one of
    them inactive."""
    rng = np.random.default_rng(31)
    m, t, w = 3, 20, 5
    nfft = 2 * HOP
    x = (0.1 * rng.standard_normal((m, t * HOP))).astype(np.float32)
    x[:, :3 * HOP] *= 1e-4
    tail = (0.1 * rng.standard_normal((m, HOP))).astype(np.float32)
    prev = rng.standard_normal(HOP).astype(np.float32)
    ib = np.arange(3, 100)
    hist = 0.1 * _cplx(rng, (w, m, len(ib)))
    idx = (np.zeros(t, np.int64) if kind == "mvdr"
           else rng.integers(0, 2, t))
    if kind == "lcmv":
        ctrl = _cplx(rng, (2, 3, m, len(ib)))
        ctrl[:, 2] = 0
        fn_j, fn_t = jmega.lcmv_mega, tmega.lcmv_mega
    else:
        ctrl = np.exp(1j * rng.uniform(0, 2 * np.pi, (2, m, len(ib))))
        ctrl = ctrl.astype(np.complex64)
        fn_j, fn_t = jmega.mvdr_mega, tmega.mvdr_mega
    thr = 0.0008
    ref = fn_j(*(jnp.asarray(a) for a in (x, tail, prev, hist, ctrl)),
               jnp.asarray(idx.astype(np.int32)), ib, nfft, w, thr,
               interpret=True)
    got = fn_t(*(torch.as_tensor(a) for a in (x, tail, prev, hist, ctrl,
                                                idx, ib)), nfft, w, thr)
    audio, hist_new, prev_new = (g.numpy() for g in got)
    assert audio.dtype == np.float32 and audio.shape == (t * HOP,)
    assert hist_new.dtype == np.complex64 and hist_new.shape == hist.shape
    assert np.isfinite(audio).all()
    assert _rel(audio, ref[0]) < MEGA_REL
    assert _rel(hist_new, ref[1]) < 1e-5
    assert _rel(prev_new, ref[2]) < MEGA_REL


def test_mega_plain_short_chunk_keeps_carries():
    """No whole hop: nothing marches and the carries come back as they
    went in (mega_stream.py's early return)."""
    rng = np.random.default_rng(1)
    hist = torch.as_tensor(_cplx(rng, (4, 3, 9)))
    prev = torch.zeros(HOP)
    audio, h, p = tmega.mvdr_mega(
        torch.zeros((3, 0)), torch.zeros((3, HOP)), prev, hist,
        torch.ones((1, 3, 9), dtype=torch.complex64),
        torch.zeros(0, dtype=torch.int64), torch.arange(1, 10), 2 * HOP, 4,
        0.0)
    assert audio.shape == (0,) and h is hist and p is prev


# ---------------------------------------------------------- float64 oracle


@pytest.mark.parametrize("scene", ["mvdr", "mvdr_timeline", "lcmv_static",
                                   "lcmv_events"])
def test_mega_float64_matches_oracle(scene):
    """test_parity.py's bar (1e-7) for ``solver="mega"`` in float64: MVDR
    with constant steering and a mid-stream theta change, LCMV with a
    static interferer pair and with add / add / remove events."""
    if scene.startswith("mvdr"):
        x = make_scene(AIRA3, seconds=0.35, theta_deg=THETA, hop=HOP,
                       quiet_hops=8)
        t = x.shape[1] // HOP
        th = _timeline(t) if scene == "mvdr_timeline" else THETA
        model = MvdrModel(_engine("float64"), tgeom.ArrayGeometry.from_xy(
            AIRA3), MvdrParams(**PARAMS, solver="mega"), device="cpu")
        y = model.process(x, th).numpy()
        o = on.MvdrOracle(AIRA3, HOP, FS, float(np.atleast_1d(th)[0]),
                          **PARAMS)
        outs = []
        for k in range(t):
            if scene == "mvdr_timeline" and k == t // 2:
                o.set_theta(-40.0)
            outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
        ref = np.concatenate(outs)
    elif scene == "lcmv_static":
        x = make_scene(AIRA3, seconds=0.35, theta_deg=THETA, hop=HOP,
                       quiet_hops=8)
        interf = (60.0, -75.0)
        model = LcmvModel(_engine("float64"), tgeom.ArrayGeometry.from_xy(
            AIRA3), LcmvParams(**PARAMS, solver="mega"),
            interference_angles=interf, device="cpu")
        y = model.process(x, THETA).numpy()
        ref = run_oracle(on.LcmvOracle(AIRA3, HOP, FS, THETA,
                                       interference_angles=interf, **PARAMS),
                         x, HOP)
    else:
        x, events = _event_scene()
        t = x.shape[1] // HOP
        params = dict(PARAMS, past_windows=5)
        model = LcmvModel(_engine("float64"), tgeom.ArrayGeometry.from_xy(
            XY4), LcmvParams(**params, solver="mega"), device="cpu")
        y = model.process(x, THETA,
                          interference=_events_timeline(t, events)).numpy()
        o = on.LcmvOracle(XY4, HOP, FS, THETA, interference_angles=(),
                          **params)
        outs = []
        for k in range(t):
            for f, i, a in events:
                if f == k:
                    o.interf_event(i, a, threshold=5.0)
            outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
        ref = np.concatenate(outs)
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-7)


def test_mega_lcmv_one_slot_equals_mvdr():
    """LCMV with one constraint slot takes MVDR's form, as on the TPU."""
    x = make_scene(AIRA3, seconds=0.2, theta_deg=THETA, hop=HOP, seed=3,
                   quiet_hops=8)
    geom = tgeom.ArrayGeometry.from_xy(AIRA3)
    y_l = LcmvModel(_engine("float64"), geom,
                    LcmvParams(**PARAMS, solver="mega"),
                    device="cpu").process(x, THETA)
    y_m = MvdrModel(_engine("float64"), geom,
                    MvdrParams(**PARAMS, solver="mega"),
                    device="cpu").process(x, THETA)
    np.testing.assert_allclose(y_l.numpy(), y_m.numpy(), rtol=0, atol=1e-9)


# ------------------------------------------------------------ JAX model


@pytest.mark.parametrize("node", ["mvdr", "lcmv"])
def test_mega_float32_matches_jax_model(node):
    """The JAX model's ``mega`` (its Pallas kernel in interpret mode) and
    the port's (the plain version), float32, the same numpy input; LCMV
    with one interferer."""
    x = make_scene(AIRA3, seconds=0.15, theta_deg=THETA, hop=HOP, seed=9,
                   quiet_hops=8).astype(np.float32)
    th = _timeline(x.shape[1] // HOP)
    jeng = JEngine(sample_rate=FS, window_size=HOP)
    jgeo = jgeom.ArrayGeometry.from_xy(AIRA3)
    geo = tgeom.ArrayGeometry.from_xy(AIRA3)
    if node == "mvdr":
        jm = JMvdr(jeng, jgeo, JMvdrParams(**PARAMS, solver="mega"))
        tm = MvdrModel(_engine("float32"), geo,
                       MvdrParams(**PARAMS, solver="mega"), device="cpu")
    else:
        jm = JLcmv(jeng, jgeo, JLcmvParams(**PARAMS, solver="mega"),
                   interference_angles=(60.0,))
        tm = LcmvModel(_engine("float32"), geo,
                       LcmvParams(**PARAMS, solver="mega"),
                       interference_angles=(60.0,), device="cpu")
    np.testing.assert_array_equal(tm.ib.numpy(), jm.ib)
    ref = np.asarray(jm.process(x, th))
    got = tm.process(x, th)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < MEGA_REL


# ------------------------------------------------------------- streaming


@pytest.mark.parametrize("node", ["mvdr", "lcmv"])
def test_mega_chunked_equals_offline(node):
    """Chunks of 4 frames (shorter than past_windows: the history splice),
    a theta timeline for MVDR and per-chunk timeline rows for LCMV."""
    x, events = _event_scene()
    t = x.shape[1] // HOP
    params = dict(PARAMS, past_windows=5, solver="mega")
    geom = tgeom.ArrayGeometry.from_xy(XY4)
    if node == "mvdr":
        model = MvdrModel(_engine("float64"), geom, MvdrParams(**params),
                          device="cpu")
        tl, th = None, _timeline(t)
    else:
        model = LcmvModel(_engine("float64"), geom, LcmvParams(**params),
                          device="cpu")
        tl, th = _events_timeline(t, events, capacity=15), THETA
    kw = {} if tl is None else dict(interference=tl)
    offline = model.process(x, th, **kw).numpy()
    sess = StreamingSession(model)
    outs = []
    for f0 in range(0, t, 4):
        kw = {} if tl is None else dict(interference=type(tl)(
            *(a[f0:f0 + 4] for a in (tl.angles, tl.active, tl.row0,
                                     tl.reset))))
        thc = th if tl is not None else th[f0:f0 + 4]
        outs.append(sess.process(x[:, f0 * HOP:(f0 + 4) * HOP], thc,
                                 **kw).numpy())
    np.testing.assert_allclose(np.concatenate(outs), offline, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mega_checkpoints_move_between_packages(direction, tmp_path):
    """A port ``mega`` session's checkpoint resumes in the JAX package
    (its dense path, float64) and back; LCMV under an active timeline."""
    x, events = _event_scene()
    t = x.shape[1] // HOP
    half = t // 2
    p = dict(PARAMS, past_windows=5)
    tl = _events_timeline(t, events)
    tl_j = jtl.replay_interference_events(
        t, [], [jtl.InterfEvent(*e) for e in events], capacity=4)
    jmodel = JLcmv(JEngine(sample_rate=FS, window_size=HOP, dtype="float64"),
                   jgeom.ArrayGeometry.from_xy(XY4), JLcmvParams(**p))
    tmodel = LcmvModel(_engine("float64"), tgeom.ArrayGeometry.from_xy(XY4),
                       LcmvParams(**p, solver="mega"), device="cpu")
    full = np.asarray(jmodel.process(x, THETA, interference=tl_j))

    def rows(timeline, a, b):
        return type(timeline)(*(v[a:b] for v in (
            timeline.angles, timeline.active, timeline.row0,
            timeline.reset)))

    ckpt = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        first, second = JSession(jmodel), StreamingSession(tmodel)
        tl1, tl2 = rows(tl_j, 0, half), rows(tl, half, t)
    else:
        first, second = StreamingSession(tmodel), JSession(jmodel)
        tl1, tl2 = rows(tl, 0, half), rows(tl_j, half, t)
    y1 = np.asarray(first.process(x[:, :half * HOP], THETA,
                                  interference=tl1))
    first.save(ckpt)
    second.load(ckpt)
    y2 = np.asarray(second.process(x[:, half * HOP:], interference=tl2))
    assert second.frames_done == t
    np.testing.assert_allclose(np.concatenate([y1, y2]), full, rtol=0,
                               atol=1e-9)
    if direction == "jax_to_port":
        leaves = [np.asarray(a) for a in jax.tree.leaves(first.state)]
        state = state_from_jax(leaves, like=tmodel.stream_init())
        out, _ = tmodel.process_chunk(x[:, half * HOP:], THETA, state,
                                      interference=tl2)
        np.testing.assert_allclose(out.numpy(), y2, rtol=0, atol=1e-12)


# -------------------------------------------------------------------- CLI


def test_cli_param_solver_mega(tmp_path):
    """``--param solver=mega`` for mvdr (offline) and lcmv (``--stream``
    with events) equals ``run_offline`` with the same solver, and the JAX
    CLI (its default solver), in float64."""
    x = make_scene(XY4, seconds=0.3, theta_deg=THETA, hop=HOP, seed=7,
                   quiet_hops=12)
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    cfg_path = tmp_path / "xy4.yaml"
    cfg_path.write_text("".join(f"mic{i}: {{id: {i}, x: {px}, y: {py}}}\n"
                                for i, (px, py) in enumerate(XY4))
                        + "angle_interf1: 60.0\n")
    xin, _ = wav.read_wav(src)
    cfg = load_array_config(str(cfg_path))
    t = -(-xin.shape[1] // HOP)
    for node, extra in (("mvdr", []),
                        ("lcmv", ["--stream", "8", "--interference-events",
                                  "0.08:1:-70,0.15:2:30,0.22:2:-70.5"])):
        common = [node, "--in", src, "--array-config", str(cfg_path),
                  "--window-size", str(HOP), "--theta", str(THETA),
                  "--out-format", "float32", "--dtype", "float64", *extra]
        assert cli.main(common + ["--out", str(tmp_path / "t.wav"),
                                  "--device", "cpu", "--param",
                                  "solver=mega"]) == 0
        assert jax_cli(common + ["--out", str(tmp_path / "j.wav")]) == 0
        got, fs = wav.read_wav(str(tmp_path / "t.wav"))
        ref_j, _ = wav.read_wav(str(tmp_path / "j.wav"))
        tl = (cli.interference_from_spec(extra[-1], t, HOP, FS, (60.0,), 1.0)
              if extra else None)
        params = dict(cli.load_launch_params(node), solver="mega")
        ref = run_offline(node, xin, engine=_engine("float64"),
                          array_cfg=cfg, theta=THETA, params=params,
                          device="cpu", interference=tl)
        assert fs == FS and got.shape == (1, ref.shape[0])
        assert np.abs(ref).max() > 0.01
        np.testing.assert_allclose(got[0], ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, ref_j, rtol=0, atol=1e-6)


# ----------------------------------------------------------------- policy


def test_mega_fits_refusals():
    """mega_fits: the band's bins in [1, nfft / 2) (the half-spectrum fold
    would double the Nyquist bin and its shadow), M <= 32, S <= 16, the
    solve tile within shared memory."""
    ib = np.arange(5, 683)                     # the 16-ch launch band
    assert tmega.mega_fits(16, ib, 2048, 0, 10)
    assert tmega.mega_fits(16, ib, 2048, 16, 10)
    assert not tmega.mega_fits(16, np.array([5, 1024]), 2048, 0, 10)
    assert not tmega.mega_fits(16, np.array([5, 1025]), 2048, 0, 10)
    assert not tmega.mega_fits(16, np.array([0, 5]), 2048, 0, 10)
    assert not tmega.mega_fits(33, ib, 2048, 0, 10)
    assert not tmega.mega_fits(16, ib, 2048, 17, 10)
    assert not tmega.mega_fits(16, ib, 2048, 0, 300)
    assert not tmega.mega_fits(16, ib, 8192, 0, 10)
    assert tmega.band_fits(np.array([1, 127]), 256)
    assert not tmega.band_fits(np.array([1, 128]), 256)


def test_mega_smem_bytes_follow_the_kernel_layout():
    """smem_bytes is the largest of stage A's analysis frames (17 x 256
    complex for every nfft), one synthesis frame and stage B's solve: the
    staged tile ((32 + W) x 8 bins x (MP + 2)), two column buffers of MP + 1
    pairs for each of the 512 / MP problems in flight, and LCMV's X scratch
    (SP x MP each), MP = max(M, S) rounded up to a power of two (at least
    4; one slot takes the MVDR form on M)."""
    nb = 8                                     # bytes of a complex64
    assert tmega.smem_bytes(16, 10, 0, 2048) == nb * (42 * 8 * 18 + 32 * 34)
    assert tmega.smem_bytes(16, 10, 1, 2048) == tmega.smem_bytes(16, 10, 0,
                                                                 2048)
    assert tmega.smem_bytes(16, 10, 3, 2048) == nb * (42 * 8 * 18 + 32 * 34
                                                      + 32 * 4 * 16)
    assert tmega.smem_bytes(16, 10, 16, 2048) == nb * (42 * 8 * 18 + 32 * 34
                                                       + 32 * 16 * 16)
    assert tmega.smem_bytes(3, 10, 16, 2048) == tmega.smem_bytes(16, 10, 16,
                                                                 2048)
    assert tmega.smem_bytes(32, 10, 16, 2048) == nb * (42 * 8 * 34 + 16 * 66
                                                       + 16 * 16 * 32)
    # small problems: stage A's analysis frames, or a 4096-point frame
    assert tmega.smem_bytes(1, 10, 0, 256) == nb * 17 * 256
    assert tmega.smem_bytes(1, 1, 0, 4096) == nb * 17 * 256
    # the capacity the rule gives at 16 mics
    ib = np.arange(5, 683)
    assert tmega.mega_fits(16, ib, 2048, 0, 162)
    assert not tmega.mega_fits(16, ib, 2048, 0, 163)
    assert tmega.mega_fits(16, ib, 2048, 16, 105)
    assert not tmega.mega_fits(16, ib, 2048, 16, 106)


@pytest.mark.parametrize("cfg_name", ["aira3.yaml", "aira16.yaml"])
def test_solver_choice_under_the_launch_presets(cfg_name):
    """For aira3 and aira16 under the MVDR and LCMV launch presets (W 10,
    nfft 2048, the preset's band), a CUDA float32 engine takes the stream
    kernel under ``auto`` and the fused kernel under ``mega``, for MVDR and
    for LCMV at 1, 3 and 16 slots (the CLI's capacity 15 plus the look
    direction), as before the solves' shared-memory rules changed."""
    cuda = torch.device("cuda")
    for node, caps in (("mvdr", (0,)), ("lcmv", (1, 3, 16))):
        model = get_model(node, EngineConfig(), load_array_config(
            _cfg(cfg_name)), cli.load_launch_params(node), device="cpu")
        m = model.geom.num_mics
        w, nfft = model.params.past_windows, model.engine.fft_win
        assert (w, nfft) == (10, 2048)
        for s_cap in caps:
            for solver, want in (("auto", "stream"), ("mega", "mega")):
                got = select_solver_strategy(solver, torch.complex64, m, w,
                                             cuda, s_cap=s_cap,
                                             ib=model.ib_host, nfft=nfft)
                assert got == want, (node, m, s_cap, solver)


def test_mega_solver_policy():
    """``mega`` runs the fused path on both devices, float32 on CUDA only,
    within the kernel's capacity; ``auto`` keeps its choice (stream on a
    CUDA float32 engine, dense on the CPU)."""
    c64, c128 = torch.complex64, torch.complex128
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    ib = np.arange(5, 683)
    kw = dict(ib=ib, nfft=2048)
    assert select_solver_strategy("mega", c64, 16, 10, cuda, **kw) == "mega"
    assert select_solver_strategy("mega", c64, 16, 10, cpu, **kw) == "mega"
    assert select_solver_strategy("mega", c128, 16, 10, cpu, **kw) == "mega"
    assert select_solver_strategy("mega", c64, 16, 10, cuda, s_cap=3,
                                  **kw) == "mega"
    assert select_solver_strategy("auto", c64, 16, 10, cuda, **kw) == "stream"
    assert select_solver_strategy("auto", c64, 16, 10, cpu, **kw) == "dense"
    with pytest.raises(ValueError, match="float32"):
        select_solver_strategy("mega", c128, 16, 10, cuda, **kw)
    with pytest.raises(ValueError, match="capacity"):
        select_solver_strategy("mega", c64, 40, 10, cuda, **kw)
    with pytest.raises(ValueError, match="capacity"):
        select_solver_strategy("mega", c64, 16, 10, cuda, s_cap=17, **kw)
    for dev in (cuda, cpu):
        with pytest.raises(ValueError, match="Nyquist"):
            select_solver_strategy("mega", c64, 16, 10, dev,
                                   ib=np.array([5, 1024]), nfft=2048)
    # a model whose band reaches Nyquist refuses mega on the CPU too
    model = get_model("mvdr", _engine("float32"),
                      load_array_config(_cfg("aira3.yaml")),
                      dict(PARAMS, freq_max=24000.0, solver="mega"),
                      device="cpu")
    with pytest.raises(ValueError, match="Nyquist"):
        model.process(np.zeros((3, 4 * HOP), np.float32), THETA)


def test_mega_lcmv_trims_slots_before_the_kernel(monkeypatch):
    """LCMV drops the slots no control row uses before the fused path too:
    a capacity-15 timeline with one interferer reaches the kernel at
    S = 2."""
    import beamform_tpu_torch.models.lcmv as lcmv_mod
    x, _ = _event_scene()
    t = x.shape[1] // HOP
    seen = []

    def spy(x_, tail, prev, hist, c_ib, *a, **k):
        seen.append(c_ib.shape[1])
        return tmega.lcmv_mega(x_, tail, prev, hist, c_ib, *a, **k)

    monkeypatch.setattr(lcmv_mod, "lcmv_mega", spy)
    cfg = dataclasses.replace(load_array_config(_cfg("aira3.yaml")),
                              interference_angles=())
    model = get_model("lcmv", _engine("float64"), cfg,
                      dict(PARAMS, solver="mega"), device="cpu")
    tl = _events_timeline(t, [(t // 2, 1, 60.0)], capacity=15)
    assert np.isfinite(model.process(x[:3], THETA,
                                     interference=tl).numpy()).all()
    assert seen == [2]
