"""The port's MVDR path against the JAX package and the float64 oracle.

Every input is made with numpy from a seed and fed to both packages; the
scenes keep their first hops quiet (``quiet_hops`` >= past_windows), so no
cold-start covariance passes the energy gate. Bars:

* float64 port (``dense`` and plain ``stream``) vs the float64 oracle:
  1e-7, test_parity.py's MVDR bar.
* plain ``mvdr_stream`` vs the JAX Pallas kernel in interpret mode, both
  float32: 2e-4 of peak, each within 1e-4 of the float64 plain version.
  Same solve (Cholesky + one refinement), but the JAX kernel keeps sliding
  and epoch sums where the port sums each window directly, and random
  covariances with W < M are conditioned only by the 1.001 loading, so
  each float32 result carries ~1e-4 of round-off on its own.
* plain ``gauss_jordan_inv`` vs the JAX kernel, float32: 1e-5 of peak
  (same elimination, division rounded another way); float64 vs the JAX
  function: 1e-12.
* float32 port ``MvdrModel`` vs the JAX ``MvdrModel`` with the same solver:
  2e-4 of peak, the JAX package's stream-vs-dense bar.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beamform_tpu import geometry as jgeom
from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.config import MvdrParams as JMvdrParams
from beamform_tpu.config import load_array_config as jload
from beamform_tpu.kernels.linalg import gauss_jordan_inv as jax_gj
from beamform_tpu.kernels.linalg import gj_inverse_pallas
from beamform_tpu.kernels.mvdr_stream import mvdr_stream_pallas
from beamform_tpu.models.mvdr import MvdrModel as JMvdr
from beamform_tpu.oracle import nodes as on
from beamform_tpu.oracle.engine import run_oracle
from beamform_tpu.runtime.cli import main as jax_cli
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch import geometry as tgeom
from beamform_tpu_torch.config import EngineConfig, MvdrParams
from beamform_tpu_torch.config import load_array_config
from beamform_tpu_torch.convert import constants_from_jax, state_from_jax
from beamform_tpu_torch.kernels import linalg as tl
from beamform_tpu_torch.kernels.mvdr_stream import mvdr_stream
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.models.mvdr import MvdrModel, select_solver_strategy
from beamform_tpu_torch.runtime import cli, wav
from beamform_tpu_torch.runtime.streaming import StreamingSession

from conftest import AIRA3, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
FS = 48000
THETA = 25.0
PARAMS = dict(past_windows=6, freq_mag_threshold=0.0008, freq_max=16000.0,
              freq_min=100.0, out_amp=1.0)
STREAM_REL = 2e-4
STREAM_F64_REL = 1e-4
GJ_REL = 1e-5
MODEL_REL = 2e-4


def _cfg(name):
    return os.path.join(ROOT, "beamform_tpu_torch", "configs", name)


def _engines(dtype):
    kw = dict(sample_rate=FS, window_size=HOP, dtype=dtype)
    return JEngine(**kw), EngineConfig(**kw)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _timeline(t):
    th = np.full(t, 10.0)
    th[t // 2:] = -40.0                       # mid-stream /theta message
    return th


def _scene(xy, seconds=0.3, seed=0, quiet_hops=8):
    return make_scene(xy, fs=FS, seconds=seconds, theta_deg=THETA, hop=HOP,
                      seed=seed, quiet_hops=quiet_hops)


def _xy(cfg):
    return [(m.x, m.y) for m in cfg.mics]


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------- float64 oracle


@pytest.mark.parametrize("timeline", [False, True])
@pytest.mark.parametrize("solver", ["dense", "stream"])
def test_mvdr_float64_matches_oracle(solver, timeline):
    """test_parity.py's MVDR bar (1e-7) for both port strategies, constant
    steering and a mid-stream theta change."""
    x = _scene(AIRA3, seconds=0.35)
    t = x.shape[1] // HOP
    th = _timeline(t) if timeline else THETA
    _, teng = _engines("float64")
    model = MvdrModel(teng, tgeom.ArrayGeometry.from_xy(AIRA3),
                      MvdrParams(**PARAMS, solver=solver), device="cpu")
    y = model.process(x, th).numpy()
    o = on.MvdrOracle(AIRA3, HOP, FS, float(np.atleast_1d(th)[0]), **PARAMS)
    outs = []
    for k in range(t):
        if timeline and k == t // 2:
            o.set_theta(-40.0)
        outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y, np.concatenate(outs), rtol=0, atol=1e-7)


def test_mvdr_float64_aira16_dense_equals_stream_and_oracle():
    cfg = load_array_config(_cfg("aira16.yaml"))
    xy = _xy(cfg)
    x = _scene(xy, seconds=0.2, seed=3)
    _, teng = _engines("float64")
    ys = [MvdrModel(teng, tgeom.ArrayGeometry.from_xy(xy),
                    MvdrParams(**PARAMS, solver=s),
                    device="cpu").process(x, THETA).numpy()
          for s in ("dense", "stream")]
    ref = run_oracle(on.MvdrOracle(xy, HOP, FS, THETA, **PARAMS), x, HOP)
    for y in ys:
        np.testing.assert_allclose(y, ref, rtol=0, atol=1e-7)


# ----------------------------------------------------------------- kernels


@pytest.mark.parametrize("steering", ["one", "timeline"])
def test_mvdr_stream_plain_matches_jax_kernel(steering):
    """Plain mvdr_stream vs mvdr_stream_pallas (interpret mode), comparing
    the gated output where(gate, y, 0.01 x0), float32."""
    t, m, w, nib, nb = 14, 8, 6, 9, 13
    rng = np.random.default_rng(21)
    x = _cplx(rng, (t, m, nb))
    ib = np.arange(2, 2 + nib)
    hist = _cplx(rng, (w, m, nib))
    u = 1 if steering == "one" else 3
    d = _cplx(rng, (u, m, nib))
    w_idx = (np.zeros(t, np.int64) if u == 1
             else np.repeat(np.arange(u), -(-t // u))[:t])
    gate = rng.random((t, nib)) < 0.6
    gate[3] = False                              # a silent frame

    x_ib = x[:, :, ib]
    act = gate.any(axis=1).astype(np.int32)
    y_k = mvdr_stream_pallas(
        jnp.asarray(np.concatenate([hist, x_ib])), jnp.asarray(d),
        jnp.asarray(w_idx.astype(np.int32)), jnp.asarray(act), w_hist=w,
        interpret=True)
    ref = np.where(gate, np.asarray(y_k), 0.01 * x_ib[:, 0, :])

    got = mvdr_stream(*(torch.as_tensor(a) for a in
                        (x, hist, d, w_idx, gate, ib)))
    f64 = mvdr_stream(*(torch.as_tensor(a.astype(np.complex128))
                        for a in (x, hist, d)),
                      *(torch.as_tensor(a) for a in (w_idx, gate, ib)))
    assert got.dtype == torch.complex64 and got.shape == (t, nib)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), ref) < STREAM_REL
    assert _rel(got.numpy(), f64.numpy()) < STREAM_F64_REL
    assert _rel(ref, f64.numpy()) < STREAM_F64_REL
    np.testing.assert_array_equal(got.numpy()[~gate], ref[~gate])


@pytest.mark.parametrize("polish", [False, True])
def test_gj_inverse_plain_matches_jax_kernel(polish):
    rng = np.random.default_rng(4)
    b, m = 37, 16
    a = _cplx(rng, (b, m, m))
    a = (a @ a.conj().transpose(0, 2, 1) / m + 0.5 * np.eye(m)
         ).astype(np.complex64)
    ref = np.asarray(gj_inverse_pallas(jnp.asarray(a), interpret=True,
                                       polish=polish))
    got = tl.gj_inverse(torch.as_tensor(a), polish=polish)
    assert got.dtype == torch.complex64 and got.shape == (b, m, m)
    assert _rel(got.numpy(), ref) < GJ_REL


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_gauss_jordan_inv_float64_matches_jax(kind):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 3, 6, 6))
    if kind == "complex":
        a = a + 1j * rng.standard_normal(a.shape)
    a = a @ np.conj(np.swapaxes(a, -1, -2)) + 6 * np.eye(6)
    got = tl.gauss_jordan_inv(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_gj(jnp.asarray(a))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, np.linalg.inv(a), rtol=0, atol=1e-12)


# ------------------------------------------------------------ JAX model


@pytest.mark.parametrize("array", ["aira3.yaml", "aira16.yaml"])
@pytest.mark.parametrize("solver", ["dense", "stream"])
def test_mvdr_float32_matches_jax_model(solver, array):
    """The JAX model's stream solver runs its Pallas kernel in interpret
    mode on the CPU; the port's runs the plain version."""
    cfg_j, cfg_t = jload(_cfg(array)), load_array_config(_cfg(array))
    x = _scene(_xy(cfg_t), seconds=0.15, seed=9).astype(np.float32)
    th = _timeline(x.shape[1] // HOP)
    jeng, teng = _engines("float32")
    jm = JMvdr(jeng, jgeom.ArrayGeometry.from_config(cfg_j),
               JMvdrParams(**PARAMS, solver=solver))
    tm = get_model("mvdr", teng, cfg_t, dict(PARAMS, solver=solver),
                   device="cpu")
    tm.load_state_dict(constants_from_jax(jm))
    np.testing.assert_array_equal(tm.ib.numpy(), jm.ib)
    ref = np.asarray(jm.process(x, th))
    got = tm.process(x, th)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < MODEL_REL


# ------------------------------------------------------------- streaming


@pytest.mark.parametrize("solver", ["dense", "stream"])
def test_mvdr_chunked_equals_offline(solver):
    _, teng = _engines("float64")
    cfg = load_array_config(_cfg("aira3.yaml"))
    x = _scene(AIRA3, seconds=0.25, seed=4)
    t = x.shape[1] // HOP
    th = _timeline(t)
    model = get_model("mvdr", teng, cfg, dict(PARAMS, solver=solver),
                      device="cpu")
    offline = model.process(x, th).numpy()
    sess = StreamingSession(model)
    # chunks shorter than past_windows exercise the history splice
    outs = [sess.process(x[:, i * HOP:(i + 4) * HOP], th[i:i + 4]).numpy()
            for i in range(0, t, 4)]
    np.testing.assert_allclose(np.concatenate(outs)[:len(offline)], offline,
                               rtol=0, atol=1e-12)


def test_checkpoint_of_nested_complex_state_roundtrips(tmp_path):
    """The MVDR state (WolaCarry(tail, out_prev), hist complex) saves as
    leaf_0..leaf_2 in jax.tree.flatten order and loads back exactly."""
    _, teng = _engines("float32")
    cfg = load_array_config(_cfg("aira3.yaml"))
    model = get_model("mvdr", teng, cfg, PARAMS, device="cpu")
    x = _scene(AIRA3, seconds=0.1, seed=2).astype(np.float32)
    sess = StreamingSession(model)
    sess.process(x, THETA)
    path = str(tmp_path / "mvdr.npz")
    sess.save(path)
    with np.load(path) as data:
        assert data["leaf_2"].dtype == np.complex64
        np.testing.assert_array_equal(data["leaf_2"], sess.state[1].numpy())
        np.testing.assert_array_equal(data["leaf_0"],
                                      sess.state[0].tail.numpy())
    again = StreamingSession(get_model("mvdr", teng, cfg, PARAMS,
                                       device="cpu"))
    again.load(path)
    assert type(again.state[0]).__name__ == "WolaCarry"
    for a, b in zip((*again.state[0], again.state[1]),
                    (*sess.state[0], sess.state[1])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert again.frames_done == sess.frames_done


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mvdr_checkpoints_move_between_packages(direction, tmp_path):
    cfg_j = jload(_cfg("aira3.yaml"))
    cfg_t = load_array_config(_cfg("aira3.yaml"))
    jeng, teng = _engines("float32")
    x = _scene(AIRA3, seconds=0.2, seed=6).astype(np.float32)
    half = (x.shape[1] // (2 * HOP)) * HOP
    jmodel = JMvdr(jeng, jgeom.ArrayGeometry.from_config(cfg_j),
                   JMvdrParams(**PARAMS))
    tmodel = get_model("mvdr", teng, cfg_t, PARAMS, device="cpu")
    full = np.asarray(jmodel.process(x, THETA))
    ckpt = str(tmp_path / "state.npz")

    if direction == "jax_to_port":
        first, second = JSession(jmodel), StreamingSession(tmodel)
    else:
        first, second = StreamingSession(tmodel), JSession(jmodel)
    y1 = np.asarray(first.process(x[:, :half], THETA))
    first.save(ckpt)
    second.load(ckpt)
    y2 = np.asarray(second.process(x[:, half:]))    # theta holds
    assert second.frames_done == x.shape[1] // HOP
    assert _rel(np.concatenate([y1, y2]), full) < MODEL_REL

    if direction == "jax_to_port":
        # the same hand-over in memory, through convert.state_from_jax
        leaves = [np.asarray(a) for a in jax.tree.leaves(first.state)]
        state = state_from_jax(leaves, like=tmodel.stream_init())
        assert state[1].dtype == torch.complex64
        out, _ = tmodel.process_chunk(x[:, half:], THETA, state)
        assert _rel(out, y2) < MODEL_REL
        with pytest.raises(ValueError, match="leaves"):
            state_from_jax(leaves[:2], like=tmodel.stream_init())


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("extra", [[], ["--param", "freq_max=4000"],
                                   ["--launch-preset", "off", "--param",
                                    "freq_mag_threshold=0.001"]])
def test_cli_mvdr_matches_jax_cli(extra, tmp_path):
    """Both CLIs start from the launch preset (past_windows 10, threshold
    0.001, 100..16000 Hz, out_amp 1) and apply --param on top."""
    x = _scene(AIRA3, seconds=0.2, seed=7, quiet_hops=12)
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    common = ["mvdr", "--in", src, "--array-config", _cfg("aira3.yaml"),
              "--window-size", str(HOP), "--theta", str(THETA),
              "--out-format", "float32", *extra]
    assert jax_cli(common + ["--out", str(tmp_path / "j.wav")]) == 0
    assert cli.main(common + ["--out", str(tmp_path / "t.wav"),
                              "--device", "cpu"]) == 0
    ref, _ = wav.read_wav(str(tmp_path / "j.wav"))
    got, fs = wav.read_wav(str(tmp_path / "t.wav"))
    assert fs == FS and got.shape == ref.shape
    assert np.abs(ref).max() > 0.01
    assert _rel(got, ref) < MODEL_REL


def test_cli_node_params():
    args = cli.build_parser().parse_args(
        ["mvdr", "--in", "x.wav", "--param", "freq_max=4000",
         "--param", "solver=dense", "--param", "flag=true"])
    assert cli._node_params(args) == dict(
        past_windows=10, freq_mag_threshold=0.001, freq_max=4000,
        freq_min=100, out_amp=1.0, solver="dense", flag=True)
    args = cli.build_parser().parse_args(
        ["das", "--in", "x.wav", "--launch-preset", "off"])
    assert cli._node_params(args) == {}
    args = cli.build_parser().parse_args(
        ["mvdr", "--in", "x.wav", "--param", "freq_max"])
    with pytest.raises(ValueError, match="KEY=VALUE"):
        cli._node_params(args)


# ----------------------------------------------------------------- policy


def test_solver_policy():
    c64, c128 = torch.complex64, torch.complex128
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert select_solver_strategy("auto", c64, 16, 10, cuda) == "stream"
    # past the stream tile's shared memory, the dense path takes over
    assert select_solver_strategy("auto", c64, 32, 200, cuda) == "dense"
    assert select_solver_strategy("auto", c64, 40, 10, cpu) == "dense"
    assert select_solver_strategy("auto", c64, 16, 10, cpu) == "dense"
    assert select_solver_strategy("auto", c128, 16, 10, cuda) == "dense"
    assert select_solver_strategy("stream", c128, 16, 10, cpu) == "stream"
    assert select_solver_strategy("sparse", c64, 16, 10, cpu) == "stream"
    assert select_solver_strategy("dense", c64, 16, 10, cuda) == "dense"
    with pytest.warns(DeprecationWarning):
        assert select_solver_strategy("sparse", c128, 16, 10,
                                      cpu) == "dense"
    # more than 32 mics fit neither CUDA kernel, whatever the solver
    for solver in ("auto", "stream", "dense"):
        with pytest.raises(ValueError, match="capacity"):
            select_solver_strategy(solver, c64, 40, 10, cuda)
    with pytest.raises(ValueError, match="capacity"):
        select_solver_strategy("stream", c64, 32, 200, cuda)
    with pytest.raises(ValueError, match="unknown"):
        select_solver_strategy("fast", c64, 16, 10, cpu)


def test_mega_raises_not_implemented():
    """``solver="mega"`` is ported (tests/test_torch_mega.py); what it
    cannot take raises: a band reaching the Nyquist bin on every device,
    float64 and more than 32 mics on CUDA."""
    _, teng = _engines("float32")
    model = get_model("mvdr", teng, load_array_config(_cfg("aira3.yaml")),
                      dict(PARAMS, freq_max=24000.0, solver="mega"),
                      device="cpu")
    with pytest.raises(ValueError, match="Nyquist"):
        model.process(np.zeros((3, 4 * HOP), np.float32), THETA)
    cuda, ib = torch.device("cuda"), np.arange(5, 683)
    with pytest.raises(ValueError, match="float32"):
        select_solver_strategy("mega", torch.complex128, 16, 10, cuda,
                               ib=ib, nfft=2048)
    with pytest.raises(ValueError, match="capacity"):
        select_solver_strategy("mega", torch.complex64, 40, 10, cuda,
                               ib=ib, nfft=2048)
