"""The port's ``ref`` and ``read`` nodes against the JAX package and the
float64 oracle, on the CPU.

Every input is made with numpy from a seed and fed to both packages.
Neither node has a kernel: both are plain torch on the model's device.
Bars:

* float64 vs ``RefOracle`` / ``ReadOracle``: 1e-12, as
  tests/test_parity.py holds the JAX models; vs the JAX models: 1e-12.
* float32 vs the JAX models: ``ref`` 1e-6 (the same framing and window in
  another order of products); ``read`` exactly (its picks agree on these
  inputs, whose mic energies are far from ties, and the output is the
  picked mic's input).
* chunked vs offline, checkpoints across the packages: exact.
"""

import os

import jax
import numpy as np
import pytest
import torch

from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.geometry import ArrayGeometry as JGeom
from beamform_tpu.models import refmic as jrm
from beamform_tpu.oracle import nodes as on
from beamform_tpu.runtime.cli import main as jax_cli
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch.config import EngineConfig
from beamform_tpu_torch.convert import state_from_jax
from beamform_tpu_torch.geometry import ArrayGeometry
from beamform_tpu_torch.models import refmic as trm
from beamform_tpu_torch.runtime import cli, wav
from beamform_tpu_torch.runtime.streaming import StreamingSession

from conftest import AIRA3, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
FS = 48000
NODES = {"ref": (trm.RefModel, jrm.RefModel, lambda: on.RefOracle(HOP)),
         "read": (trm.ReadModel, jrm.ReadModel, on.ReadOracle)}


def _models(node, dtype="float64"):
    """(port model on the CPU, JAX model)."""
    tcls, jcls, _ = NODES[node]
    kw = dict(sample_rate=FS, window_size=HOP, dtype=dtype)
    return (tcls(EngineConfig(**kw), ArrayGeometry.from_xy(AIRA3),
                 device="cpu"),
            jcls(JEngine(**kw), JGeom.from_xy(AIRA3)))


def _oracle(node, x):
    o = NODES[node][2]()
    return np.concatenate([o.callback(x[:, k * HOP:(k + 1) * HOP])
                           for k in range(x.shape[1] // HOP)])


def _scene(seconds=0.2, seed=0):
    """The conftest scene with each mic's level varied window by window,
    so read's pick moves."""
    x = make_scene(AIRA3, fs=FS, hop=HOP, seconds=seconds, theta_deg=25.0,
                   seed=seed)
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.2, 1.0, (x.shape[0], x.shape[1] // HOP))
    return x * np.repeat(gain, HOP, axis=1)


@pytest.mark.parametrize("node", ["ref", "read"])
def test_float64_matches_oracle_and_jax(node):
    x = _scene()
    tm, jm = _models(node)
    y = tm.process(x).numpy()
    assert np.abs(y).max() > 1e-2
    np.testing.assert_allclose(y, _oracle(node, x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(y, np.asarray(jm.process(x)), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("node,tol", [("ref", 1e-6), ("read", 0.0)])
def test_float32_matches_jax(node, tol):
    x = _scene(seed=1).astype(np.float32)
    tm, jm = _models(node, "float32")
    y = tm.process(x)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jm.process(x)), rtol=0,
                               atol=tol)


def test_read_zero_windows_and_ties():
    """jack_read.cpp:20-37: an all-zero first window passes mic 0; an
    all-zero window later keeps the previous pick; of two mics with equal
    energy the first wins; in both packages and the oracle."""
    rng = np.random.default_rng(3)
    x = 0.1 * rng.standard_normal((3, 6 * HOP))
    x[:, :HOP] = 0.0                                   # window 0: silent
    x[:, 3 * HOP:4 * HOP] = 0.0                        # window 3: silent
    x[2, 2 * HOP:3 * HOP] *= 5.0                       # window 2: mic 2
    x[1, 4 * HOP:5 * HOP] = -x[2, 4 * HOP:5 * HOP] * 3  # window 4: a tie
    x[2, 4 * HOP:5 * HOP] *= -3
    tm, jm = _models("read")
    y = tm.process(x).numpy()
    np.testing.assert_array_equal(y, _oracle("read", x))
    np.testing.assert_array_equal(y, np.asarray(jm.process(x)))
    picks = [int(np.nonzero((x[:, k * HOP:(k + 1) * HOP]
                             == y[k * HOP:(k + 1) * HOP]).all(-1))[0][0])
             for k in range(6)]
    assert picks[0] == 0 and picks[2] == 2 and picks[4] == 1
    # the silent window 3 keeps mic 2: the state after it
    _, past = tm.process_chunk(x[:, :4 * HOP], 0.0, tm.stream_init())
    assert int(past) == 2
    out, past = tm.process_chunk(x[:, 3 * HOP:4 * HOP], 0.0,
                                 torch.tensor(-1, dtype=torch.int32))
    assert int(past) == 0 and past.dtype == torch.int32
    assert np.array_equal(out.numpy(), x[0, 3 * HOP:4 * HOP])


@pytest.mark.parametrize("node", ["ref", "read"])
def test_chunked_equals_offline(node):
    x = _scene(seconds=0.3, seed=2)
    tm, _ = _models(node)
    offline = tm.process(x).numpy()
    sess = StreamingSession(tm)
    t = x.shape[1] // HOP
    outs = [sess.process(x[:, f0 * HOP:(f0 + 4) * HOP]).numpy()
            for f0 in range(0, t, 4)]
    np.testing.assert_array_equal(np.concatenate(outs), offline)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("node", ["ref", "read"])
def test_checkpoints_move_between_packages(node, direction, tmp_path):
    """ref's WolaCarry (tail, out_prev) saves as leaf_0..1, read's last
    pick as one int32 0-d leaf; a session resumes in the other package."""
    x = _scene(seconds=0.3, seed=4)
    half = (x.shape[1] // HOP // 2) * HOP
    tm, jm = _models(node)
    full = np.asarray(jm.process(x))
    first, second = ((JSession(jm), StreamingSession(tm))
                     if direction == "jax_to_port"
                     else (StreamingSession(tm), JSession(jm)))
    y1 = np.asarray(first.process(x[:, :half]))
    ckpt = str(tmp_path / "state.npz")
    first.save(ckpt)
    with np.load(ckpt) as data:
        if node == "read":
            assert data["leaf_0"].dtype == np.int32
            assert data["leaf_0"].ndim == 0 and int(data["leaf_0"]) >= 0
            assert "leaf_1" not in data
        else:
            assert data["leaf_0"].shape == data["leaf_1"].shape == (HOP,)
    second.load(ckpt)
    y2 = np.asarray(second.process(x[:, half:]))
    np.testing.assert_allclose(np.concatenate([y1, y2]), full, rtol=0,
                               atol=1e-12)
    if direction == "jax_to_port":
        state = state_from_jax([np.asarray(a) for a in
                                jax.tree.leaves(first.state)],
                               like=tm.stream_init())
        out, _ = tm.process_chunk(x[:, half:], 0.0, state)
        np.testing.assert_allclose(out.numpy(), y2, rtol=0, atol=1e-12)


@pytest.mark.parametrize("node", ["ref", "read"])
@pytest.mark.parametrize("stream", [[], ["--stream", "4"]],
                         ids=["offline", "stream"])
def test_cli_matches_jax_cli(node, stream, tmp_path):
    """Both CLIs, float64; --theta is taken and ignored."""
    x = _scene(seconds=0.2, seed=5)
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    cfg = os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira3.yaml")
    args = [node, "--in", src, "--array-config", cfg, "--window-size",
            str(HOP), "--theta", "40", "--dtype", "float64", "--out-format",
            "float32", *stream]
    assert jax_cli(args + ["--out", str(tmp_path / "j.wav")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "t.wav"), "--device",
                            "cpu"]) == 0
    ref, _ = wav.read_wav(str(tmp_path / "j.wav"))
    got, fs = wav.read_wav(str(tmp_path / "t.wav"))
    assert fs == FS and got.shape == ref.shape and np.abs(ref).max() > 1e-3
    np.testing.assert_array_equal(got, ref)
