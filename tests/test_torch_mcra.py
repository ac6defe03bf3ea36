"""The port's MCRA node and MCRA march against the JAX package and the
float64 oracle, on the CPU.

Every input is made with numpy from a seed and fed to both packages. On
the CPU the node runs the MCRA march's plain version
(``kernels/phase_mask.mcra_march``) around the WOLA path, in float32 or
float64; the JAX package's node is a ``lax.scan``. Bars:

* float64 vs ``McraOracle``: 1e-9 (test_parity.py's); vs the JAX model:
  1e-12 of peak.
* float32 vs the JAX model: the JAX package's mask contract,
  ``assert_close_mod_flips`` (tests/test_phase_mask.py): the noise
  update's gates are thresholds too.
* the helpers (``freq_smooth``, ``mcra_update``) vs the JAX functions,
  chunked vs offline, checkpoints across the packages: 1e-12 (float64).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from beamform_tpu import config as jcfg
from beamform_tpu import geometry as jgeom
from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.models import mcra as jmcra
from beamform_tpu.oracle import nodes as on
from beamform_tpu.oracle.engine import run_oracle
from beamform_tpu.runtime.cli import main as jax_cli
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch import config as tcfg
from beamform_tpu_torch import geometry as tgeom
from beamform_tpu_torch.config import EngineConfig, McraParams
from beamform_tpu_torch.convert import state_from_jax
from beamform_tpu_torch.kernels import phase_mask as tpm
from beamform_tpu_torch.models import mcra as tmcra
from beamform_tpu_torch.runtime import cli, wav
from beamform_tpu_torch.runtime.streaming import StreamingSession

from conftest import AIRA3, make_scene
from test_phase_mask import assert_close_mod_flips
from test_torch_phase import XY16, _float32_error

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
FS = 48000
# test_parity.py's two parameter sets
PARITY = dict(alphaS=0.95, alphaD=0.95, alphaD2=0.98, delta=0.001, L=20,
              out_amp=3.5, out_only_noise=False)
ONLY_NOISE = dict(L=10, out_only_noise=True)


def _models(xy, dtype, params, **eng):
    """(port model on the CPU, JAX model) with the same parameters."""
    kw = dict(sample_rate=FS, window_size=HOP, dtype=dtype, **eng)
    return (tmcra.McraModel(EngineConfig(**kw),
                            tgeom.ArrayGeometry.from_xy(xy),
                            McraParams(**params), device="cpu"),
            jmcra.McraModel(JEngine(**kw), jgeom.ArrayGeometry.from_xy(xy),
                            jcfg.McraParams(**params)))


@pytest.mark.parametrize("params,seconds", [(PARITY, 0.4), (ONLY_NOISE, 0.25)],
                         ids=["parity", "only_noise"])
@pytest.mark.parametrize("xy", [AIRA3, XY16], ids=["aira3", "aira16"])
def test_mcra_float64_matches_jax_and_oracle(xy, params, seconds):
    x = make_scene(xy, seconds=seconds, hop=HOP)
    tm, jm = _models(xy, "float64", params)
    y = tm.process(x).numpy()
    y_j = np.asarray(jm.process(x))
    ref = run_oracle(on.McraOracle(xy, HOP, FS, **params), x, HOP)
    assert np.isfinite(y).all() and np.abs(y).max() > 1e-3
    assert np.abs(y - y_j).max() <= 1e-12 * np.abs(y_j).max()
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-9)


def test_mcra_dc_bin_passes_through_without_the_quirk():
    """``bug_dc_zero=False`` passes X0[0] to the DC bin, as in the JAX
    package; the theta argument is ignored."""
    x = make_scene(AIRA3, seconds=0.3, hop=HOP, seed=3)
    tm, jm = _models(AIRA3, "float64", PARITY, bug_dc_zero=False)
    y = tm.process(x, 40.0).numpy()
    y_j = np.asarray(jm.process(x))
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-12 * np.abs(y_j).max())
    quirk, _ = _models(AIRA3, "float64", PARITY)
    assert np.abs(quirk.process(x).numpy() - y).max() > 1e-9


@pytest.mark.parametrize("params", [PARITY, ONLY_NOISE],
                         ids=["parity", "only_noise"])
def test_mcra_float32_matches_jax(params):
    x = make_scene(AIRA3, seconds=0.4, hop=HOP, quiet_hops=4)
    tm, jm = _models(AIRA3, "float32", params)
    y = tm.process(x)
    assert y.dtype == torch.float32
    assert_close_mod_flips(y.numpy(), np.asarray(jm.process(x)))


def test_freq_smooth_and_mcra_update_match_jax():
    """The 3-tap smoothing (bin 0 the amplitude, the shadow bin the mirror
    value) and one recurrence step, from a state one frame before a
    rollover with first_L set: every field, current_L and first_L
    included."""
    rng = np.random.default_rng(2)
    n = 2 * HOP + 2
    sq = rng.uniform(0.0, 2.0, (3, n))
    dc = rng.uniform(0.0, 1.0, 3)
    np.testing.assert_allclose(
        tmcra.freq_smooth(torch.as_tensor(sq), torch.as_tensor(dc)).numpy(),
        np.asarray(jmcra.freq_smooth(sq, dc)), rtol=0, atol=1e-15)
    p = McraParams(L=5)
    vecs = [rng.uniform(0.0, 1.0, n) for _ in range(4)]
    for cur, first in ((5, True), (6, True), (3, False)):
        st_t = tmcra.McraState(*(torch.as_tensor(v) for v in vecs),
                               torch.tensor(cur, dtype=torch.int32),
                               torch.tensor(first))
        st_j = jmcra.McraState(*vecs, np.int32(cur), np.bool_(first))
        got, lam = tmcra.mcra_update(st_t, torch.as_tensor(sq[0]),
                                     torch.as_tensor(sq[1]), p)
        ref, lam_j = jmcra.mcra_update(st_j, sq[0], sq[1],
                                       jcfg.McraParams(L=5))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-15)
        assert got.current_l.dtype == torch.int32
        assert got.first_l.dtype == torch.bool
        np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j), atol=1e-15)


def test_mcra_rollover_and_first_l():
    """current_L counts to L + 1, rolls over to 1 and starts again;
    first_L goes false at the first rollover and stays false."""
    x = torch.as_tensor(make_scene(AIRA3, seconds=0.2, hop=HOP))
    model = tmcra.McraModel(EngineConfig(window_size=HOP, dtype="float64"),
                            tgeom.ArrayGeometry.from_xy(AIRA3),
                            McraParams(L=4), device="cpu")
    state = model.stream_init()
    seen = []
    for k in range(12):
        _, state = model.process_chunk(x[:, k * HOP:(k + 1) * HOP], 0.0,
                                       state)
        seen.append((int(state[1].current_l), bool(state[1].first_l)))
    assert seen[:7] == [(1, True), (2, True), (3, True), (4, True),
                        (5, True), (1, False), (2, False)]
    assert all(not first for _, first in seen[5:])


def test_mcra_params_match():
    for kw in ({}, tcfg.load_launch_params("mcra"), {"L": 3}):
        assert (dataclasses.asdict(tcfg.make_params("mcra", kw))
                == dataclasses.asdict(jcfg.make_params("mcra", kw)))


def test_mcra_chunked_equals_offline():
    x = make_scene(XY16, seconds=0.3, hop=HOP)
    tm, _ = _models(XY16, "float64", PARITY)
    offline = tm.process(x).numpy()
    sess = StreamingSession(tm)
    t = x.shape[1] // HOP
    outs = [sess.process(x[:, f0 * HOP:(f0 + 4) * HOP]).numpy()
            for f0 in range(0, t, 4)]
    np.testing.assert_allclose(np.concatenate(outs), offline, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mcra_checkpoints_move_between_packages(direction, tmp_path):
    """The state (WolaCarry of 1 mic, McraState) saves as leaf_0..leaf_7
    in jax.tree.flatten order; current_L stays int32 and first_L bool in
    the file; a session resumes in the other package after a rollover."""
    x = make_scene(AIRA3, seconds=0.4, hop=HOP)
    t = x.shape[1] // HOP
    half = t // 2
    params = dict(PARITY, L=7)
    tm, jm = _models(AIRA3, "float64", params)
    full = np.asarray(jm.process(x))
    first, second = ((JSession(jm), StreamingSession(tm))
                     if direction == "jax_to_port"
                     else (StreamingSession(tm), JSession(jm)))
    y1 = np.asarray(first.process(x[:, :half * HOP]))
    ckpt = str(tmp_path / "state.npz")
    first.save(ckpt)
    with np.load(ckpt) as data:
        assert data["leaf_6"].dtype == np.int32 and data["leaf_6"].ndim == 0
        assert data["leaf_7"].dtype == np.bool_ and not data["leaf_7"]
        assert data["leaf_2"].shape == (HOP + 2,)
    second.load(ckpt)
    y2 = np.asarray(second.process(x[:, half * HOP:]))
    np.testing.assert_allclose(np.concatenate([y1, y2]), full, rtol=0,
                               atol=1e-12)
    if direction == "jax_to_port":
        state = state_from_jax([np.asarray(a) for a in
                                jax.tree.leaves(first.state)],
                               like=tm.stream_init())
        assert state[1].current_l.dtype == torch.int32
        assert state[1].first_l.dtype == torch.bool
        out, _ = tm.process_chunk(x[:, half * HOP:], 0.0, state)
        np.testing.assert_allclose(out.numpy(), y2, rtol=0, atol=1e-12)


def _march_operands(t, nb, dtype, seed=6):
    """Mic 0's spectrum (T, NB) under a syllabic envelope, its power and
    its 3-tap smoothing: the MCRA march's operands."""
    rng = np.random.default_rng(seed)
    env = np.abs(np.sin(np.arange(t) / 5.0))[:, None] + 0.05
    x = env * (rng.standard_normal((t, nb)) + 1j * rng.standard_normal((t, nb)))
    x = torch.as_tensor(x.astype(np.complex128 if dtype == torch.float64
                                 else np.complex64))
    sq = x.abs() ** 2
    return tmcra.freq_smooth(sq, x[:, 0].abs()), sq, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mcra_march_plain_chunks_equal_one_call(dtype):
    """The march's plain version (the CUDA kernel's oracle) in chunks of 8
    frames with the state carried equals one call bit for bit. With L = 7
    from a fresh state current_L rolls over at frame 8 and every 8 frames
    on: at every chunk boundary."""
    t, nb = 40, 2 * HOP + 2
    s_f, sq, x = _march_operands(t, nb, dtype)
    p = McraParams(**dict(PARITY, L=7))
    st0 = tmcra.mcra_init_state(nb, dtype)
    y, st = tpm.mcra_march_plain(s_f, sq, x, st0, p, True)
    ys, stc, ends = [], st0, []
    for a in range(0, t, 8):
        yc, stc = tpm.mcra_march_plain(s_f[a:a + 8], sq[a:a + 8],
                                       x[a:a + 8], stc, p, True)
        ys.append(yc)
        ends.append((int(stc.current_l), bool(stc.first_l)))
    assert torch.equal(torch.cat(ys), y)
    for name, a, b in zip(st._fields, stc, st):
        assert torch.equal(a, b), name
    # the counter ends each chunk at 8 > L: the next frame rolls it over
    assert ends == [(8, True)] + [(8, False)] * (t // 8 - 1)


def _jax_mcra_scan(s_f, sq, x, state, p, dc_zero):
    """The JAX MCRA model's scan (beamform_tpu/models/mcra.py
    McraModel._forward's step) on given operands."""
    from beamform_tpu.models import common as jcommon

    def step(st, inp):
        s_f_t, sq_t, x_t = inp
        st, lam = jmcra.mcra_update(st, s_f_t, sq_t, p)
        mag_x, pha = jcommon.polar_mag_phase(x_t)
        if p.out_only_noise:
            mag = jax.numpy.sqrt(lam) * p.out_amp
        else:
            mag = jax.numpy.maximum(mag_x - jax.numpy.sqrt(lam), 0.0) * p.out_amp
        y = jcommon.from_mag_phase(mag, pha)
        return st, y.at[0].set(0.0 if dc_zero else x_t[0])

    return jax.lax.scan(step, state, (s_f, sq, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("params", [PARITY, ONLY_NOISE],
                         ids=["parity", "only_noise"])
def test_mcra_march_plain_matches_jax_scan(params, dtype):
    """The march's plain version against the JAX model's scan on the same
    numpy operands, across roll-overs (L = 7) and with
    bug_dc_zero on and off: float64 within 1e-12 of peak, float32 under
    the mask contract; the state too, current_L and first_L exactly."""
    t, nb = 30, 2 * HOP + 2
    s_f, sq, x = _march_operands(t, nb, dtype)
    params = dict(params, L=7)
    p, jp = McraParams(**params), jcfg.McraParams(**params)
    for dc_zero in (True, False):
        y, st = tpm.mcra_march_plain(s_f, sq, x, tmcra.mcra_init_state(
            nb, dtype), p, dc_zero)
        st_j, y_j = _jax_mcra_scan(s_f.numpy(), sq.numpy(), x.numpy(),
                                   jmcra.mcra_init_state(nb, s_f.numpy()
                                                         .dtype), jp, dc_zero)
        y_j = np.asarray(y_j)
        if dtype == torch.float64:
            assert np.abs(y.numpy() - y_j).max() <= 1e-12 * np.abs(y_j).max()
        else:
            assert_close_mod_flips(y.numpy(), y_j)
        assert int(st.current_l) == int(st_j.current_l)
        assert bool(st.first_l) == bool(st_j.first_l) is False
        for a, b in zip(st[:4], st_j[:4]):
            b = np.asarray(b)
            if dtype == torch.float64:
                assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
            else:
                assert_close_mod_flips(a.numpy(), b)


def test_mcra_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((6, 10))
                        + 1j * rng.standard_normal((6, 10)))
    sq = x.abs() ** 2
    st = tmcra.mcra_init_state(10, torch.float64)
    before = tpm.mcra_march.launches
    a = tpm.mcra_march(sq, sq, x, st, McraParams(), True)
    b = tpm.mcra_march_plain(sq, sq, x, st, McraParams(), True)
    assert tpm.mcra_march.launches == before
    assert torch.equal(a[0], b[0]) and a[0].dtype == torch.complex128


@pytest.mark.parametrize("stream", [[], ["--stream", "8"]])
def test_cli_mcra_matches_jax_cli(stream, tmp_path):
    """Both CLIs with the mcra launch preset, float64; --theta is taken
    and ignored."""
    x = make_scene(AIRA3, seconds=0.3, hop=HOP, seed=4)
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    cfg = os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira3.yaml")
    args = ["mcra", "--in", src, "--array-config", cfg, "--window-size",
            str(HOP), "--theta", "40", "--dtype", "float64", "--out-format",
            "float32", *stream]
    assert jax_cli(args + ["--out", str(tmp_path / "j.wav")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "t.wav"), "--device",
                            "cpu"]) == 0
    ref, _ = wav.read_wav(str(tmp_path / "j.wav"))
    got, fs = wav.read_wav(str(tmp_path / "t.wav"))
    assert fs == FS and got.shape == ref.shape and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_mcra_float32_error_is_the_jax_packages():
    """See test_torch_phase.py's test of the same name."""
    _float32_error("mcra")
