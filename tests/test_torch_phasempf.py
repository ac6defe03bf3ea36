"""The port's phasempf node and MPF kernels against the JAX package and the
float64 oracle, on the CPU.

Every input is made with numpy from a seed and fed to both packages. On
the CPU ``solver="auto"`` and ``"xla"`` run the batched dual beams and the
march as a loop of ``mpf_update``; ``"fused"`` runs the MPF kernels' plain
version (``kernels/phase_mask.mpf_march``); the JAX package's ``fused``
runs its Pallas kernel in interpret mode. Bars:

* float64 vs ``PhasempfOracle``: 1e-9 (test_parity.py's); vs the JAX
  model: 1e-12 of peak.
* float32 ``fused`` vs the JAX ``fused`` and ``xla`` vs the JAX ``xla``:
  the JAX package's mask contract, ``assert_close_mod_flips``
  (tests/test_phase_mask.py); a flipped bin also enters the march state
  and decays over the following frames.
* the helpers vs the JAX functions, chunked vs offline, checkpoints across
  the packages: 1e-12 (float64).
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
from beamform_tpu.kernels import phase_mask as jpm
from beamform_tpu.models import phasempf as jmpf
from beamform_tpu.oracle import nodes as on
from beamform_tpu.runtime.cli import main as jax_cli
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch import config as tcfg
from beamform_tpu_torch import geometry as tgeom
from beamform_tpu_torch.config import EngineConfig, PhasempfParams
from beamform_tpu_torch.convert import state_from_jax
from beamform_tpu_torch.kernels import phase_mask as tpm
from beamform_tpu_torch.models import phasempf as tmpf
from beamform_tpu_torch.runtime import cli, wav
from beamform_tpu_torch.runtime.streaming import StreamingSession

from conftest import AIRA3, make_scene
from test_phase_mask import PMPF, assert_close_mod_flips
from test_torch_phase import XY16, _float32_error, _operands, _timeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
FS = 48000
THETA = 25.0
# test_parity.py's parameter sets
PARITY = dict(min_phase=30.0, min_mag=0.05, smooth_size=3,
              MCRA_alphaS=0.95, MCRA_alphaD=0.95, MCRA_alphaD2=0.98,
              MCRA_delta=0.001, MCRA_L=15, MPF_alphaS=0.7, MPF_eta=0.3,
              MPF_rev_gamma=0.9, MPF_rev_delta=1.0, out_amp=2.5,
              noise_floor=0.001, out_only_noise=False, out_only_mcra=False)
TIMELINE = dict(min_phase=30.0, min_mag=0.05, smooth_size=3, MCRA_L=10)
SETS = {"parity": PARITY, "timeline": TIMELINE,
        "only_noise": dict(PARITY, out_only_noise=True),
        "only_mcra": dict(PARITY, out_only_mcra=True)}


def _models(xy, dtype, params, solver="auto", **eng):
    """(port model on the CPU, JAX model) with the same parameters."""
    kw = dict(sample_rate=FS, window_size=HOP, dtype=dtype, **eng)
    return (tmpf.PhasempfModel(EngineConfig(**kw),
                               tgeom.ArrayGeometry.from_xy(xy),
                               PhasempfParams(**params, solver=solver),
                               device="cpu"),
            jmpf.PhasempfModel(JEngine(**kw), jgeom.ArrayGeometry.from_xy(xy),
                               jcfg.PhasempfParams(**params, solver=solver)))


def _oracle(xy, x, params, theta):
    th = np.atleast_1d(theta)
    o = on.PhasempfOracle(xy, HOP, FS, float(th[0]), **params)
    outs = []
    for k in range(x.shape[1] // HOP):
        if len(th) > 1 and k and th[k] != th[k - 1]:
            o.set_theta(float(th[k]))
        outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
    return np.concatenate(outs)


# ---------------------------------------------------------- float64 oracle


@pytest.mark.parametrize("xy,name", [(AIRA3, "parity"), (AIRA3, "timeline"),
                                     (AIRA3, "only_noise"),
                                     (AIRA3, "only_mcra"), (XY16, "parity")],
                         ids=["aira3", "aira3-timeline", "aira3-only_noise",
                              "aira3-only_mcra", "aira16"])
def test_phasempf_float64_matches_jax_and_oracle(xy, name):
    x = make_scene(xy, seconds=0.3 if name == "timeline" else 0.4,
                   theta_deg=THETA, hop=HOP)
    t = x.shape[1] // HOP
    theta = _timeline(t, 15.0) if name == "timeline" else THETA
    tm, jm = _models(xy, "float64", SETS[name])
    y = tm.process(x, theta).numpy()
    y_j = np.asarray(jm.process(x, theta))
    ref = _oracle(xy, x, SETS[name], theta)
    assert np.isfinite(y).all() and np.abs(y).max() > 1e-4
    assert np.abs(y - y_j).max() <= 1e-12 * np.abs(y_j).max()
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-9)


def test_phasempf_dc_bin_passes_through_without_the_quirk():
    x = make_scene(AIRA3, seconds=0.3, theta_deg=THETA, hop=HOP, seed=3)
    tm, jm = _models(AIRA3, "float64", PARITY, bug_dc_zero=False)
    y = tm.process(x, THETA).numpy()
    y_j = np.asarray(jm.process(x, THETA))
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-12 * np.abs(y_j).max())
    quirk, _ = _models(AIRA3, "float64", PARITY)
    assert np.abs(quirk.process(x, THETA).numpy() - y).max() > 1e-9


# ------------------------------------------------------------- float32


@pytest.mark.parametrize("dc_zero", [True, False])
@pytest.mark.parametrize("solver", ["fused", "xla"])
@pytest.mark.parametrize("xy", [AIRA3, XY16], ids=["aira3", "aira16"])
def test_phasempf_float32_matches_jax(xy, solver, dc_zero):
    """The port's float32 ``fused`` (the MPF kernels' plain version)
    against the JAX ``fused`` (its kernel in interpret mode), and ``xla``
    against ``xla``, under the mask contract; bug_dc_zero on and off."""
    x = make_scene(xy, seconds=0.25, quiet_hops=8, hop=HOP)
    tm, jm = _models(xy, "float32", PMPF, solver, bug_dc_zero=dc_zero)
    y = tm.process(x, 20.0)
    assert y.dtype == torch.float32
    assert_close_mod_flips(y.numpy(), np.asarray(jm.process(x, 20.0)))


def _rows(st):
    """A port MpfState -> the JAX kernel's (9, NB) rows."""
    return np.stack([v.numpy() for v in st[:7]]
                    + [np.full(st[0].shape, float(st[7])),
                       np.full(st[0].shape, float(st[8]))]).astype(np.float32)


@pytest.mark.parametrize("flags", [{}, {"out_only_noise": True},
                                   {"out_only_mcra": True}])
@pytest.mark.parametrize("m,u", [(3, 1), (16, 2)])
def test_mpf_march_plain_matches_jax_kernel(m, u, flags):
    """The plain version against phase_mask.py's MPF kernel in interpret
    mode on the same numpy operands and a carried state one frame before
    a rollover (MCRA_L = 7): the output under the mask contract, the new
    state's rows within 1e-5 of their peak."""
    t, nb = 23, 2 * HOP + 2
    spec, w, idx = _operands(m, t, nb, u, 11 * m)
    p = PhasempfParams(**dict(PMPF, MCRA_L=7, **flags))
    jp = jcfg.PhasempfParams(**dict(PMPF, MCRA_L=7, **flags))
    tspec, tw, tidx = (torch.as_tensor(a) for a in (spec, w, idx))
    st0 = tpm.init_state(tpm.MpfState, nb, torch.float32)
    st0 = tpm.mpf_march_plain(tspec[:6], tw, tidx[:6], st0, p, True)[1]
    st0 = st0._replace(current_l=torch.tensor(7, dtype=torch.int32))
    for dc_zero in (True, False):
        yr, yi, rows = jpm.phasempf_march_pallas(
            np.ascontiguousarray(spec.real), np.ascontiguousarray(spec.imag),
            np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag), idx,
            _rows(st0), jp, dc_zero, interpret=True)
        y, st = tpm.mpf_march(tspec, tw, tidx, st0, p, dc_zero)
        assert y.dtype == torch.complex64 and y.shape == (t, nb)
        assert_close_mod_flips(y.numpy(), np.asarray(yr) + 1j * np.asarray(yi))
        rows = np.asarray(rows)
        got = _rows(st)
        np.testing.assert_array_equal(got[7:], rows[7:])
        assert got[8, 0] == 0.0                   # first_L false for good
        for r in range(7):
            assert np.abs(got[r] - rows[r]).max() <= 1e-5 * max(
                np.abs(rows[r]).max(), 1e-30)


def test_mpf_march_plain_chunks_equal_one_call_and_the_jax_kernel():
    """The MPF kernels' plain version (the CUDA kernels' oracle) in chunks
    of 8 frames with the state carried equals one call bit for bit; with
    MCRA_L = 7 from a fresh state current_L rolls over at frame 8 and every
    8 frames on, at every chunk boundary. The one call against
    phase_mask.py's MPF kernel in interpret mode on the same numpy
    operands: the output under the mask contract, the state's rows within
    1e-5 of their peak, current_L and first_L exactly."""
    t, nb, m = 24, 2 * HOP + 2, 3
    spec, w, idx = _operands(m, t, nb, 2, 17)
    p = PhasempfParams(**dict(PMPF, MCRA_L=7))
    tspec, tw, tidx = (torch.as_tensor(a) for a in (spec, w, idx))
    st0 = tpm.init_state(tpm.MpfState, nb, torch.float32)
    y, st = tpm.mpf_march_plain(tspec, tw, tidx, st0, p, True)
    ys, stc, ends = [], st0, []
    for a in range(0, t, 8):
        yc, stc = tpm.mpf_march_plain(tspec[a:a + 8], tw, tidx[a:a + 8],
                                      stc, p, True)
        ys.append(yc)
        ends.append((int(stc.current_l), bool(stc.first_l)))
    assert torch.equal(torch.cat(ys), y)
    for name, a, b in zip(st._fields, stc, st):
        assert torch.equal(a, b), name
    assert ends == [(8, True), (8, False), (8, False)]
    yr, yi, rows = jpm.phasempf_march_pallas(
        np.ascontiguousarray(spec.real), np.ascontiguousarray(spec.imag),
        np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag), idx,
        _rows(st0), jcfg.PhasempfParams(**dict(PMPF, MCRA_L=7)), True,
        interpret=True)
    assert_close_mod_flips(y.numpy(), np.asarray(yr) + 1j * np.asarray(yi))
    rows, got = np.asarray(rows), _rows(st)
    np.testing.assert_array_equal(got[7:], rows[7:])
    for r in range(7):
        assert np.abs(got[r] - rows[r]).max() <= 1e-5 * max(
            np.abs(rows[r]).max(), 1e-30)


def test_phasempf_helpers_match_jax():
    rng = np.random.default_rng(5)
    n = 2 * HOP + 2
    sq = rng.uniform(0.0, 2.0, (4, n))
    dc = rng.uniform(0.0, 1.0, 4)
    np.testing.assert_array_equal(
        tmpf.buggy_freq_smooth(torch.as_tensor(sq),
                               torch.as_tensor(dc)).numpy(),
        np.asarray(jmpf.buggy_freq_smooth(sq, dc)))
    y = rng.standard_normal(300)
    tail = rng.standard_normal(4)
    for size in (1, 3, 5):
        np.testing.assert_allclose(
            tmpf.moving_average_causal(torch.as_tensor(y), size).numpy(),
            np.asarray(jmpf.moving_average_causal(y, size)), rtol=0,
            atol=1e-15)
        got, gt = tmpf.moving_average_causal_carry(
            torch.as_tensor(y), size, torch.as_tensor(tail[:size - 1]))
        ref, rt = jmpf.moving_average_causal_carry(y, size, tail[:size - 1])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-15)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    spec, w, idx = _operands(16, 9, n, 2, 1)
    spec, w = spec.astype(np.complex128), w.astype(np.complex128)
    ia, ib = tmpf.pair_indices(16)
    got = tmpf.dual_beam(torch.as_tensor(spec), torch.as_tensor(w[idx]),
                         0.5, 0.05, ia, ib)
    ref = jmpf.dual_beam(spec, w[idx], 0.5, 0.05, ia.numpy(), ib.numpy())
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_phasempf_strategy():
    geom = tgeom.ArrayGeometry.from_xy(AIRA3)

    def model(dtype="float32", cls=tmpf.PhasempfModel, **kw):
        return cls(EngineConfig(window_size=HOP, dtype=dtype), geom,
                   PhasempfParams(**kw), device="cpu")

    assert model()._strategy() == "xla"
    assert model(solver="fused")._strategy() == "fused"
    with pytest.raises(ValueError, match="float32"):
        model("float64", solver="fused")._strategy()
    with pytest.raises(ValueError, match="unknown"):
        model(solver="mega")

    class OnCuda(tmpf.PhasempfModel):
        device = torch.device("cuda")

    assert model(cls=OnCuda)._strategy() == "fused"
    assert model("float64", cls=OnCuda)._strategy() == "xla"
    assert model(cls=OnCuda, solver="xla")._strategy() == "xla"


def test_phasempf_params_match():
    for kw in ({}, tcfg.load_launch_params("phasempf"), {"solver": "xla"}):
        assert (dataclasses.asdict(tcfg.make_params("phasempf", kw))
                == dataclasses.asdict(jcfg.make_params("phasempf", kw)))


# ------------------------------------------------------------- streaming


@pytest.mark.parametrize("dtype,solver", [("float64", "auto"),
                                          ("float32", "fused")])
def test_phasempf_chunked_equals_offline(dtype, solver):
    """The WOLA carries, the MCRA/MPF state (through the kernels' rows on
    the fused path) and the smoother tail carry across chunks."""
    x = make_scene(AIRA3, seconds=0.3, theta_deg=THETA, hop=HOP)
    t = x.shape[1] // HOP
    th = _timeline(t)
    tm, _ = _models(AIRA3, dtype, dict(PARITY, MCRA_L=7), solver)
    offline = tm.process(x, th).numpy()
    sess = StreamingSession(tm)
    outs = [sess.process(x[:, f0 * HOP:(f0 + 4) * HOP], th[f0:f0 + 4])
            .numpy() for f0 in range(0, t, 4)]
    tol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(np.concatenate(outs), offline, rtol=0,
                               atol=tol * np.abs(offline).max())


@pytest.mark.parametrize("direction,dtype", [("jax_to_port", "float64"),
                                             ("port_to_jax", "float64"),
                                             ("port_to_jax", "float32")])
def test_phasempf_checkpoints_move_between_packages(direction, dtype,
                                                    tmp_path):
    """The state (WolaCarry, MpfState, smoother tail) saves as leaf_0 ..
    leaf_11 in jax.tree.flatten order, current_L int32 and first_L bool; a
    session stopped after a rollover resumes in the other package (float32:
    the port's fused path to the JAX fused path, under the mask
    contract)."""
    x = make_scene(AIRA3, seconds=0.4, theta_deg=THETA, hop=HOP)
    t = x.shape[1] // HOP
    half = t // 2
    solver = "fused" if dtype == "float32" else "auto"
    params = dict(PARITY, MCRA_L=7)
    tm, jm = _models(AIRA3, dtype, params, solver)
    full = np.asarray(jm.process(x, THETA))
    first, second = ((JSession(jm), StreamingSession(tm))
                     if direction == "jax_to_port"
                     else (StreamingSession(tm), JSession(jm)))
    y1 = np.asarray(first.process(x[:, :half * HOP], THETA))
    ckpt = str(tmp_path / "state.npz")
    first.save(ckpt)
    with np.load(ckpt) as data:
        assert data["leaf_9"].dtype == np.int32 and data["leaf_9"].ndim == 0
        assert data["leaf_10"].dtype == np.bool_ and not data["leaf_10"]
        assert data["leaf_11"].shape == (2,)
    second.load(ckpt)
    y2 = np.asarray(second.process(x[:, half * HOP:]))
    if dtype == "float32":
        assert_close_mod_flips(np.concatenate([y1, y2]), full)
        return
    np.testing.assert_allclose(np.concatenate([y1, y2]), full, rtol=0,
                               atol=1e-12)
    if direction == "jax_to_port":
        state = state_from_jax([np.asarray(a) for a in
                                jax.tree.leaves(first.state)],
                               like=tm.stream_init())
        assert state[1].current_l.dtype == torch.int32
        out, _ = tm.process_chunk(x[:, half * HOP:], THETA, state)
        np.testing.assert_allclose(out.numpy(), y2, rtol=0, atol=1e-12)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("extra", [[], ["--stream", "8"],
                                   ["--theta-timeline", "0.1:-30",
                                    "--launch-preset", "off", "--param",
                                    "smooth_size=4"]])
def test_cli_phasempf_matches_jax_cli(extra, tmp_path):
    x = make_scene(AIRA3, seconds=0.3, theta_deg=THETA, hop=HOP, seed=4)
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    cfg = os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira3.yaml")
    args = ["phasempf", "--in", src, "--array-config", cfg, "--window-size",
            str(HOP), "--theta", str(THETA), "--dtype", "float64",
            "--out-format", "float32", *extra]
    assert jax_cli(args + ["--out", str(tmp_path / "j.wav")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "t.wav"), "--device",
                            "cpu"]) == 0
    ref, _ = wav.read_wav(str(tmp_path / "j.wav"))
    got, fs = wav.read_wav(str(tmp_path / "t.wav"))
    assert fs == FS and got.shape == ref.shape and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_cli_state_moves_between_the_clis(tmp_path):
    """``--save-state`` of one CLI resumes under ``--load-state`` of the
    other: the port's CLI saves after one file, the JAX CLI and the port's
    CLI both resume from it on the next file and agree."""
    cfg = os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira3.yaml")
    paths = []
    for seed in (1, 2):
        x = make_scene(AIRA3, seconds=0.2, theta_deg=THETA, hop=HOP,
                       seed=seed)
        paths.append(str(tmp_path / f"in{seed}.wav"))
        wav.write_wav(paths[-1], x, FS, fmt="float32")
    common = ["phasempf", "--array-config", cfg, "--window-size", str(HOP),
              "--theta", str(THETA), "--dtype", "float64", "--out-format",
              "float32", "--stream", "4"]
    ckpt = str(tmp_path / "state.npz")
    assert cli.main(common + ["--in", paths[0], "--out", str(tmp_path /
                              "a.wav"), "--save-state", ckpt, "--device",
                              "cpu"]) == 0
    assert jax_cli(common + ["--in", paths[1], "--out", str(tmp_path /
                             "j.wav"), "--load-state", ckpt]) == 0
    assert cli.main(common + ["--in", paths[1], "--out", str(tmp_path /
                              "t.wav"), "--load-state", ckpt, "--device",
                              "cpu"]) == 0
    ref, _ = wav.read_wav(str(tmp_path / "j.wav"))
    got, _ = wav.read_wav(str(tmp_path / "t.wav"))
    fresh = str(tmp_path / "f.wav")
    assert cli.main(common + ["--in", paths[1], "--out", fresh, "--device",
                              "cpu"]) == 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.abs(wav.read_wav(fresh)[0] - got).max() > 1e-6


# ------------------------------------------------- float32 drift, aira16


def test_phasempf_float32_error_is_the_jax_packages():
    """See test_torch_phase.py's test of the same name."""
    _float32_error("phasempf")
