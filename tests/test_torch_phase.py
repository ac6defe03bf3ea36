"""The port's phase node and phase-mask kernel against the JAX package and
the float64 oracle, on the CPU.

Every input is made with numpy from a seed and fed to both packages. On
the CPU ``solver="auto"`` and ``"xla"`` run the batched formulation
(``models/phase.phase_mask_spectral``) and ``"fused"`` the phase-mask
kernel's plain version (``kernels/phase_mask.phase_mask``); the JAX
package's ``fused`` runs its Pallas kernel in interpret mode. Bars:

* float64 vs ``PhaseOracle``: 1e-9 (test_parity.py's); vs the JAX model:
  1e-12 of peak.
* float32 ``fused`` vs the JAX ``fused`` and ``xla`` vs the JAX ``xla``:
  the JAX package's mask contract, ``assert_close_mod_flips``
  (tests/test_phase_mask.py: tight but for rare threshold flips).
* chunked vs offline, checkpoints across the packages: 1e-12 (float64).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from beamform_tpu import config as jcfg
from beamform_tpu import geometry as jgeom
from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.kernels import phase_mask as jpm
from beamform_tpu.models import phase as jphase
from beamform_tpu.oracle import nodes as on
from beamform_tpu.runtime.cli import main as jax_cli
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch import config as tcfg
from beamform_tpu_torch import geometry as tgeom
from beamform_tpu_torch import run_offline
from beamform_tpu_torch.config import EngineConfig, PhaseParams
from beamform_tpu_torch.convert import state_from_jax
from beamform_tpu_torch.kernels import phase_mask as tpm
from beamform_tpu_torch.models import phase as tphase
from beamform_tpu_torch.runtime import cli, wav
from beamform_tpu_torch.runtime.streaming import StreamingSession

from conftest import AIRA3, make_scene
from test_phase_mask import assert_close_mod_flips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
FS = 48000
THETA = 25.0
PARITY = dict(min_phase=10.0, mag_mult=0.1, mag_threshold=0.05)
# a gate that passes in the scene's loud bins, so both mask branches run
OPEN = dict(min_phase=30.0, mag_mult=0.1, mag_threshold=0.0002)
XY16 = [(m.x, m.y) for m in tcfg.load_array_config(os.path.join(
    ROOT, "beamform_tpu_torch", "configs", "aira16.yaml")).mics]


def _engine(dtype, **kw):
    return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype, **kw)


def _jengine(dtype, **kw):
    return JEngine(sample_rate=FS, window_size=HOP, dtype=dtype, **kw)


def _models(xy, dtype, params, solver="auto"):
    """(port model on the CPU, JAX model) with the same parameters."""
    return (tphase.PhaseModel(_engine(dtype), tgeom.ArrayGeometry.from_xy(xy),
                              PhaseParams(**params, solver=solver),
                              device="cpu"),
            jphase.PhaseModel(_jengine(dtype), jgeom.ArrayGeometry.from_xy(xy),
                              jcfg.PhaseParams(**params, solver=solver)))


def _timeline(t, a=15.0, b=-35.0):
    th = np.full(t, a)
    th[t // 2:] = b
    return th


def _oracle(xy, x, params, theta):
    """PhaseOracle over ``x`` with a scalar theta or a timeline (one
    /theta message at the change)."""
    th = np.atleast_1d(theta)
    o = on.PhaseOracle(xy, HOP, FS, float(th[0]), **params)
    outs = []
    for k in range(x.shape[1] // HOP):
        if len(th) > 1 and k and th[k] != th[k - 1]:
            o.set_theta(float(th[k]))
        outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
    return np.concatenate(outs)


# ---------------------------------------------------------- float64 oracle


@pytest.mark.parametrize("params", [PARITY, OPEN], ids=["parity", "open"])
@pytest.mark.parametrize("xy,steer", [(AIRA3, "static"),
                                      (AIRA3, "timeline"),
                                      (XY16, "static")],
                         ids=["aira3", "aira3-timeline", "aira16"])
def test_phase_float64_matches_jax_and_oracle(xy, steer, params):
    x = make_scene(xy, seconds=0.2, theta_deg=THETA, hop=HOP)
    t = x.shape[1] // HOP
    theta = THETA if steer == "static" else _timeline(t)
    tm, jm = _models(xy, "float64", params)
    y = tm.process(x, theta).numpy()
    y_j = np.asarray(jm.process(x, theta))
    ref = _oracle(xy, x, params, theta)
    assert np.isfinite(y).all() and np.abs(y).max() > 1e-3
    assert np.abs(y - y_j).max() <= 1e-12 * np.abs(y_j).max()
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-9)


def test_phase_open_gate_keeps_bins():
    """The ``open`` parameters keep some bins and attenuate others, so the
    parity above covers both branches of the mask."""
    x = make_scene(AIRA3, seconds=0.2, theta_deg=THETA, hop=HOP)
    tm, _ = _models(AIRA3, "float64", OPEN)
    xs = torch.as_tensor(x)
    from beamform_tpu_torch.models import common
    spec = common.stft_streams_carry(
        xs[None], tm.engine, tm.window, tm.cdtype,
        torch.zeros((1, 3, HOP), dtype=xs.dtype))[0][:, 0]
    w = common.weights_for_thetas(tm.geom, tm.freqs,
                                  torch.tensor([THETA], dtype=xs.dtype),
                                  tm.rdtype, tm.cdtype)
    diff, mag, _ = tpm._front_end(spec, w, torch.zeros(len(spec),
                                                       dtype=torch.int64))
    keep = ((mag / (2 * HOP) > OPEN["mag_threshold"])
            & (diff < OPEN["min_phase"] * np.pi / 180))[:, 1:]
    assert 0.01 < float(keep.double().mean()) < 0.99


# ----------------------------------------------------------------- kernel


def _operands(m, t, nb, u, seed):
    """Spectra of a source steered by one of ``u`` rows under a noise level
    that rises over the bins, so the bins' pair distances spread across the
    threshold; the steering rows and each frame's row."""
    rng = np.random.default_rng(seed)
    geom = tgeom.ArrayGeometry.from_xy(rng.uniform(-0.1, 0.1, (m, 2)))
    freqs = torch.linspace(0.0, FS / 2, nb, dtype=torch.float64)
    w = tgeom.steering_weights(freqs, tgeom.steering_delays(
        geom, np.linspace(20, -40, u))).numpy()
    idx = np.sort(rng.integers(0, u, t))
    s = rng.standard_normal((t, 1, nb)) + 1j * rng.standard_normal((t, 1, nb))
    noise = (rng.standard_normal((t, m, nb))
             + 1j * rng.standard_normal((t, m, nb)))
    spec = s * w[idx] + noise * np.linspace(0.01, 2.0, nb)
    return (spec.astype(np.complex64), w.astype(np.complex64),
            idx.astype(np.int64))


@pytest.mark.parametrize("m,u", [(3, 1), (16, 2)])
def test_phase_mask_plain_matches_jax_kernel(m, u):
    """The plain version against phase_mask.py's kernel in interpret mode
    on the same numpy operands (bin 0 is X0[0])."""
    t, nb = 19, 2 * HOP + 2
    spec, w, idx = _operands(m, t, nb, u, 3 + m)
    consts = (0.35, 0.004, 0.1, 2 * HOP)
    ia, ib = jphase.pair_indices(m)
    yr, yi = jpm.phase_mask_pallas(
        np.ascontiguousarray(spec.real), np.ascontiguousarray(spec.imag),
        np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag), idx,
        min_phase_rad=consts[0], mag_threshold=consts[1],
        mag_mult=consts[2], nfft=consts[3], ia=ia, ib=ib, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    got = tpm.phase_mask(*(torch.as_tensor(a) for a in (spec, w, idx)),
                         *consts)
    assert got.dtype == torch.complex64 and got.shape == (t, nb)
    np.testing.assert_array_equal(got[:, 0].numpy(), spec[:, 0, 0])
    assert_close_mod_flips(got.numpy(), ref)


def test_pair_helpers_match_jax():
    ia, ib = tphase.pair_indices(16)
    ja, jb = jphase.pair_indices(16)
    np.testing.assert_array_equal(ia.numpy(), ja)
    np.testing.assert_array_equal(ib.numpy(), jb)
    ph = np.random.default_rng(0).uniform(-np.pi, np.pi, (5, 16, 33))
    got = tphase.mean_pairwise_phase_dist(torch.as_tensor(ph), ia, ib)
    ref = jphase.mean_pairwise_phase_dist(ph, ja, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-14)


# ------------------------------------------------------------- float32


@pytest.mark.parametrize("solver", ["fused", "xla"])
@pytest.mark.parametrize("xy,steer", [(AIRA3, "static"),
                                      (AIRA3, "timeline"),
                                      (XY16, "static")],
                         ids=["aira3", "aira3-timeline", "aira16"])
def test_phase_float32_matches_jax(xy, steer, solver):
    """The port's float32 ``fused`` (the kernel's plain version) against
    the JAX ``fused`` (its kernel in interpret mode), and ``xla`` against
    ``xla``, under the mask contract."""
    x = make_scene(xy, seconds=0.25, quiet_hops=8, hop=HOP)
    t = x.shape[1] // HOP
    theta = 20.0 if steer == "static" else _timeline(t, 20.0)
    tm, jm = _models(xy, "float32", OPEN, solver)
    y = tm.process(x, theta)
    assert y.dtype == torch.float32
    assert_close_mod_flips(y.numpy(), np.asarray(jm.process(x, theta)))


def test_phase_bf16_spectra_within_budget():
    """The bf16 experiment (``spectra_bf16``) runs the batched formulation
    and stays inside the 1e-3 deviation budget vs the float64 path, as in
    the JAX package's test_parity.py."""
    x = make_scene(AIRA3, seconds=0.25, quiet_hops=8, hop=HOP)
    geom = tgeom.ArrayGeometry.from_xy(AIRA3)
    bf = tphase.PhaseModel(_engine("float32"), geom,
                           PhaseParams(spectra_bf16=True), device="cpu")
    assert bf._strategy() == "xla"
    y64 = tphase.PhaseModel(_engine("float64"), geom, device="cpu").process(
        x, THETA).numpy()
    y = bf.process(x, THETA).numpy()
    assert np.isfinite(y).all()
    assert np.abs(y - y64).max() < 1e-3


def test_phase_strategy():
    """On the CPU ``auto`` runs the batched formulation and ``fused`` the
    kernel's plain version; ``fused`` refuses float64; on CUDA ``auto``
    takes the kernel in float32 unless ``spectra_bf16`` is set (checked
    without a card: the policy reads only the model's device)."""
    geom = tgeom.ArrayGeometry.from_xy(AIRA3)

    def model(dtype="float32", cls=tphase.PhaseModel, **kw):
        return cls(_engine(dtype), geom, PhaseParams(**kw), device="cpu")

    assert model()._strategy() == "xla"
    assert model(solver="fused")._strategy() == "fused"
    assert model(solver="xla")._strategy() == "xla"
    with pytest.raises(ValueError, match="float32"):
        model("float64", solver="fused")._strategy()
    with pytest.raises(ValueError, match="unknown"):
        model(solver="dense")

    class OnCuda(tphase.PhaseModel):
        device = torch.device("cuda")

    assert model(cls=OnCuda)._strategy() == "fused"
    assert model("float64", cls=OnCuda)._strategy() == "xla"
    assert model(cls=OnCuda, spectra_bf16=True)._strategy() == "xla"
    assert model(cls=OnCuda, solver="xla")._strategy() == "xla"


def test_phase_params_match():
    for kw in ({}, tcfg.load_launch_params("phase"), {"solver": "fused"},
               {"spectra_bf16": True, "min_mag": 3.0}):
        assert (dataclasses.asdict(tcfg.make_params("phase", kw))
                == dataclasses.asdict(jcfg.make_params("phase", kw)))


def test_phase_kernel_wrapper_takes_plain_on_cpu():
    """A CPU tensor takes the plain version and counts no launch."""
    spec, w, idx = (torch.as_tensor(a) for a in _operands(3, 5, 34, 1, 0))
    before = tpm.phase_mask.launches
    got = tpm.phase_mask(spec, w, idx, 0.35, 0.004, 0.1, 64)
    assert torch.equal(got, tpm.phase_mask_plain(spec, w, idx, 0.35, 0.004,
                                                 0.1, 64))
    assert tpm.phase_mask.launches == before
    with pytest.raises(ValueError, match="2 mics"):
        tpm.phase_mask_plain(spec[:, :1], w[:, :1], idx, 0.35, 0.004, 0.1,
                             64)


# ------------------------------------------------------------- streaming


@pytest.mark.parametrize("dtype,solver", [("float64", "auto"),
                                          ("float32", "fused")])
def test_phase_chunked_equals_offline(dtype, solver):
    x = make_scene(AIRA3, seconds=0.3, theta_deg=THETA, hop=HOP)
    t = x.shape[1] // HOP
    th = _timeline(t)
    tm, _ = _models(AIRA3, dtype, OPEN, solver)
    offline = tm.process(x, th).numpy()
    sess = StreamingSession(tm)
    outs = [sess.process(x[:, f0 * HOP:(f0 + 4) * HOP], th[f0:f0 + 4])
            .numpy() for f0 in range(0, t, 4)]
    tol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(np.concatenate(outs), offline, rtol=0,
                               atol=tol * np.abs(offline).max())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_phase_checkpoints_move_between_packages(direction, tmp_path):
    x = make_scene(AIRA3, seconds=0.3, theta_deg=THETA, hop=HOP)
    t = x.shape[1] // HOP
    half = t // 2
    tm, jm = _models(AIRA3, "float64", OPEN)
    full = np.asarray(jm.process(x, THETA))
    first, second = ((JSession(jm), StreamingSession(tm))
                     if direction == "jax_to_port"
                     else (StreamingSession(tm), JSession(jm)))
    y1 = np.asarray(first.process(x[:, :half * HOP], THETA))
    ckpt = str(tmp_path / "state.npz")
    first.save(ckpt)
    second.load(ckpt)
    y2 = np.asarray(second.process(x[:, half * HOP:]))
    np.testing.assert_allclose(np.concatenate([y1, y2]), full, rtol=0,
                               atol=1e-12)
    if direction == "jax_to_port":
        import jax
        state = state_from_jax([np.asarray(a) for a in
                                jax.tree.leaves(first.state)],
                               like=tm.stream_init())
        out, _ = tm.process_chunk(x[:, half * HOP:], THETA, state)
        np.testing.assert_allclose(out.numpy(), y2, rtol=0, atol=1e-12)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("extra", [[], ["--stream", "8"],
                                   ["--theta-timeline", "0.1:-30"]])
def test_cli_phase_matches_jax_cli(extra, tmp_path):
    """Both CLIs with the phase launch preset, float64, offline, streaming
    and under a theta timeline; the port's CLI equals its run_offline."""
    x = make_scene(AIRA3, seconds=0.3, theta_deg=THETA, hop=HOP, seed=4)
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    cfg = os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira3.yaml")
    args = ["phase", "--in", src, "--array-config", cfg, "--window-size",
            str(HOP), "--theta", str(THETA), "--dtype", "float64",
            "--out-format", "float32", "--param", "mag_threshold=0.0002",
            *extra]
    assert jax_cli(args + ["--out", str(tmp_path / "j.wav")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "t.wav"), "--device",
                            "cpu"]) == 0
    ref, _ = wav.read_wav(str(tmp_path / "j.wav"))
    got, fs = wav.read_wav(str(tmp_path / "t.wav"))
    assert fs == FS and got.shape == ref.shape and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if not extra:
        xin, _ = wav.read_wav(src)
        y = run_offline("phase", xin, engine=_engine("float64"),
                        array_cfg=tcfg.load_array_config(cfg), theta=THETA,
                        params=dict(tcfg.load_launch_params("phase"),
                                    mag_threshold=0.0002), device="cpu")
        np.testing.assert_allclose(got[0], y, rtol=0, atol=1e-6)


# ------------------------------------------------- float32 drift, aira16


def test_phase_float32_error_is_the_jax_packages():
    """The float32 paths' max sample deviation from float64 on the first
    10 s of chip_smoke.py's noise and steered-source inputs (16 mics,
    hop 1024, the launch preset), in the JAX package and in the port
    (``fused``: the kernel's plain version). chip_smoke.py holds the card
    to twice the JAX numbers printed here (``pytest -s``), or to the flip
    contract, whichever is looser; here the port's float32 paths meet the
    flip contract against float64 too."""
    _float32_error("phase")


def _float32_error(node):
    """Shared with the phasempf and mcra files: measure, print, and hold
    the port's float32 paths to the flip contract against float64."""
    import chip_smoke
    jcfg16 = jcfg.load_array_config(os.path.join(
        ROOT, "beamform_tpu", "configs", "aira16.yaml"))
    tcfg16 = tcfg.load_array_config(os.path.join(
        ROOT, "beamform_tpu_torch", "configs", "aira16.yaml"))
    params = tcfg.load_launch_params(node)
    from beamform_tpu.models import get_model as jget
    from beamform_tpu_torch.models import get_model as tget
    for scene, make in (("noise", chip_smoke.make_input),
                        ("source", chip_smoke.make_source_input)):
        x = make(16, 10.0)
        ys = {}
        for dt in ("float32", "float64"):
            ys[("jax", dt)] = np.asarray(jget(node, JEngine(dtype=dt),
                                              jcfg16, params).process(
                                                  x, chip_smoke.THETA))
        solvers = ["auto"] if node == "mcra" else ["fused", "xla"]
        for solver in solvers:
            p = params if node == "mcra" else dict(params, solver=solver)
            ys[("port", solver)] = tget(
                node, EngineConfig(), tcfg16, p, device="cpu").process(
                    x, chip_smoke.THETA).numpy()
        ref = ys[("jax", "float64")]
        dev = {k: float(np.abs(v - ref).max()) for k, v in ys.items()
               if k != ("jax", "float64")}
        print(f"{node} {scene} float32 vs float64, 10 s aira16: "
              + ", ".join(f"{k[0]} {k[1]} {v!r}" for k, v in dev.items())
              + f" (peak {float(np.abs(ref).max())!r})")
        for solver in solvers:
            assert_close_mod_flips(ys[("port", solver)], ref)


# ----------------------------------------- the CUDA front end's algebra

F32 = np.float32
# Cephes' atanf coefficients and tan(pi / 8), as csrc/phase_mask.cu holds
# them
_CEPHES = (F32(8.05374449538e-2), F32(-1.38776856032e-1),
           F32(1.99777106478e-1), F32(-3.33329491539e-1))
_TAN_PI_8 = F32(0.414213562373095049)
# the transliteration's worst error against float64 arctan2 over the cases
# below is 3.2 ulp (float32 rounding of lo -/+ hi, of the quotient and of
# the polynomial, op by op; the kernel fuses some into FMAs and takes the
# reciprocal from MUFU.RCP: tools/h100_probe/fastpath_check.py measures it)
ATAN2_ULPS = 4.0


def _atan2_cuda_form(y, x):
    """csrc/phase_mask.cu ``atan2_fast`` in numpy float32: the fold test's
    sign exact (the kernel's FMA), the quotient as num x (1 / den) where
    den lies in [2^-125, 2^126) and else the exact quotient of lo and hi
    scaled by 2^-+64, the degree-9 polynomial, the octant, x's sign bit
    and y's sign."""
    y, x = np.asarray(y, F32), np.asarray(x, F32)
    ax, ay = np.abs(x), np.abs(y)
    hi, lo = np.maximum(ax, ay), np.minimum(ax, ay)
    fold = lo.astype(np.float64) - float(_TAN_PI_8) * hi.astype(np.float64) > 0
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        num = np.where(fold, lo - hi, lo)
        den = np.where(fold, lo + hi, hi)
        e = (den.view(np.uint32) >> 23).astype(np.int64)
        fast = (e >= 2) & (e <= 252)
        sc = np.where(hi > 1, F32(2.0 ** -64), F32(2.0 ** 64))
        lo_s, hi_s = lo * sc, hi * sc
        exact = np.where(fold, (lo_s - hi_s) / (lo_s + hi_s),
                         lo_s / np.maximum(hi_s, F32(1e-45)))
        z = np.where(fast, num * (F32(1) / den), exact).astype(F32)
    s = z * z
    p0, p1, p2, p3 = _CEPHES
    p = (((p0 * s + p1) * s + p2) * s + p3) * s * z + z
    a = np.where(fold, F32(np.pi / 4) + p, p)
    a = np.where(ay > ax, F32(np.pi / 2) - a, a)
    a = np.where(np.signbit(x), F32(np.pi) - a, a)
    return np.copysign(a, y).astype(F32)


def _ulps(got, ref):
    """|got - ref| in units of float32's spacing at |ref| (ref float64)."""
    return (np.abs(got.astype(np.float64) - ref)
            / np.spacing(np.abs(ref).astype(F32)).astype(np.float64))


def _atan2_inputs(case):
    """(y, x) float32 pairs of one class of inputs."""
    rng = np.random.default_rng(13)
    s = np.array([1.0, -1.0], F32)
    if case == "zeros_and_axes":
        v = np.array([0.0, -0.0, 1.0, -1.0, 3.5, -2e-30, 7e30], F32)
        y, x = np.meshgrid(v, v)
    elif case == "diagonals":
        m = (2.0 ** rng.uniform(-140, 126, 2000)).astype(F32)
        y = m * rng.choice(s, 2000)
        x = m * rng.choice(s, 2000)
    elif case == "fold_point":
        # lo / hi within a few ulps of tan(pi / 8), either side
        hi = (2.0 ** rng.uniform(-100, 100, 4000)).astype(F32)
        lo = (hi * _TAN_PI_8).astype(F32)
        lo = np.nextafter(lo, lo * F32(2) * rng.choice(s, 4000))
        y, x = np.where(rng.random(4000) < 0.5, (lo, hi), (hi, lo))
        y, x = y * rng.choice(s, 4000), x * rng.choice(s, 4000)
    elif case == "subnormal":
        y = (rng.integers(0, 2 ** 23, 4000) * rng.choice(s, 4000)).astype(
            np.int64).astype(F32) * F32(2.0 ** -149)
        x = (rng.integers(0, 2 ** 23, 4000) * rng.choice(s, 4000)).astype(
            np.int64).astype(F32) * F32(2.0 ** -149)
    elif case == "large":
        y = ((2.0 ** rng.uniform(100, 127.9, 4000)) * rng.choice(s, 4000))
        x = ((2.0 ** rng.uniform(100, 127.9, 4000)) * rng.choice(s, 4000))
    else:                                      # seeded pairs
        y = rng.standard_normal(100_000)
        x = rng.standard_normal(100_000)
    return np.asarray(y, F32).ravel(), np.asarray(x, F32).ravel()


@pytest.mark.parametrize("case", ["zeros_and_axes", "diagonals",
                                  "fold_point", "subnormal", "large",
                                  "seeded_pairs"])
def test_cuda_atan2_form_within_ulps_of_float64(case):
    """The CUDA front end's atan2, transliterated, within ATAN2_ULPS of
    float64 arctan2 (IEEE's signed zeros exactly: atan2(+-0, -0) = +-pi,
    atan2(+-0, +0) = +-0)."""
    y, x = _atan2_inputs(case)
    got = _atan2_cuda_form(y, x)
    ref = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    assert np.isfinite(got).all()
    assert _ulps(got, ref).max() <= ATAN2_ULPS, _ulps(got, ref).max()
    zero = ref == 0
    np.testing.assert_array_equal(np.signbit(got[zero]),
                                  np.signbit(ref[zero]))


@pytest.mark.parametrize("case", ["diagonals", "fold_point",
                                  "seeded_pairs"])
def test_cuda_atan2_form_matches_the_jax_kernels(case):
    """The same form against the JAX kernel's ``atan2f``
    (beamform_tpu/kernels/phase_mask.py) on normal-range inputs: the two
    differ only in the fold test's rounding, the division (the port's
    num x (1 / den)) and signed zeros, within 2 ATAN2_ULPS of each
    other."""
    y, x = _atan2_inputs(case)
    keep = (np.abs(y) > 2.0 ** -60) & (np.abs(x) > 2.0 ** -60) \
        & (np.abs(y) < 2.0 ** 60) & (np.abs(x) < 2.0 ** 60)
    y, x = y[keep], x[keep]
    assert len(y) > 900
    got = _atan2_cuda_form(y, x)
    ref = np.asarray(jpm.atan2f(y, x), F32)
    assert _ulps(got, ref.astype(np.float64)).max() <= 2 * ATAN2_ULPS


def _pair_forms(ph):
    """(the plain version's mean wrapped pair distance, the CUDA form's
    sum of min(|d|, 2 pi - |d|) over pairs / pairs, the three-instruction
    form's (pairs pi - sum |pi - |d||) / pairs), float32 phases (T, M)
    summed pair after pair in float32, anchor by anchor as the kernel
    unrolls them."""
    m = ph.shape[1]
    pairs = m * (m - 1) // 2
    plain, acc, cancel = (np.zeros(len(ph), F32) for _ in range(3))
    for i in range(m - 1):
        for j in range(i + 1, m):
            d = np.abs(ph[:, i] - ph[:, j])
            plain = plain + np.where(d > F32(np.pi), F32(2 * np.pi) - d, d)
            acc = acc + np.minimum(d, F32(2 * np.pi) - d)
            cancel = cancel + np.abs(F32(np.pi) - d)
    inv = F32(1.0 / pairs)
    return plain * inv, acc * inv, (F32(pairs * np.pi) - cancel) * inv


def _pair_mean_f64(ph):
    """The float64 mean wrapped pair distance of float32 phases (T, M)."""
    p64 = ph.astype(np.float64)
    d = np.abs(p64[:, :, None] - p64[:, None, :])
    w = np.where(d > np.pi, 2 * np.pi - d, d)
    iu = np.triu_indices(ph.shape[1], 1)
    return w[:, iu[0], iu[1]].mean(1)


# (mics, None: phases uniform in [-pi, pi]; or the min_phase in degrees
# that the mean pair distance sits at: the presets' 10 and 30)
PAIR_CASES = [(2, None), (3, None), (16, None), (32, None)] + [
    (m, deg) for deg in (10.0, 30.0) for m in (2, 16, 32)]


@pytest.mark.parametrize(
    "m,min_phase_deg", PAIR_CASES,
    ids=[str(m) if d is None else f"{d:g}deg-{m}" for m, d in PAIR_CASES])
def test_cuda_pair_form_matches_the_plain_sum(m, min_phase_deg):
    """The kernel's pair term, min(|d|, 2 pi - |d|) summed as it is, is
    the plain version's wrapped distance to the bit (fl(2 pi) = 2 fl(pi),
    and 2 pi - d is exact for d above pi), so its float32 sum is as near
    the float64 mean pair distance as the plain version's: over 10^4
    seeded frames of phases in [-pi, pi] (4.1e-7 to 2.9e-6 rad from 2 to
    32 mics), and where the masks decide, over 2 x 10^4 frames clustered
    about a random centre so that the mean sits at min_phase (2.2e-7 to
    8.0e-7 rad). There the three-instruction form pi - |pi - |d|| with
    pairs x pi added once, which subtracts two sums near pairs x pi, was
    13.5x (16 mics) and 19.0x (32 mics) further from float64 than the
    plain sum at 10 degrees, 4.3x and 5.3x at 30, so the kernel does not
    use it (held here at more than 4x from 16 mics). The kernel's atan2
    moves only the last bits of the mean, where the flip contract lets a
    bin cross a mask's threshold."""
    rng = np.random.default_rng(m)
    if min_phase_deg is None:
        ph = rng.uniform(-np.pi, np.pi, (10_000, m)).astype(F32)
    else:
        target = np.deg2rad(min_phase_deg)
        centre = rng.uniform(-np.pi, np.pi, (20_000, 1))
        # E|a - b| = 2 s / sqrt(pi) for a, b ~ N(c, s^2)
        ph = centre + target * np.sqrt(np.pi) / 2 \
            * rng.standard_normal((20_000, m))
        ph = (np.mod(ph + np.pi, 2 * np.pi) - np.pi).astype(F32)
    plain, form, cancel = _pair_forms(ph)
    ref = _pair_mean_f64(ph)
    err_plain = np.abs(plain - ref).max()
    err_form = np.abs(form - ref).max()
    assert err_form <= 1.5 * err_plain + 1e-7
    assert np.abs(form - plain).max() < 4e-6
    assert np.array_equal(form, plain)
    if min_phase_deg is not None:
        assert abs(ref.mean() - target) < 0.05 * target
        assert err_form < 2e-6
        if m >= 16:
            assert np.abs(cancel - ref).max() > 4 * err_plain
