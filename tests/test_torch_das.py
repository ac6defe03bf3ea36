"""The port's DAS main path against the JAX package and the float64 oracle.

Every input is made with numpy from a seed and fed to both packages. Bars:
float64 oracle parity 1e-9 (test_parity.py's), float64 JAX-vs-port 1e-12,
float32 JAX-vs-port 1e-5 of peak (both on the CPU, sums in another order).
"""

import io
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from beamform_tpu import geometry as jgeom
from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.config import load_array_config as jload
from beamform_tpu.models import common as jcommon
from beamform_tpu.models.das import DasModel as JDas
from beamform_tpu.oracle import nodes as on
from beamform_tpu.runtime.cli import main as jax_cli
from beamform_tpu.runtime.offline import run_offline as jax_run_offline
from beamform_tpu.runtime.streaming import StreamingSession as JSession
from beamform_tpu_torch import geometry as tgeom
from beamform_tpu_torch import run_offline
from beamform_tpu_torch.config import EngineConfig, load_array_config
from beamform_tpu_torch.convert import constants_from_jax, state_from_jax
from beamform_tpu_torch.models import common as tcommon
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.models.das import DasModel
from beamform_tpu_torch.runtime import cli, wav
from beamform_tpu_torch.runtime.streaming import StreamingSession

from conftest import AIRA3, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
FS = 48000
THETA = 25.0
F32_REL = 1e-5


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


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("exact", [False, True])
def test_frequency_layout_matches_jax(exact):
    jeng = JEngine(window_size=HOP, exact_freqs=exact)
    teng = EngineConfig(window_size=HOP, exact_freqs=exact)
    f = tcommon.make_freqs_ext(teng)
    np.testing.assert_array_equal(f, jcommon.make_freqs_ext(jeng))
    np.testing.assert_array_equal(
        tgeom.frequency_vector(2 * HOP, FS, exact=exact),
        jgeom.frequency_vector(2 * HOP, FS, exact=exact))
    h = HOP
    if not exact:   # the reference's quirks (util.h:190-199)
        assert f[h - 1] == FS / 2 and f[h] == 0.0
    assert f[h + 1] == -(h - 1) * FS / (2 * HOP)   # the shadow's frequency


def test_steering_weights_match_jax_float64():
    geom_t = tgeom.ArrayGeometry.from_xy(AIRA3)
    geom_j = jgeom.ArrayGeometry.from_xy(AIRA3)
    thetas = np.array([-170.0, -40.0, 0.0, 25.0, 179.5])
    f = jcommon.make_freqs_ext(JEngine(window_size=HOP))
    ref = jcommon.weights_for_thetas(geom_j, f, thetas, jax.numpy.float64,
                                     jax.numpy.complex128)
    got = tcommon.weights_for_thetas(
        geom_t, torch.as_tensor(f), torch.as_tensor(thetas), torch.float64,
        torch.complex128)
    assert got.shape == (5, 3, HOP + 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(
        tgeom.steering_delays(geom_t, thetas).numpy(),
        np.asarray(jgeom.steering_delays(geom_j, thetas,
                                         dtype=jax.numpy.float64)),
        rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        tgeom.steering_weights_np(f, tgeom.steering_delays_np(geom_t,
                                                              thetas)),
        jgeom.steering_weights_np(f, jgeom.steering_delays_np(geom_j,
                                                              thetas)),
        rtol=0, atol=0)


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("timeline", [False, True])
def test_das_float64_matches_oracle(timeline):
    """test_parity.py's DAS bar (1e-9) for the port, constant theta and a
    mid-stream theta change."""
    x = make_scene(AIRA3, fs=FS, seconds=0.3, theta_deg=THETA, hop=HOP)
    t = x.shape[1] // HOP
    th = _timeline(t) if timeline else THETA
    _, teng = _engines("float64")
    y = DasModel(teng, tgeom.ArrayGeometry.from_xy(AIRA3),
                 device="cpu").process(x, th)
    o = on.DasOracle(AIRA3, HOP, FS, float(np.atleast_1d(th)[0]))
    outs = []
    for k in range(t):
        if timeline and k == t // 2:
            o.set_theta(-40.0)
        outs.append(o.callback(x[:, k * HOP:(k + 1) * HOP]))
    np.testing.assert_allclose(y.numpy(), np.concatenate(outs), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("array", ["aira3.yaml", "aira16.yaml"])
def test_das_float32_matches_jax_model(array):
    cfg_j, cfg_t = jload(_cfg(array)), load_array_config(_cfg(array))
    rng = np.random.default_rng(11)
    x = (0.1 * rng.standard_normal((cfg_t.num_mics, 24 * HOP))
         ).astype(np.float32)
    th = _timeline(24)
    jeng, teng = _engines("float32")
    jm = JDas(jeng, jgeom.ArrayGeometry.from_config(cfg_j))
    tm = get_model("das", teng, cfg_t, device="cpu")
    tm.load_state_dict(constants_from_jax(jm))   # identical host constants
    ref = np.asarray(jm.process(x, th))
    got = tm.process(x, th)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < F32_REL


def test_constants_from_jax_equal_port_constants():
    for dtype in ("float32", "float64"):
        jeng, teng = _engines(dtype)
        jm = JDas(jeng, jgeom.ArrayGeometry.from_xy(AIRA3))
        tm = DasModel(teng, tgeom.ArrayGeometry.from_xy(AIRA3), device="cpu")
        for name, value in constants_from_jax(jm).items():
            got = getattr(tm, name)
            assert got.dtype == value.dtype
            torch.testing.assert_close(got, value, rtol=0, atol=0)


def test_run_offline_matches_jax_float64():
    cfg_j, cfg_t = jload(_cfg("aira3.yaml")), load_array_config(
        _cfg("aira3.yaml"))
    x = make_scene(AIRA3, fs=FS, seconds=0.2, theta_deg=THETA, hop=HOP)
    x = x[:, :-37]                            # not a hop multiple: padded
    jeng, teng = _engines("float64")
    ref = np.asarray(jax_run_offline("das", x, engine=jeng, array_cfg=cfg_j,
                                     theta=THETA))
    got = run_offline("das", x, engine=teng, array_cfg=cfg_t, theta=THETA,
                      device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    # the ref node, the evaluation signal every separation metric lines up
    # against, through the same entry point
    ref = np.asarray(jax_run_offline("ref", x, engine=jeng, array_cfg=cfg_j))
    got = run_offline("ref", x, engine=teng, array_cfg=cfg_t, device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# -------------------------------------------------------------- streaming


def test_streaming_chunks_equal_offline_float64():
    _, teng = _engines("float64")
    cfg = load_array_config(_cfg("aira3.yaml"))
    x = make_scene(AIRA3, fs=FS, seconds=0.2, theta_deg=THETA, hop=HOP,
                   seed=4)
    t = x.shape[1] // HOP
    th = _timeline(t)
    model = get_model("das", teng, cfg, device="cpu")
    offline = model.process(x, th).numpy()
    sess = StreamingSession(model)
    outs = [sess.process(x[:, i * HOP:(i + 4) * HOP], th[i:i + 4]).numpy()
            for i in range(0, t, 4)]
    np.testing.assert_allclose(np.concatenate(outs)[:len(offline)], offline,
                               rtol=0, atol=1e-12)
    assert sess.frames_done == t
    with pytest.raises(ValueError, match="multiple of hop"):
        sess.process(np.zeros((3, HOP + 1)))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_move_between_packages(direction, tmp_path):
    cfg_j = jload(_cfg("aira3.yaml"))
    cfg_t = load_array_config(_cfg("aira3.yaml"))
    jeng, teng = _engines("float32")
    x = make_scene(AIRA3, fs=FS, seconds=0.2, theta_deg=THETA, hop=HOP,
                   seed=6).astype(np.float32)
    half = (x.shape[1] // (2 * HOP)) * HOP
    jmodel = JDas(jeng, jgeom.ArrayGeometry.from_config(cfg_j))
    tmodel = get_model("das", teng, cfg_t, device="cpu")
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
    assert _rel(np.concatenate([y1, y2]), full) < F32_REL

    if direction == "jax_to_port":
        # the same hand-over in memory, through convert.state_from_jax
        leaves = [np.asarray(a) for a in jax.tree.leaves(first.state)]
        state = state_from_jax(leaves)
        out, _ = tmodel.process_chunk(x[:, half:], THETA, state)
        assert _rel(out, y2) < F32_REL


# -------------------------------------------------------------------- CLI


def _write_scene(tmp_path, seconds=0.2):
    x = make_scene(AIRA3, fs=FS, seconds=seconds, theta_deg=THETA, hop=HOP,
                   seed=7)
    path = str(tmp_path / "in.wav")
    wav.write_wav(path, x, FS, fmt="float32")
    return path


def test_cli_stream_theta_timeline_matches_jax_cli(tmp_path):
    src = _write_scene(tmp_path)
    common = ["das", "--in", src, "--array-config", _cfg("aira3.yaml"),
              "--window-size", str(HOP), "--theta", "10",
              "--theta-timeline", "0.05:-40", "--stream", "4",
              "--out-format", "float32"]
    assert jax_cli(common + ["--out", str(tmp_path / "j.wav")]) == 0
    assert cli.main(common + ["--out", str(tmp_path / "t.wav"),
                              "--device", "cpu",
                              "--save-state", str(tmp_path / "s.npz")]) == 0
    ref, _ = wav.read_wav(str(tmp_path / "j.wav"))
    got, fs = wav.read_wav(str(tmp_path / "t.wav"))
    assert fs == FS and got.shape == ref.shape
    assert _rel(got, ref) < F32_REL
    assert np.load(str(tmp_path / "s.npz"))["__last_theta__"] == -40.0


def test_cli_wav_roundtrip_equals_run_offline(tmp_path, capsys):
    src = _write_scene(tmp_path)
    dst = str(tmp_path / "out.wav")
    assert cli.main(["das", "--in", src, "--out", dst, "--array-config",
                     _cfg("aira3.yaml"), "--window-size", str(HOP),
                     "--theta", str(THETA), "--device", "cpu",
                     "--out-format", "float32", "--report-json"]) == 0
    report = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"device": "cpu"' in report
    x, _ = wav.read_wav(src)
    ref = run_offline("das", x, engine=EngineConfig(window_size=HOP),
                      array_cfg=load_array_config(_cfg("aira3.yaml")),
                      theta=THETA, device="cpu")
    got, _ = wav.read_wav(dst)
    np.testing.assert_array_equal(got[0], ref)


@pytest.mark.parametrize("argv", [["write"], ["das", "--live"]])
def test_cli_rejects_what_is_not_ported(argv, tmp_path, capsys,
                                        monkeypatch):
    """Both were refused before the live path was ported; now each runs:
    ``write --in`` plays the file through the decoupling ring into
    ``<in>.write.wav`` (pass-through in steady state), ``das --live``
    beamforms its stdin (``--in`` unused) to stdout, one sample out for
    each frame in."""
    src = _write_scene(tmp_path, seconds=0.05)
    x, _ = wav.read_wav(src)
    pcm = np.ascontiguousarray(x.T[:, :1], dtype="<f4")      # one channel
    stdin = tmp_path / "stdin.pcm"
    stdin.write_bytes(pcm.tobytes())
    out = io.BytesIO()
    with open(stdin, "rb") as f:
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(f))
        monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(out))
        rc = cli.main(argv + ["--in", src, "--device", "cpu",
                              "--window-size", str(HOP)])
        sys.stdout.flush()
        data = out.getvalue()
    monkeypatch.undo()
    assert rc == 0
    err = capsys.readouterr().err
    assert "not ported" not in err
    if argv == ["write"]:
        y, fs = wav.read_wav(src + ".write.wav")
        n = x.shape[1]
        assert fs == FS and y.shape == (1, n + (-n) % HOP)
        np.testing.assert_allclose(y[0, :n], x[0], atol=2 ** -15)
    else:
        y = np.frombuffer(data, dtype="<f4")
        assert y.shape == (x.shape[1],) and np.isfinite(y).all()
        assert np.abs(y).max() > 0
        assert '"live"' in err.strip().splitlines()[-1]


def test_cli_output_resampling_is_not_ported(tmp_path, capsys):
    """Refused before output resampling was ported; now the file comes at
    ``ros_output_sample_rate``."""
    rosjack = tmp_path / "rosjack.yaml"
    rosjack.write_text("ros_output_sample_rate: 16000\n")
    src = _write_scene(tmp_path, seconds=0.05)
    dst = str(tmp_path / "out.wav")
    assert cli.main(["das", "--in", src, "--out", dst, "--rosjack-config",
                     str(rosjack), "--device", "cpu"]) == 0
    assert "not ported" not in capsys.readouterr().err
    x, _ = wav.read_wav(src)
    y, fs = wav.read_wav(dst)
    n = x.shape[1] + (-x.shape[1]) % 1024           # the default hop
    assert fs == 16000 and y.shape == (1, -(-n // 3))


def test_default_device_is_cuda_and_never_falls_back():
    """get_model and the model classes build on the card unless the caller
    asks for the CPU: without CUDA the default raises through torch and
    never returns a model on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from beamform_tpu_torch.models import MODEL_REGISTRY
    cfg = load_array_config(_cfg("aira3.yaml"))
    for build in ([lambda: get_model("das", EngineConfig(), cfg)]
                  + [lambda cls=cls: cls(EngineConfig(),
                                         tgeom.ArrayGeometry.from_config(cfg))
                     for cls in MODEL_REGISTRY.values()]):
        with pytest.raises((AssertionError, RuntimeError)):
            build()
    assert get_model("das", EngineConfig(), cfg,
                     device="cpu").device.type == "cpu"


def test_cli_cuda_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["das", "--in", _write_scene(tmp_path, seconds=0.05)])


# ------------------------------------------------------------- no JAX


def test_import_loads_no_jax():
    code = ("import sys, beamform_tpu_torch, beamform_tpu_torch.runtime.cli,"
            " beamform_tpu_torch.convert, beamform_tpu_torch.models.mvdr,"
            " beamform_tpu_torch.kernels.mvdr_stream,"
            " beamform_tpu_torch.kernels.linalg,"
            " beamform_tpu_torch.kernels.lcmv_stream,"
            " beamform_tpu_torch.models.lcmv,"
            " beamform_tpu_torch.kernels.mega_stream,"
            " beamform_tpu_torch.kernels.gss_stream,"
            " beamform_tpu_torch.models.gss,"
            " beamform_tpu_torch.kernels.phase_mask,"
            " beamform_tpu_torch.models.phase,"
            " beamform_tpu_torch.models.mcra,"
            " beamform_tpu_torch.models.phasempf,"
            " beamform_tpu_torch.kernels.gsc_block,"
            " beamform_tpu_torch.models.refmic,"
            " beamform_tpu_torch.runtime.timeline,"
            " beamform_tpu_torch.runtime.native,"
            " beamform_tpu_torch.runtime.playback,"
            " beamform_tpu_torch.runtime.resample,"
            " beamform_tpu_torch.utils.profiling,"
            " beamform_tpu_torch.doa, chip_smoke; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'beamform_tpu' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_package_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|beamform_tpu)(\.|\s|$)",
                     re.M)
    pkg = os.path.join(ROOT, "beamform_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
