"""The port's native audio runtime (``beamform_tpu_torch/runtime/native.py``
over ``csrc/beamio.cpp``): its own build, its bindings against the JAX
package's on the same library, the JACK client through the fake server
(``csrc/fakejack.cpp``, built into the port's build directory), the CLI's
JACK loop, and the exit with a hint on a host without ALSA."""

import ctypes
import os
import threading
import time

import numpy as np
import pytest

from beamform_tpu_torch.config import EngineConfig, load_array_config
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.runtime import cli, native
from beamform_tpu_torch.runtime import wav as pywav
from beamform_tpu_torch.runtime.streaming import StreamingSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIRA3 = os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira3.yaml")


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ------------------------------------------------------------------ build


def test_library_builds_into_the_port_build_dir():
    path = native.build_library("beamio.cpp")
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libbeamio_")
    assert native.load()._name == path
    assert native.build_library("beamio.cpp") == path     # once a process


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "CSRC", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError,
                       match="(?s)g\\+\\+ failed.*error: expected"):
        native.build_library("broken.cpp")
    assert not os.listdir(tmp_path / "build")         # no half-built file


# ------------------------------------------- bindings against the JAX ones


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's bindings, loaded on the port's build of the same
    source (the JAX loader would otherwise build into csrc/)."""
    from beamform_tpu.runtime import native as jn
    monkeypatch.setattr(jn, "_build",
                        lambda: native.build_library("beamio.cpp"))
    monkeypatch.setattr(jn, "_LIB", None)
    monkeypatch.setattr(jn, "_TRIED", False)
    return jn


def test_ring_buffer_matches_jax(jax_native):
    a, b = jax_native.RingBuffer(1024), native.RingBuffer(1024)
    rng = np.random.default_rng(0)
    for n_w, n_r in ((300, 100), (900, 0), (50, 5000), (1024, 7)):
        x = rng.standard_normal(n_w).astype(np.float32)
        assert a.write(x) == b.write(x)
        assert a.available == b.available
        np.testing.assert_array_equal(a.read(n_r), b.read(n_r))


def test_resampler_matches_jax(jax_native):
    t = np.arange(48000) / 48000.0
    x = (np.sin(2 * np.pi * 440.0 * t)
         + 0.1 * np.random.default_rng(1).standard_normal(48000))
    x = x.astype(np.float32)
    for fs_in, fs_out in ((48000, 16000), (48000, 44100), (16000, 48000)):
        a = jax_native.Resampler(fs_in, fs_out)
        b = native.Resampler(fs_in, fs_out)
        ya = np.concatenate([a.process(x[i:i + 4800])
                             for i in range(0, 48000, 4800)])
        yb = np.concatenate([b.process(x[i:i + 4800])
                             for i in range(0, 48000, 4800)])
        np.testing.assert_array_equal(ya, yb)
        assert abs(len(yb) - 48000 * fs_out // fs_in) < 200


def test_wav_stream_matches_jax(jax_native, tmp_path):
    x = 0.2 * np.random.default_rng(2).standard_normal((3, 1000))
    p = str(tmp_path / "s.wav")
    pywav.write_wav(p, x.astype(np.float32), 48000, fmt="float32")
    a, b = jax_native.WavStream(p), native.WavStream(p)
    assert (b.channels, b.sample_rate, b.frames) == (3, 48000, 1000)
    chunks = []
    for _ in range(5):                      # past EOF: zeros, 0 frames
        (ca, na), (cb, nb) = a.read(256), b.read(256)
        assert na == nb
        np.testing.assert_array_equal(ca, cb)
        chunks.append(cb[:, :nb])
    assert nb == 0 and not cb.any()
    np.testing.assert_allclose(np.concatenate(chunks, axis=1), x, atol=1e-6)
    a.close()
    b.close()


# ------------------------------------------------- JACK through the fake


@pytest.fixture
def fake(monkeypatch):
    """BEAMIO_JACK_LIB -> the fake server, built into the port's build
    directory; yields its driver (this test is the server's RT thread)."""
    path = native.build_library("fakejack.cpp")
    monkeypatch.setenv("BEAMIO_JACK_LIB", path)
    drv = ctypes.CDLL(path)
    c = ctypes
    drv.fakejack_drive.restype = c.c_int
    drv.fakejack_drive.argtypes = [c.POINTER(c.c_float), c.c_uint32,
                                   c.c_int, c.POINTER(c.c_float)]
    drv.fakejack_num_connections.restype = c.c_int
    drv.fakejack_connection.restype = c.c_int
    drv.fakejack_connection.argtypes = [c.c_int, c.c_char_p, c.c_int]
    drv.fakejack_set_rate.argtypes = [c.c_uint32]
    return drv


def drive(drv, block):
    """One process cycle: (C, N) capture block in, (N,) playback out."""
    block = np.ascontiguousarray(block, dtype=np.float32)
    ch, n = block.shape
    inter = np.ascontiguousarray(block.T)
    out = np.zeros(n, dtype=np.float32)
    assert drv.fakejack_drive(_fp(inter), n, ch, _fp(out)) == 0
    return out


def test_jack_runtime_follows_the_hook(fake):
    assert native.load().bio_jack_runtime_available() == 1


def test_jack_capture_interleave_bit_exact(fake):
    cl = native.JackClient(channels=3)
    try:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 256)).astype(np.float32)
        drive(fake, x)
        np.testing.assert_array_equal(cl.read(256), x)
        y = rng.standard_normal((3, 256)).astype(np.float32)
        drive(fake, y)
        np.testing.assert_array_equal(cl.read(100), y[:, :100])
    finally:
        cl.close()


def test_jack_playback_and_underrun_silence(fake):
    cl = native.JackClient(channels=1)
    try:
        mono = np.linspace(-0.5, 0.5, 256).astype(np.float32)
        assert cl.write(mono) == 256
        np.testing.assert_array_equal(
            drive(fake, np.zeros((1, 256), np.float32)), mono)
        np.testing.assert_array_equal(
            drive(fake, np.zeros((1, 256), np.float32)),
            np.zeros(256, np.float32))
    finally:
        cl.close()


@pytest.mark.parametrize("auto", [True, False])
def test_jack_autoconnect(fake, auto):
    cl = native.JackClient(channels=3, auto_connect=auto, connect_out=auto)
    try:
        assert (cl.connected_in, cl.connected_out) == ((3, 1) if auto
                                                       else (0, 0))
        assert fake.fakejack_num_connections() == (4 if auto else 0)
        if auto:
            buf = ctypes.create_string_buffer(128)
            fake.fakejack_connection(0, buf, len(buf))
            assert buf.value == b"system:capture_1 -> beamform_tpu:input_1"
            fake.fakejack_connection(3, buf, len(buf))
            assert buf.value == b"beamform_tpu:output -> system:playback_1"
    finally:
        cl.close()


def test_jack_engine_rate_follows_server(fake):
    fake.fakejack_set_rate(44100)
    try:
        cl = native.JackClient(channels=1)
        assert cl.sample_rate == 44100
        cl.close()
    finally:
        fake.fakejack_set_rate(48000)


def test_jack_capture_overrun_counts(fake):
    cl = native.JackClient(channels=2)
    try:
        for _ in range(3):            # 2 s rings overfilled, nobody reads
            drive(fake, np.zeros((2, 48000), np.float32))
        assert cl.xruns >= 1
    finally:
        cl.close()


def test_jack_server_shutdown_detected(fake):
    cl = native.JackClient(channels=1)
    try:
        assert cl.alive
        fake.fakejack_shutdown()
        assert not cl.alive
        with pytest.raises(RuntimeError, match="shut down|stalled"):
            cl.read(64)
    finally:
        cl.close()


def test_cli_jack_loop_equals_the_session(fake, monkeypatch, capsys):
    """``das --live --jack`` at one hop a chunk, driven cycle by cycle in
    lockstep (each cycle only after the client wrote the previous chunk):
    cycle n + 1 plays chunk n, equal to a StreamingSession's output bit
    for bit, and no period is dropped."""
    hop, n = 128, 12
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal((3, n * hop))).astype(np.float32)
    written = threading.Semaphore(0)
    real_write = native.JackClient.write

    def write(self, data):
        got = real_write(self, data)
        written.release()
        return got

    monkeypatch.setattr(native.JackClient, "write", write)
    outs = []

    deadline = time.perf_counter() + 60

    def server():
        for k in range(n + 1):
            if k and not written.acquire(timeout=60):
                return
            block = x[:, k * hop:(k + 1) * hop] if k < n else \
                np.zeros((3, hop), np.float32)
            inter = np.ascontiguousarray(block.T)
            out = np.zeros(hop, dtype=np.float32)
            # the first cycle waits for the client's process callback
            while fake.fakejack_drive(_fp(inter), hop, 3, _fp(out)) != 0:
                if k or time.perf_counter() > deadline:
                    return
                time.sleep(0.001)
            outs.append(out)

    th = threading.Thread(target=server, daemon=True)
    th.start()
    rc = cli.main(["das", "--live", "--jack", "--array-config", AIRA3,
                   "--window-size", str(hop), "--live-chunk", "1",
                   "--max-chunks", str(n + 1), "--theta", "20",
                   "--device", "cpu"])
    th.join(timeout=60)
    assert rc == 0 and not th.is_alive() and len(outs) == n + 1
    sess = StreamingSession(get_model(
        "das", EngineConfig(window_size=hop), load_array_config(AIRA3),
        device="cpu"))
    ref = np.concatenate([sess.process(x[:, k * hop:(k + 1) * hop],
                                       20.0).numpy() for k in range(n)])
    np.testing.assert_array_equal(np.concatenate(outs[1:]), ref)
    import json
    rep = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rep["live"]["jack_xruns"] == 0
    assert rep["live"]["jack_connected_in"] == 3
    assert rep["live"]["chunks"] == n + 1


# ------------------------------------------------------------------- ALSA


def test_cli_alsa_without_a_device_exits_with_a_hint(capsys):
    """``--live --alsa-device`` where the PCM cannot be opened (no ALSA
    runtime, or no such device) exits 2 with the reason and the pipe-mode
    hint, before the model's warm-up."""
    rc = cli.main(["das", "--live", "--alsa-device", "hw:97,97",
                   "--live-channels", "2", "--device", "cpu"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "error: ALSA open('hw:97,97'" in err
    assert "hint:" in err and "pipe mode" in err
