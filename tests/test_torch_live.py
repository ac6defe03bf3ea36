"""The port's live serving path against the JAX package: output resampling,
the write node's decoupling ring, the run monitor, the ``--live`` pipe
(with ``--theta-control``, the ``drop`` overrun policy and
``--interf-control``), the ``write`` node's file and live modes, resampled
CLI output and ``--theta-control`` under ``--stream``.

Inputs are seeded numpy arrays fed to both packages. Every port subprocess
runs from the repository root with ``PYTHONPATH`` set to it and
``--device cpu``.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from beamform_tpu.config import EngineConfig as JEngine
from beamform_tpu.config import load_launch_params as jlaunch
from beamform_tpu.config import parse_array_config as jparse
from beamform_tpu.models import get_model as jget_model
from beamform_tpu.runtime import playback as jplay
from beamform_tpu.runtime.cli import build_parser as jax_parser
from beamform_tpu.runtime.cli import run_live as jax_run_live
from beamform_tpu.runtime.resample import resample as jresample
from beamform_tpu.runtime.timeline import InterferenceMachine as JMachine
from beamform_tpu.runtime.timeline import MAX_INTERFERENCES
from beamform_tpu.utils.profiling import RealTimeMonitor as JMonitor
from beamform_tpu_torch import run_offline
from beamform_tpu_torch.config import (EngineConfig, load_array_config,
                                       parse_array_config)
from beamform_tpu_torch.models import get_model
from beamform_tpu_torch.runtime import cli, playback, wav
from beamform_tpu_torch.runtime.resample import resample
from beamform_tpu_torch.runtime.streaming import StreamingSession
from beamform_tpu_torch.utils.profiling import RealTimeMonitor, trace_to

from conftest import AIRA3, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT)
FS = 48000
RESAMPLE_REL = 1e-5      # of peak, the port's resample vs the JAX one
LIVE_ATOL = 2e-7         # live pipe vs the JAX model's chunks


def _cli(*args):
    return [sys.executable, "-m", "beamform_tpu_torch.runtime.cli", *args,
            "--device", "cpu"]


def _array_doc(interf=(), xy=AIRA3):
    doc = {f"mic{i}": {"id": i, "x": x, "y": y}
           for i, (x, y) in enumerate(xy)}
    doc.update({f"angle_interf{k + 1}": a for k, a in enumerate(interf)})
    return doc


# --------------------------------------------------------------- resample


@pytest.mark.parametrize("fs_in,fs_out", [(48000, 16000), (16000, 48000),
                                          (48000, 44100), (44100, 48000)])
def test_resample_matches_jax(fs_in, fs_out):
    x = (0.3 * np.random.default_rng(0).standard_normal((3, 9601))
         ).astype(np.float32)
    ref = np.asarray(jresample(x, fs_in, fs_out))
    got = resample(x, fs_in, fs_out, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert got.shape[-1] == -(-x.shape[-1] * fs_out // fs_in)
    assert np.abs(got.numpy() - ref).max() <= RESAMPLE_REL * np.abs(ref).max()


def test_resample_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        resample(np.zeros((1, 480), np.float32), 48000, 16000)


# ------------------------------------------------------ the write node ring


def _ring_state(buf):
    return (buf._buf.tobytes(), buf._w, buf._r, buf.pushed, buf.popped,
            getattr(buf, "overwrites", 0), getattr(buf, "underruns", 0))


@pytest.mark.parametrize("lead", [0, 3])
def test_play_stream_matches_jax(lead):
    wins = (0.1 * np.random.default_rng(1).standard_normal((30, 64))
            ).astype(np.float32)
    ref = jplay.play_stream(wins, 64, buffer_windows=8, consumer_lead=lead)
    got = playback.play_stream(wins, 64, buffer_windows=8,
                               consumer_lead=lead)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def test_ring_sequences_match_jax():
    """Overwrite (a producer a ring and more ahead), underrun (a consumer
    with nothing queued) and odd message sizes: the same samples out and
    the same cursors and counters, bit for bit."""
    rng = np.random.default_rng(2)
    a, b = jplay.Ros2JackBuffer(16, windows=4), playback.Ros2JackBuffer(
        16, windows=4)
    ops = ([("push", 16)] * 6 + [("pop", 16)] * 9 + [("push", 5),
                                                    ("pop", 16)] * 4
           + [("push", 23), ("push", 40), ("pop", 7), ("pop", 33)])
    for op, n in ops:
        if op == "push":
            m = rng.standard_normal(n).astype(np.float32)
            a.push(m)
            b.push(m)
        else:
            assert a.pop(n).tobytes() == b.pop(n).tobytes()
        assert _ring_state(a) == _ring_state(b)
    assert b.overwrites > 0 and b.underruns > 0


# ----------------------------------------------------------------- monitor


def test_monitor_reports_the_jax_keys(tmp_path):
    a, b = JMonitor(sample_rate=FS), RealTimeMonitor(sample_rate=FS)
    for mon in (a, b):
        mon.start_chunk()
        mon.end_chunk(FS)                  # 1 s of audio at once: no xrun
        mon.start_chunk()
        time.sleep(0.01)
        mon.end_chunk(48)                  # 1 ms of audio in 10 ms: xrun
    ra, rb = a.report(), b.report()
    assert list(rb) == list(ra)
    for k in ("chunks", "audio_seconds", "xruns"):
        assert rb[k] == ra[k]
    lat = b.latency_ms()
    assert set(lat) == {"median", "p99", "worst", "worst_at"}
    assert lat["worst"] >= 10.0 and lat["worst_at"] == 1
    b.write_xrun_count(str(tmp_path / "xruns.txt"))
    assert (tmp_path / "xruns.txt").read_text() == "1\n"
    with pytest.raises(RuntimeError):
        b.end_chunk(48)


def test_session_monitor_counts_chunks(tmp_path):
    model = get_model("das", EngineConfig(window_size=128),
                      parse_array_config(_array_doc()), device="cpu")
    sess = StreamingSession(model, monitor=True)
    x = 0.1 * np.random.default_rng(3).standard_normal((3, 4 * 128))
    with trace_to(str(tmp_path / "trace")):
        for _ in range(3):
            sess.process(x.astype(np.float32), 0.0)
    rep = sess.monitor.report()
    assert rep["chunks"] == 3 and rep["audio_seconds"] == round(
        3 * 4 * 128 / FS, 3)
    assert len(sess.monitor.chunk_walls) == 3
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert StreamingSession(model).monitor is None


# --------------------------------------------------------------- live pipe


def _lockstep(cmd, blocks, before_chunk=None, timeout=120):
    """Feed ``blocks`` ((chunk, C) float32) to ``cmd``'s stdin one at a
    time, reading each chunk's output before the next (the live loop is
    read -> poll controls -> process -> write); returns (output, stderr)."""
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            cwd=ROOT, env=ENV)
    out = b""
    try:
        for k, blk in enumerate(blocks):
            if before_chunk is not None:
                before_chunk(k)
            proc.stdin.write(np.ascontiguousarray(blk, "<f4").tobytes())
            proc.stdin.flush()
            out += proc.stdout.read(blk.shape[0] * 4)
        proc.stdin.close()
        err = proc.stderr.read().decode()
        proc.wait(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-1500:]
    return np.frombuffer(out, dtype="<f4"), err


def _report(err: str, key: str) -> dict:
    return json.loads([ln for ln in err.splitlines()
                       if ln.startswith("{")][-1])[key]


@pytest.mark.parametrize("node", ["das", "ref"])
def test_live_pipe_matches_jax_chunks(node, tmp_path):
    """``<node> --live`` with a mid-stream ``--theta-control`` change: the
    piped output equals the JAX model's process_chunk on the same chunks
    and angles (float64 compute, the float32 wire: two float32
    implementations round apart by more than LIVE_ATOL)."""
    hop, chunk_hops, ch = 256, 2, 3
    chunk = chunk_hops * hop
    rng = np.random.default_rng(4)
    blocks = [(0.1 * rng.standard_normal((chunk, ch))).astype("<f4")
              for _ in range(4)]
    thetas = [10.0, 10.0, -40.0, 75.0]
    ctl = tmp_path / "theta.ctl"
    ctl.write_text("10.0\n")
    y, err = _lockstep(
        _cli(node, "--live", "--live-channels", str(ch), "--array-config",
             str(_write_cfg(tmp_path)), "--window-size", str(hop),
             "--live-chunk", str(chunk_hops), "--theta", "10",
             "--dtype", "float64", "--theta-control", str(ctl)),
        blocks, lambda k: ctl.write_text(f"{thetas[k]}\n"))
    assert len(y) == len(blocks) * chunk
    model = jget_model(node, JEngine(sample_rate=FS, window_size=hop,
                                     dtype="float64"), jparse(_array_doc()),
                       {})
    state = model.stream_init()
    ref = []
    for blk, th in zip(blocks, thetas):
        out, state = model.process_chunk(blk.T, th, state)
        ref.append(np.asarray(out).astype(np.float32))
    np.testing.assert_allclose(y, np.concatenate(ref), rtol=0,
                               atol=LIVE_ATOL)
    rep = _report(err, "live")
    assert rep["chunks"] == len(blocks) and rep["device"] == "cpu"
    assert set(rep["chunk_ms"]) == {"median", "p99", "worst", "worst_at"}


def _run_live_in_process(run, argv, pcm: bytes, tmp_path, monkeypatch):
    """``run(args)`` with stdin a file holding ``pcm`` (all of it queued
    before the loop starts) and stdout captured; returns (rc, bytes)."""
    src = tmp_path / "stdin.pcm"
    src.write_bytes(pcm)
    out = io.BytesIO()
    with open(src, "rb") as f:
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(f))
        monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(out))
        rc = run(argv)
        sys.stdout.flush()
        data = out.getvalue()
    monkeypatch.undo()
    return rc, data


def test_live_drop_overrun_matches_jax(tmp_path, monkeypatch, capsys):
    """``--live-overrun drop`` with the whole input queued before the loop
    starts: output 1:1 with the input and the backlog shed, with the JAX
    CLI's counters."""
    hop, chunks = 128, 12
    x = (0.1 * np.random.default_rng(5).standard_normal(chunks * hop)
         ).astype("<f4")
    argv = ["ref", "--live", "--live-channels", "1", "--live-chunk", "1",
            "--window-size", str(hop), "--live-overrun", "drop"]
    got = {}
    for name, run in (("jax", lambda a: jax_run_live(
            jax_parser().parse_args(a))),
                      ("port", lambda a: cli.main(a + ["--device",
                                                       "cpu"]))):
        rc, data = _run_live_in_process(run, argv, x.tobytes(), tmp_path,
                                        monkeypatch)
        assert rc == 0
        y = np.frombuffer(data, dtype="<f4")
        assert y.shape == x.shape
        got[name] = (y, _report(capsys.readouterr().err, "live"))
    (yj, rj), (yp, rp) = got["jax"], got["port"]
    assert rp["dropped_chunks"] == rj["dropped_chunks"] == chunks - 2
    assert rp["xruns"] >= rp["dropped_chunks"]
    assert rp["chunks"] == rj["chunks"] == 2
    np.testing.assert_allclose(yp, yj, rtol=0, atol=LIVE_ATOL)


def _write_cfg(tmp_path, interf=(), xy=AIRA3):
    cfg = tmp_path / "array.yaml"
    lines = ["initial_angle: 0.0"] + [
        f"mic{i}: {{id: {i}, x: {x}, y: {y}}}" for i, (x, y) in
        enumerate(xy)] + [f"angle_interf{k + 1}: {a}"
                             for k, a in enumerate(interf)]
    cfg.write_text("\n".join(lines) + "\n")
    return cfg


def test_live_interf_control_matches_jax(tmp_path):
    """``lcmv --live --interf-control`` with add / move / proximity-remove
    messages appended mid-stream equals the JAX model run in-process on
    the same chunks, its interference rows from the JAX
    InterferenceMachine fed the same messages (float64 compute, the
    float32 wire). Four mics: after the first add the mic-0 constraint
    row is zero (the reference's row-0 quirk), so the target and two
    interferers need four for a regular inner matrix; on three, every
    package's output there is round-off."""
    hop, chunk_hops = 128, 2
    chunk = chunk_hops * hop
    xy = AIRA3 + [(0.12, 0.07)]
    x = make_scene(xy, seconds=0.25, quiet_hops=8, hop=hop)
    n_chunks = x.shape[1] // chunk
    x = np.ascontiguousarray(x[:, :n_chunks * chunk], dtype=np.float32)
    msgs = {2: "2:-45.0", 4: "2:-100.0", 6: "1:-98.0"}
    ctl = tmp_path / "interf.ctl"
    ctl.write_text("")
    params = {"past_windows": 6, "freq_mag_threshold": 0.0008,
              "interf_angle_threshold": 5.0}

    def append(k):
        if k in msgs:
            with open(ctl, "a") as f:
                f.write(msgs[k] + "\n")

    y, err = _lockstep(
        _cli("lcmv", "--live", "--live-channels", "4", "--window-size",
             str(hop), "--live-chunk", str(chunk_hops), "--theta", "20",
             "--dtype", "float64", "--array-config",
             str(_write_cfg(tmp_path, (60.0,), xy)), "--interf-control",
             str(ctl), *[f"--param={k}={v}" for k, v in params.items()]),
        [x[:, k * chunk:(k + 1) * chunk].T for k in range(n_chunks)],
        append)
    assert len(y) == n_chunks * chunk
    model = jget_model("lcmv", JEngine(sample_rate=FS, window_size=hop,
                                       dtype="float64"),
                       jparse(_array_doc((60.0,), xy)),
                       dict(jlaunch("lcmv"), **params))
    machine = JMachine([60.0], threshold=5.0, capacity=MAX_INTERFERENCES)
    state = model.stream_init()
    ref = []
    for k in range(n_chunks):
        reset = False
        if k in msgs:
            iid, ang = msgs[k].split(":")
            reset = machine.apply(int(iid), float(ang))
        out, state = model.process_chunk(
            x[:, k * chunk:(k + 1) * chunk], 20.0, state,
            interference=machine.rows(chunk_hops, reset_first=reset))
        ref.append(np.asarray(out).astype(np.float32))
    np.testing.assert_allclose(y, np.concatenate(ref), rtol=0,
                               atol=LIVE_ATOL)
    assert np.abs(y).max() > 1e-3


def test_live_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["das", "--live", "--live-channels", "2"])


# ---------------------------------------------------------- the write node


@pytest.mark.parametrize("lead", [0, 3])
def test_write_file_mode_matches_jax(lead, tmp_path):
    x = np.clip(0.1 * np.random.default_rng(6).standard_normal((1, 2000)),
                -1, 1).astype(np.float32)
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    assert cli.main(["write", "--in", src, "--out", dst, "--window-size",
                     "256", "--out-format", "float32", "--consumer-lead",
                     str(lead)]) == 0
    y, fs = wav.read_wav(dst)
    mono = np.pad(x[0], (0, (-x.shape[1]) % 256))
    ref = jplay.play_stream(mono.reshape(-1, 256), 256, consumer_lead=lead)
    assert fs == FS
    np.testing.assert_array_equal(y[0], ref)


def test_write_live_paces_at_wall_clock():
    """``write --live``: after a handshake (one window in, one out), a
    producer paced at the audio rate is drained over about the audio
    duration, in order, through the 50-window ring."""
    hop, fs, windows, prefill = 128, 8000, 64, 10
    period = hop / fs
    proc = subprocess.Popen(
        _cli("write", "--live", "--window-size", str(hop), "--live-rate",
             str(fs)), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=ROOT, env=ENV)

    def window(i):
        return np.full(hop, float(i + 1), dtype="<f4").tobytes()

    proc.stdin.write(window(0))
    proc.stdin.flush()
    first = proc.stdout.read(hop * 4)
    assert len(first) == hop * 4

    def producer():
        for i in range(1, windows):
            proc.stdin.write(window(i))
            proc.stdin.flush()
            if i >= prefill:
                time.sleep(period)
        proc.stdin.close()

    t = threading.Thread(target=producer, daemon=True)
    t0 = time.perf_counter()
    t.start()
    out = proc.stdout.read()
    elapsed = time.perf_counter() - t0
    t.join(timeout=30)
    proc.wait(timeout=30)
    assert not t.is_alive() and proc.returncode == 0
    y = np.frombuffer(first + out, dtype="<f4")
    assert len(y) >= windows * hop
    assert elapsed >= 0.7 * (windows - 1) * period
    vals = y[y != 0.0]
    assert len(vals) and (np.diff(vals) >= 0).all()
    missing = {float(i + 1) for i in range(windows)} - set(np.unique(vals))
    assert len(missing) <= 2, sorted(missing)
    assert "underruns" in _report(proc.stderr.read().decode(), "write")


def test_write_live_plays_what_arrives_after_an_underrun():
    """A producer that stalls past the ring's lead (the consumer plays
    silence, an underrun, and runs ahead) and then sends its last windows:
    they land behind the consumer's cursor, and the node still plays them
    after end of input (one more ring period), in order."""
    hop, fs, windows = 128, 8000, 12
    period = hop / fs
    proc = subprocess.Popen(
        _cli("write", "--live", "--window-size", str(hop), "--live-rate",
             str(fs)), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=ROOT, env=ENV)
    got = []
    reader = threading.Thread(target=lambda: got.append(proc.stdout.read()),
                              daemon=True)
    for i in range(windows):
        if i == windows - 4:
            time.sleep(16 * period)            # the consumer underruns
        proc.stdin.write(np.full(hop, float(i + 1), dtype="<f4").tobytes())
        proc.stdin.flush()
        if i == 0:                 # the child's loop runs: first out
            got.append(proc.stdout.read(hop * 4))
            reader.start()
    proc.stdin.close()
    reader.join(timeout=60)
    proc.wait(timeout=60)
    assert proc.returncode == 0 and len(got) == 2
    y = np.frombuffer(b"".join(got), dtype="<f4")
    vals = y[y != 0.0]
    assert (np.diff(vals) >= 0).all()
    assert set(np.unique(vals)) == {float(i + 1) for i in range(windows)}
    assert _report(proc.stderr.read().decode(), "write")["underruns"] > 0


# --------------------------------------------- the offline CLI's additions


def test_cli_resampled_output_matches_jax(tmp_path, capsys):
    """``ros_output_sample_rate: 16000``: the written file is the JAX
    resample of the port's output at the engine rate."""
    x = make_scene(AIRA3, seconds=0.1, hop=128).astype(np.float32)
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    rosjack = tmp_path / "rosjack.yaml"
    rosjack.write_text("ros_output_sample_rate: 16000\n")
    cfg = str(_write_cfg(tmp_path))
    assert cli.main(["das", "--in", src, "--out", dst, "--array-config",
                     cfg, "--window-size", "128", "--theta", "20",
                     "--rosjack-config", str(rosjack), "--out-format",
                     "float32", "--report-json", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rep["sample_rate"], rep["out_sample_rate"]) == (FS, 16000)
    got, fs = wav.read_wav(dst)
    y = run_offline("das", x, engine=EngineConfig(window_size=128),
                    array_cfg=load_array_config(cfg), theta=20.0,
                    device="cpu")
    ref = np.asarray(jresample(y, FS, 16000))
    assert fs == 16000 and got.shape == (1, len(ref))
    assert np.abs(got[0] - ref).max() <= RESAMPLE_REL * np.abs(ref).max()


def test_cli_stream_theta_control_overrides_the_timeline(tmp_path, capsys):
    """``--theta-control`` under ``--stream``: the control file's angle
    steers from the first chunk, over ``--theta-timeline``, and the
    streaming report comes with the run."""
    x = make_scene(AIRA3, seconds=0.1, hop=128).astype(np.float32)
    src = str(tmp_path / "in.wav")
    wav.write_wav(src, x, FS, fmt="float32")
    ctl = tmp_path / "theta.ctl"
    ctl.write_text("-40\n")
    common = ["das", "--in", src, "--array-config", str(_write_cfg(
        tmp_path)), "--window-size", "128", "--stream", "4",
        "--out-format", "float32", "--device", "cpu", "--report-json"]
    assert cli.main(common + ["--out", str(tmp_path / "a.wav"),
                              "--theta-timeline", "0.01:30",
                              "--theta-control", str(ctl)]) == 0
    assert "overrides --theta-timeline" in capsys.readouterr().err
    assert cli.main(common + ["--out", str(tmp_path / "b.wav"), "--theta",
                              "-40"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["streaming"]["chunks"] == -(-x.shape[1] // (4 * 128))
    a, _ = wav.read_wav(str(tmp_path / "a.wav"))
    b, _ = wav.read_wav(str(tmp_path / "b.wav"))
    np.testing.assert_array_equal(a, b)


def test_live_resumes_a_checkpoint(tmp_path, monkeypatch, capsys):
    """``--live --load-state``: the state saved by a ``--stream`` run of
    the first half carries the live run of the second half, equal to one
    ``--stream`` run of the whole bit for bit (the checkpoint is loaded
    after the warm-up chunk, which starts from a fresh state)."""
    hop, chunk_hops = 128, 2
    chunk = hop * chunk_hops
    x = make_scene(AIRA3, seconds=0.1, hop=hop).astype(np.float32)
    x = x[:, :x.shape[1] // (2 * chunk) * 2 * chunk]
    half = x.shape[1] // 2
    cfg = str(_write_cfg(tmp_path))
    common = ["--array-config", cfg, "--window-size", str(hop), "--theta",
              "20", "--device", "cpu"]
    whole, first = str(tmp_path / "whole.wav"), str(tmp_path / "first.wav")
    wav.write_wav(whole, x, FS, fmt="float32")
    wav.write_wav(first, x[:, :half], FS, fmt="float32")
    ckpt = str(tmp_path / "state.npz")
    for src, extra in ((whole, []), (first, ["--save-state", ckpt])):
        assert cli.main(["das", "--in", src, "--out", src + ".out.wav",
                         "--stream", str(chunk_hops), "--out-format",
                         "float32", *common, *extra]) == 0
    rc, data = _run_live_in_process(
        cli.main, ["das", "--live", "--live-channels", "3", "--live-chunk",
                   str(chunk_hops), "--load-state", ckpt, *common],
        np.ascontiguousarray(x[:, half:].T, dtype="<f4").tobytes(),
        tmp_path, monkeypatch)
    assert rc == 0
    ref, _ = wav.read_wav(whole + ".out.wav")
    np.testing.assert_array_equal(np.frombuffer(data, dtype="<f4"),
                                  ref[0, half:].astype(np.float32))
    assert _report(capsys.readouterr().err, "live")["chunks"] == \
        half // chunk
