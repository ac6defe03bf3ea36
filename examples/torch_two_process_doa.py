"""Two-process live composition on the PyTorch/CUDA port: a beamformer
process and a DOA refiner process.

The port's counterpart of ``examples/two_process_doa.py``. The reference
composes its closed loop as separate ROS nodes (launch/das.launch runs the
`das` node; scripts/energy2theta.py subscribes to its `jackaudio` topic and
publishes `/theta` back, das.cpp:109). Here the same graph is two OS
processes over the port's live transports:

    scene PCM --pipe--> [beamform_tpu_torch.runtime.cli das --live
                         --theta-control F]
                              |  beamformed mono PCM (the jackaudio topic)
                              v
                        [this file --role doa]
                              |  appends refined theta lines (the /theta
                              v  topic) to F, polled per chunk by process A
                              F

Process A is the port's CLI (raw interleaved float32 PCM in, mono float32
out, ``--theta-control`` polled at chunk boundaries). Process B feeds
every hop-sized output window to ``beamform_tpu_torch.doa.GradientDoa``
(the energy2theta.py transliteration) and appends each update to the
control file. The energy objective peaks at the true DOA, so theta climbs
from its wrong initial value toward the target while the audio flows.

Run: ``python examples/torch_two_process_doa.py [--device cpu]`` (the
beamformer runs on the CUDA card by default). No install is needed: the
script puts the repository root on ``sys.path`` and on its children's
``PYTHONPATH``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FS = 48000
HOP = 256
SECONDS = 10.0
TARGET = 20.0          # true source DOA
THETA0 = 10.0          # beamformer's (wrong) initial steering
MU = 100.0
NUM_WIN = 20


def doa_role(args) -> int:
    """Process B: beamformed mono PCM on stdin -> /theta lines to the
    control file, one GradientDoa step per hop window."""
    from beamform_tpu_torch.doa import GradientDoa

    doa = GradientDoa(theta=args.theta0, mu=args.mu, num_win=args.num_win,
                      vad_threshold=0.0, energy_mode="rms")
    stdin = sys.stdin.buffer
    win_bytes = 4 * args.hop
    pending = b""
    updates = 0
    last = doa.theta
    while True:
        d = stdin.read(win_bytes - len(pending))
        if not d:
            break
        pending += d
        if len(pending) < win_bytes:
            continue
        w = np.frombuffer(pending, dtype="<f4")
        pending = b""
        theta = doa.step(w)
        if theta != last:
            # append-only theta log: process A reads the last non-empty
            # line per chunk (the /theta topic semantics)
            with open(args.control, "a") as f:
                f.write(f"{theta:.4f}\n")
            last = theta
            updates += 1
    print(json.dumps({"theta0": args.theta0,
                      "theta_final": round(float(doa.theta), 2),
                      "updates": updates}))
    return 0


def synth_scene_pcm(seconds: float, seed: int = 0):
    """One band-limited source at TARGET hitting the 16-mic AIRA array
    with exact spectral delays; returns (config path, mics, interleaved
    float32 PCM bytes)."""
    from beamform_tpu_torch.config import load_array_config
    from beamform_tpu_torch.evaluation import synth_scene
    from beamform_tpu_torch.geometry import ArrayGeometry

    cfg_path = os.path.join(ROOT, "beamform_tpu_torch", "configs",
                            "aira16.yaml")
    geom = ArrayGeometry.from_config(load_array_config(cfg_path))
    rng = np.random.default_rng(seed)
    n = int(seconds * FS) // HOP * HOP
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1.0 / FS)
    spec *= (f > 200) & (f < 6000)
    src = np.fft.irfft(spec, n=n)
    src = 0.3 * src / np.std(src)
    scene = synth_scene(geom, [src], [TARGET], FS, noise_std=0.002,
                        delay="spectral")
    pcm = scene.mixture.T.astype("<f4").tobytes()   # frame-major interleave
    return cfg_path, geom.num_mics, pcm


def launch(args) -> int:
    """Spawn A (the beamformer CLI) and B (the DOA refiner), pipe A's
    output into B, feed the scene into A, report the steering
    trajectory."""
    control = args.control or os.path.join(
        tempfile.gettempdir(), f"theta_ctl_{os.getpid()}.txt")
    if os.path.exists(control):
        os.unlink(control)
    cfg_path, mics, pcm = synth_scene_pcm(args.seconds)

    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path
                                              if path else ""))
    a = subprocess.Popen(
        [sys.executable, "-m", "beamform_tpu_torch.runtime.cli", "das",
         "--live", "--live-channels", str(mics), "--window-size", str(HOP),
         "--array-config", cfg_path, "--theta", str(THETA0),
         "--theta-control", control, "--device", args.device],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env, cwd=ROOT)
    b = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--role", "doa",
         "--control", control, "--hop", str(HOP), "--theta0", str(THETA0),
         "--mu", str(MU), "--num-win", str(NUM_WIN)],
        stdin=a.stdout, stdout=subprocess.PIPE, env=env, cwd=ROOT)
    a.stdout.close()               # B owns the read end now

    def feed():
        step = 4 * HOP * 4 * mics  # one live chunk of interleaved frames
        try:
            for i in range(0, len(pcm), step):
                a.stdin.write(pcm[i:i + step])
            a.stdin.close()
        except BrokenPipeError:
            pass

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    # A's stderr (its parameter lines and run report) is drained beside B
    err = []
    drain = threading.Thread(target=lambda: err.append(a.stderr.read()),
                             daemon=True)
    drain.start()
    out_b, _ = b.communicate(timeout=args.timeout)
    a.wait(timeout=30)
    t.join(timeout=10)
    drain.join(timeout=10)
    if a.returncode:
        sys.stderr.write(b"".join(err).decode(errors="replace")[-2000:])
        return a.returncode
    rep = json.loads(out_b.decode().strip().splitlines()[-1])
    with open(control) as f:
        timeline = [float(x) for x in f.read().split()]
    rep["target"] = TARGET
    rep["control_lines"] = len(timeline)
    print(json.dumps(rep))
    err_deg = (abs(rep["theta_final"] - TARGET), abs(THETA0 - TARGET))
    print(f"steered {THETA0:+.0f}° -> {rep['theta_final']:+.1f}° "
          f"(target {TARGET:+.0f}°): |error| {err_deg[1]:.0f}° -> "
          f"{err_deg[0]:.1f}° over {rep['updates']} /theta updates")
    return 0 if err_deg[0] < err_deg[1] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=("launch", "doa"), default="launch")
    ap.add_argument("--control", default=None)
    ap.add_argument("--hop", type=int, default=HOP)
    ap.add_argument("--theta0", type=float, default=THETA0)
    ap.add_argument("--mu", type=float, default=MU)
    ap.add_argument("--num-win", type=int, default=NUM_WIN)
    ap.add_argument("--seconds", type=float, default=SECONDS)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the beamformer process")
    args = ap.parse_args(argv)
    if args.role == "doa":
        if not args.control:
            print("--role doa needs --control", file=sys.stderr)
            return 2
        return doa_role(args)
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
