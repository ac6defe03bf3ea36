"""Command-line interface of the port: ``beamform-tpu-torch
{das,mvdr,lcmv,gss,gsc,phase,mcra,phasempf,ref,read}``.

Counterpart of ``beamform_tpu/runtime/cli.py`` for the ported slice: the
offline and ``--stream`` paths of the ``das``, ``mvdr``, ``lcmv``, ``gss``,
``gsc``, ``phase``, ``mcra``, ``phasempf``, ``ref`` and ``read`` nodes,
WAV in and WAV out, with an xRT (audio-seconds per wall-second) report;
``mcra``, ``ref`` and ``read`` have no steering and ignore ``--theta``.
Node parameters start from the reference's launch preset and take
``--param KEY=VALUE`` overrides, as in the JAX CLI, which prints the
reference's line for each parameter at
``--log-level`` (warn-and-default lines at the default ``warning``). The
``gsc`` preset writes the reference's mu trace, to ``--mu-file`` (default
``~/mu_behavior.txt``, the reference's file). The
interference set of LCMV and GSS follows ``--interference-events`` (a
replayed /theta_interference message list) or, under ``--stream``,
``--interf-control`` (a polled file of messages); GSS sizes its demixing
state for the timeline's slot capacity. ``--device`` picks the torch
device (default ``cuda``, which must be present): unlike the JAX CLI,
where ``--device`` names the ALSA PCM of ``--live``. The ``write`` node,
the live runtimes, live steering and output resampling are not ported yet
and fail with a message that says so.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from beamform_tpu_torch.config import (EngineConfig, load_array_config,
                                       load_launch_params,
                                       load_rosjack_config,
                                       parse_array_config)
from beamform_tpu_torch.models import MODEL_REGISTRY, get_model
from beamform_tpu_torch.runtime import wav as wav_io
from beamform_tpu_torch.runtime.timeline import (MAX_INTERFERENCES,
                                                 InterferenceMachine,
                                                 InterferenceTimeline,
                                                 InterfEvent,
                                                 replay_interference_events)

# the JAX CLI's nodes; every one but those in MODEL_REGISTRY is not ported
NODES = ("das", "mvdr", "lcmv", "gss", "gsc", "phase", "mcra", "phasempf",
         "ref", "read", "write")
# JAX CLI flags of paths not ported yet (live runtimes, live steering)
UNPORTED_FLAGS = ("--live", "--jack", "--theta-control")
# the nodes that take an interference set
INTERF_NODES = ("lcmv", "gss")


def _parse_value(v: str):
    """A ``--param`` value: bool, int, float, else the string."""
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    for kind in (int, float):
        try:
            return kind(v)
        except ValueError:
            pass
    return v


def build_parser():
    p = argparse.ArgumentParser(
        prog="beamform-tpu-torch",
        description="Multichannel beamforming on PyTorch/CUDA (the port of "
                    "beamform-tpu)")
    p.add_argument("node", choices=NODES, help="beamformer / node to run")
    p.add_argument("--in", dest="input", required=True,
                   help="multichannel input WAV (one channel per mic)")
    p.add_argument("--out", dest="output", default=None,
                   help="output WAV path (default: rosjack write_file_path "
                        "or <in>.<node>.wav)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda); not the "
                        "JAX CLI's --device, which names the ALSA PCM of "
                        "--live")
    p.add_argument("--array-config", default=None,
                   help="beamform_config.yaml (mic geometry, initial angle)")
    p.add_argument("--rosjack-config", default=None,
                   help="rosjack_config.yaml (output path policy)")
    p.add_argument("--theta", type=float, default=None,
                   help="steering angle in degrees (default: config "
                        "initial_angle)")
    p.add_argument("--theta-timeline", default=None,
                   help="CSV/JSON file of per-frame angles, or "
                        "'t0:a0,t1:a1,...' second:angle change points")
    p.add_argument("--window-size", type=int, default=1024,
                   help="hop size in samples (JACK buffer size equivalent)")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32")
    p.add_argument("--param", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="node hyperparameter override (repeatable), e.g. "
                        "--param freq_max=16000")
    p.add_argument("--launch-preset", choices=("on", "off"), default="on",
                   help="start from the reference's launch/*.launch "
                        "per-node parameters (configs/launch_params.yaml), "
                        "then apply --param overrides; 'off' starts from "
                        "the in-code node defaults instead (default: on)")
    p.add_argument("--log-level", choices=("debug", "info", "warning",
                                           "error"), default="warning",
                   help="console log level (the reference's per-parameter "
                        "INFO/WARN lines)")
    p.add_argument("--mu-file", default=None, metavar="PATH",
                   help="gsc with write_mu: the mu trace file (default "
                        "~/mu_behavior.txt)")
    p.add_argument("--out-format", choices=("pcm16", "pcm24", "pcm32",
                                            "float32"), default="pcm16")
    p.add_argument("--report-json", action="store_true",
                   help="print a one-line JSON run report to stdout")
    p.add_argument("--stream", type=int, default=None, metavar="FRAMES",
                   help="process in streaming chunks of FRAMES hops instead "
                        "of one call")
    p.add_argument("--save-state", default=None,
                   help="checkpoint the streaming state to this .npz at end")
    p.add_argument("--load-state", default=None,
                   help="resume streaming state from a .npz checkpoint")
    p.add_argument("--interference-events", default=None,
                   help="LCMV interference timeline: 'sec:id:angle,...' "
                        "/theta_interference messages replayed over the "
                        "config's interference angles")
    p.add_argument("--interf-control", default=None, metavar="PATH",
                   help="with --stream: a file of appended 'id:angle' "
                        "/theta_interference messages, polled at each "
                        "chunk")
    for flag in UNPORTED_FLAGS:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def theta_from_spec(spec: str, num_frames: int, hop: int, fs: int,
                    initial: float) -> np.ndarray:
    """Change-point spec 'sec:angle,...' (or a .json/.csv file of per-frame
    angles) -> per-frame timeline."""
    th = np.full(num_frames, initial, dtype=np.float64)
    if spec.endswith((".json", ".csv")):
        if spec.endswith(".json"):
            with open(spec) as f:
                vals = np.asarray(json.load(f), dtype=np.float64).ravel()
        else:
            vals = np.loadtxt(spec, delimiter=",", dtype=np.float64).ravel()
        if len(vals) == 0:
            return th
        if len(vals) > num_frames:   # longer file: extra angles are unused
            print(f"note: theta timeline has {len(vals)} frames, stream has "
                  f"{num_frames}; ignoring the tail", file=sys.stderr)
            return vals[:num_frames]
        if len(vals) < num_frames:   # shorter file: last angle holds
            vals = np.concatenate(
                [vals, np.full(num_frames - len(vals), vals[-1])])
        return vals
    for item in spec.split(","):
        t_s, a = item.split(":")
        frame = int(float(t_s) * fs / hop)
        th[min(frame, num_frames - 1):] = float(a)
    return th


class InterfControlFile:
    """Live /theta_interference side channel: a file where each appended
    ``id:angle`` line is one InterfTheta message. Polled at chunk
    boundaries; lines already consumed are skipped (the file is
    append-only, like a topic log). Malformed lines are ignored with a
    warning, consuming them."""

    def __init__(self, path: str, machine: InterferenceMachine):
        self.path = path
        self.machine = machine
        self._consumed = 0

    def poll(self) -> bool:
        """Apply newly appended messages; True when any triggered
        update_weights."""
        try:
            with open(self.path) as f:
                lines = [ln.strip() for ln in f.read().splitlines()
                         if ln.strip()]
        except OSError:
            return False
        new, self._consumed = lines[self._consumed:], len(lines)
        any_reset = False
        for ln in new:
            try:
                iid, ang = ln.split(":")
                any_reset |= self.machine.apply(int(iid), float(ang))
            except ValueError:
                print(f"warning: ignoring malformed interference-control "
                      f"line {ln!r} (want 'id:angle')", file=sys.stderr)
        return any_reset


def interference_from_spec(spec: str, num_frames: int, hop: int, fs: int,
                           initial, threshold: float) -> InterferenceTimeline:
    """'sec:id:angle,...' -> the replayed timeline at capacity
    ``MAX_INTERFERENCES``, as the JAX CLI builds it."""
    events = []
    for item in spec.split(","):
        t_s, iid, a = item.split(":")
        events.append(InterfEvent(frame=int(float(t_s) * fs / hop),
                                  id=int(iid), angle=float(a)))
    return replay_interference_events(num_frames, list(initial), events,
                                      threshold=threshold,
                                      capacity=MAX_INTERFERENCES)


def _chunk_rows(tl: InterferenceTimeline, f0: int, n: int):
    """Rows f0 .. f0+n of a timeline; a padded tail holds the last row."""
    def rows(a):
        r = a[f0:f0 + n]
        if len(r) < n:
            r = np.concatenate([r, np.repeat(r[-1:], n - len(r), axis=0)])
        return r
    return InterferenceTimeline(rows(tl.angles), rows(tl.active),
                                rows(tl.row0), rows(tl.reset))


def _node_params(args) -> dict:
    """Launch preset (on by default) overlaid with --param overrides."""
    params = (load_launch_params(args.node)
              if args.launch_preset == "on" else {})
    for kv in args.param:
        k, sep, v = kv.partition("=")
        if not sep:
            raise ValueError(f"--param {kv!r} is not KEY=VALUE")
        params[k] = _parse_value(v)
    return params


def _not_ported(args):
    """The reason this run asks for something not ported yet, or None."""
    if args.node not in MODEL_REGISTRY:
        return f"node {args.node!r}"
    for flag in UNPORTED_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            return flag
    return None


def _run_stream(model, x, theta, args, hop, interference=None,
                interf_ctrl=None):
    from beamform_tpu_torch.runtime.streaming import StreamingSession
    sess = StreamingSession(model)
    if args.load_state:
        sess.load(args.load_state)
    chunk = args.stream * hop
    xp = np.pad(x, ((0, 0), (0, (-x.shape[1]) % chunk)))
    outs = []
    for i in range(0, xp.shape[1], chunk):
        th = theta
        f0 = i // hop
        if isinstance(theta, np.ndarray):
            th = theta[f0:f0 + args.stream]
            if len(th) == 0:         # trailing padded chunk: theta holds
                th = float(theta[-1])
        tl = None
        if interf_ctrl is not None:
            reset = interf_ctrl.poll()
            tl = interf_ctrl.machine.rows(args.stream, reset_first=reset)
        elif interference is not None:
            tl = _chunk_rows(interference, f0, args.stream)
        outs.append(sess.process(xp[:, i:i + chunk], th,
                                 interference=tl).cpu().numpy())
    if args.save_state:
        sess.save(args.save_state)
    return np.concatenate(outs)[:x.shape[1] + (-x.shape[1]) % hop]


def _attach_log_handler(level: str):
    """Reference-style console logging on stderr, as the JAX CLI attaches
    it to ``beamform_tpu``: ``make_params`` logs each node parameter on
    ``beamform_tpu_torch.config`` (INFO when given, WARN with the default
    when absent, mvdr.cpp:150-186). Scoped to the package's logger, and
    idempotent across repeated in-process calls: a handler a previous call
    attached is replaced."""
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("[%(levelname)s] [%(name)s]: %(message)s"))
    pkg_log = logging.getLogger("beamform_tpu_torch")
    for h in [h for h in pkg_log.handlers
              if isinstance(h, logging.StreamHandler)
              and not isinstance(h, logging.NullHandler)]:
        pkg_log.removeHandler(h)
    pkg_log.addHandler(handler)
    pkg_log.setLevel(getattr(logging, level.upper()))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _attach_log_handler(args.log_level)
    missing = _not_ported(args)
    if missing:
        print(f"error: {missing} is not ported to beamform_tpu_torch yet "
              "(see ROADMAP.md §1); use beamform-tpu", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")

    x, fs = wav_io.read_wav(args.input)
    if args.array_config:
        array_cfg = load_array_config(args.array_config)
    else:
        # no geometry given: co-located mics, one per input channel
        array_cfg = parse_array_config(
            {f"mic{i}": {"id": i, "x": 0.0, "y": 0.0}
             for i in range(x.shape[0])})
        print(f"note: no --array-config; assuming {x.shape[0]} co-located "
              "mics (no steering)", file=sys.stderr)
    rosjack = (load_rosjack_config(args.rosjack_config)
               if args.rosjack_config else None)
    if rosjack and rosjack.ros_output_sample_rate not in (None, fs):
        print("error: output resampling (ros_output_sample_rate) is not "
              "ported to beamform_tpu_torch yet (see ROADMAP.md §1)",
              file=sys.stderr)
        return 2
    engine = EngineConfig(sample_rate=fs, window_size=args.window_size,
                          dtype=args.dtype)
    if array_cfg.num_mics not in (0, x.shape[0]):
        print(f"note: config has {array_cfg.num_mics} mics, input has "
              f"{x.shape[0]} channels; using the first "
              f"{min(array_cfg.num_mics, x.shape[0])}", file=sys.stderr)
        x = x[:array_cfg.num_mics]

    theta = args.theta if args.theta is not None else array_cfg.initial_angle
    num_frames = -(-x.shape[1] // engine.hop)
    if args.theta_timeline:
        theta = theta_from_spec(args.theta_timeline, num_frames, engine.hop,
                                fs, float(theta))

    params = _node_params(args)
    model = get_model(args.node, engine, array_cfg, params, device=device)
    if args.mu_file and hasattr(model, "mu_file_path"):
        model.mu_file_path = args.mu_file
    thresh = float(params.get("interf_angle_threshold", 5.0))
    interference = interf_ctrl = None
    if args.interference_events:
        if args.node not in INTERF_NODES:
            print("error: --interference-events only applies to lcmv/gss",
                  file=sys.stderr)
            return 2
        interference = interference_from_spec(
            args.interference_events, num_frames, engine.hop, fs,
            array_cfg.interference_angles, thresh)
    if args.interf_control:
        if args.node not in INTERF_NODES:
            print("error: --interf-control only applies to lcmv/gss",
                  file=sys.stderr)
            return 2
        if args.interference_events:
            print("error: --interf-control and --interference-events are "
                  "mutually exclusive (one live channel, one offline "
                  "replay)", file=sys.stderr)
            return 2
        if not args.stream:
            print("error: --interf-control needs --stream or --live "
                  "(chunk boundaries are the polling points)",
                  file=sys.stderr)
            return 2
        interf_ctrl = InterfControlFile(
            args.interf_control,
            InterferenceMachine(list(array_cfg.interference_angles),
                                threshold=thresh,
                                capacity=MAX_INTERFERENCES))

    if hasattr(model, "capacity"):
        # size the demixing state (gss) for the timeline's slot capacity
        # before stream_init runs, as the JAX CLI does
        if interf_ctrl is not None:
            model.capacity = MAX_INTERFERENCES
        elif interference is not None:
            model.capacity = interference.capacity

    t0 = time.perf_counter()
    if args.stream:
        y = _run_stream(model, x, theta, args, engine.hop, interference,
                        interf_ctrl)
    elif interference is not None:
        y = model.process(x, theta, interference=interference).cpu().numpy()
    else:
        y = model.process(x, theta).cpu().numpy()
    wall = time.perf_counter() - t0
    audio_sec = x.shape[1] / fs
    xrt = audio_sec / wall if wall > 0 else float("inf")

    nonfinite = int(np.sum(~np.isfinite(y)))
    if nonfinite:
        # the reference writes whatever Eigen produced on singular
        # covariances; as the JAX CLI, zero it at the file boundary
        print(f"warning: {nonfinite} non-finite output samples zeroed "
              "(singular covariance history? raise freq_mag_threshold or "
              "start with a quieter lead-in)", file=sys.stderr)
        y = np.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)

    out_path = args.output
    if out_path is None and rosjack and rosjack.write_file_path:
        out_path = rosjack.write_file_path
    if out_path is None:
        out_path = args.input + f".{args.node}.wav"
    wav_io.write_wav(out_path, y, fs, fmt=args.out_format)

    clip = int(np.sum(np.abs(y) >= 1.0))
    if clip:
        print(f"warning: {clip} output samples out of [-1,1] range",
              file=sys.stderr)
    report = {
        "node": args.node, "input": args.input, "output": out_path,
        "device": str(device), "mics": int(x.shape[0]),
        "samples": int(x.shape[1]), "sample_rate": fs,
        "wall_s": round(wall, 4), "xrt": round(xrt, 2),
        "clipped_samples": clip,
    }
    if args.report_json:
        print(json.dumps(report))
    else:
        print(f"{args.node}: {audio_sec:.2f}s audio in {wall:.3f}s "
              f"({xrt:.1f}x real-time, {device}) -> {out_path}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
