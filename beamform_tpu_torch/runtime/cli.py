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
where ``--device`` names the ALSA PCM of ``--live``, which is
``--alsa-device`` here.

The live runtimes (the reference's JACK-client role, rosjack.cpp:98-157):
``--live`` reads raw interleaved float32 PCM from stdin and writes the
processed float32 PCM to stdout in chunks of ``--live-chunk`` hops, with
the ``block`` or ``drop`` overrun policy; ``--jack`` joins a JACK graph
at the server's rate; ``--alsa-device`` captures and plays through an ALSA
PCM. Each chunk's deadline miss counts as an xrun (rosjack.cpp:78-82), and
the run report (JSON on stderr) gives the per-chunk wall times. The
``/theta`` topic is ``--theta-control``, a file polled at every chunk
(live and ``--stream``). The ``write`` node plays a stream through the
reference's 50-window decoupling ring. ``ros_output_sample_rate`` in
``--rosjack-config`` resamples the output.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import select
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
from beamform_tpu_torch.runtime.resample import resample
from beamform_tpu_torch.runtime.streaming import StreamingSession
from beamform_tpu_torch.runtime.timeline import (MAX_INTERFERENCES,
                                                 InterferenceMachine,
                                                 InterferenceTimeline,
                                                 InterfEvent,
                                                 replay_interference_events)

# the beamforming nodes, and the playback node
NODES = tuple(MODEL_REGISTRY) + ("write",)
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
    p.add_argument("--in", dest="input", default=None,
                   help="multichannel input WAV (one channel per mic); "
                        "omit with --live")
    p.add_argument("--live", action="store_true",
                   help="live pipe mode (the JACK-client role): read raw "
                        "interleaved float32 PCM from stdin, write processed "
                        "float32 PCM to stdout, e.g. "
                        "arecord -f FLOAT_LE -c3 | beamform-tpu-torch das "
                        "--live --live-channels 3 | aplay -f FLOAT_LE")
    p.add_argument("--live-channels", type=int, default=None,
                   help="input channel count for --live (default: mic count "
                        "from the array config)")
    p.add_argument("--live-rate", type=int, default=48000,
                   help="sample rate for --live")
    p.add_argument("--live-overrun", choices=("block", "drop"),
                   default="block",
                   help="live-input overload policy: 'block' applies "
                        "backpressure through the pipe; 'drop' sheds "
                        "backlogged chunks like a JACK xrun (silence out, "
                        "counted in the report) and only processes the "
                        "freshest audio")
    p.add_argument("--live-chunk", type=int, default=4,
                   help="hops per processing chunk in --live mode (latency "
                        "vs throughput)")
    p.add_argument("--alsa-device", default=None,
                   help="with --live: capture/play through this ALSA PCM "
                        "(e.g. 'default', 'hw:0') in-process instead of "
                        "stdin/stdout pipes (rosjack.cpp:102-157,234-270); "
                        "the JAX CLI's --device. Fails with the reason when "
                        "the host has no sound stack")
    p.add_argument("--alsa-device-out", default=None,
                   help="separate ALSA PCM for playback (default: same as "
                        "--alsa-device)")
    p.add_argument("--jack", nargs="?", const="beamform_tpu", default=None,
                   metavar="CLIENT_NAME",
                   help="with --live: join an existing JACK graph as a "
                        "client under this name (default 'beamform_tpu'): "
                        "input_N/output ports, physical-port auto-connect, "
                        "engine at the server rate "
                        "(rosjack.cpp:98-157,234-270). Binds libjack at run "
                        "time; fails with the reason when no JACK server "
                        "exists")
    p.add_argument("--jack-no-autoconnect", action="store_true",
                   help="register JACK ports but do not auto-connect to the "
                        "physical capture/playback ports (the reference's "
                        "auto_connect:=false launch arg)")
    p.add_argument("--max-chunks", type=int, default=0, metavar="N",
                   help="stop the --jack/--alsa-device loop after N chunks "
                        "(0 = run until Ctrl-C)")
    p.add_argument("--out", dest="output", default=None,
                   help="output WAV path (default: rosjack write_file_path "
                        "or <in>.<node>.wav)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; the write "
                        "node runs no model); not the JAX CLI's --device, "
                        "which names the ALSA PCM of --live: that is "
                        "--alsa-device here")
    p.add_argument("--array-config", default=None,
                   help="beamform_config.yaml (mic geometry, initial angle)")
    p.add_argument("--rosjack-config", default=None,
                   help="rosjack_config.yaml (output path policy, "
                        "output sample rate)")
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
                   help="with --stream or --live: a file of appended "
                        "'id:angle' /theta_interference messages, polled at "
                        "each chunk")
    p.add_argument("--theta-control", default=None, metavar="PATH",
                   help="live steering side channel (the /theta topic, "
                        "das.cpp:94-99): a file polled at every chunk "
                        "boundary whose last line is the new angle in "
                        "degrees; works in --live and --stream modes. "
                        "Takes precedence over --theta-timeline from the "
                        "first chunk where the file provides an angle")
    p.add_argument("--consumer-lead", type=int, default=0, metavar="N",
                   help="write node: audio callbacks that fire before the "
                        "first message arrives (each plays one window of "
                        "silence, the decoupling lag, jack_write.cpp:7-10)")
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


def _read_theta(path: str):
    """Live /theta side channel: the last non-empty line of ``path`` is the
    steering angle in degrees (theta_roscallback, das.cpp:94-99). None when
    the file is absent, empty or unparsable: callers keep their current
    angle (and --theta-timeline keeps driving until the control file first
    provides a value)."""
    try:
        with open(path) as f:
            lines = [ln.strip() for ln in f.read().splitlines() if ln.strip()]
        if lines:
            return float(lines[-1])
    except (OSError, ValueError):
        pass
    return None


def _poll_theta(path: str, current: float) -> float:
    v = _read_theta(path)
    return current if v is None else v


def _colocated(channels: int):
    """No geometry given: co-located mics, one per input channel (zero
    delays, plain averaging)."""
    return parse_array_config({f"mic{i}": {"id": i, "x": 0.0, "y": 0.0}
                               for i in range(channels)})


def _interf_control(args, array_cfg, params):
    """The --interf-control side channel of an lcmv/gss run, or None; a
    str is the error that refuses the run."""
    if not args.interf_control:
        return None
    if args.node not in INTERF_NODES:
        return "--interf-control only applies to lcmv/gss"
    if args.interference_events:
        return ("--interf-control and --interference-events are mutually "
                "exclusive (one live channel, one offline replay)")
    thresh = float(params.get("interf_angle_threshold", 5.0))
    return InterfControlFile(
        args.interf_control,
        InterferenceMachine(list(array_cfg.interference_angles),
                            threshold=thresh, capacity=MAX_INTERFERENCES))


def _run_stream(sess, x, theta, args, hop, interference=None,
                interf_ctrl=None):
    if args.load_state:
        sess.load(args.load_state)
    chunk = args.stream * hop
    xp = np.pad(x, ((0, 0), (0, (-x.shape[1]) % chunk)))
    if args.theta_control and isinstance(theta, np.ndarray):
        print("note: --theta-control overrides --theta-timeline from the "
              "first chunk where the control file provides an angle",
              file=sys.stderr)
    live_theta = None
    outs = []
    for i in range(0, xp.shape[1], chunk):
        if args.theta_control:       # the /theta topic, polled per chunk
            v = _read_theta(args.theta_control)
            if v is not None:
                live_theta = v
        th = theta if live_theta is None else live_theta
        f0 = i // hop
        if live_theta is None and isinstance(theta, np.ndarray):
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


def run_write(args) -> int:
    """The rosjack_write playback node: play a processed stream through the
    reference's 50-window decoupling buffer (jack_write.cpp:7-10,
    rosjack.cpp:549-577). File mode replays message/callback pairs; --live
    decouples a stdin producer from a wall-clock-paced stdout consumer."""
    from beamform_tpu_torch.runtime.playback import Ros2JackBuffer, play_stream

    hop = args.window_size
    if args.live:
        import threading

        stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
        buf = Ros2JackBuffer(hop)
        lock = threading.Lock()
        eof = threading.Event()

        def producer():
            while True:
                raw = stdin.read(4 * hop)
                if not raw:
                    break
                msg = np.frombuffer(raw, dtype="<f4")
                with lock:
                    buf.push(msg)
            eof.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        period = hop / args.live_rate
        next_t = time.perf_counter()

        def play():
            nonlocal next_t
            next_t += period
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            with lock:
                out = buf.pop(hop)
            stdout.write(out.astype("<f4").tobytes())
            stdout.flush()

        while not (eof.is_set() and buf.popped >= buf.pushed):
            play()
        if getattr(buf, "underruns", 0):
            # a consumer that ran ahead of the producer left the messages
            # pushed after it behind its cursor: one more ring period
            # plays them (as play_stream drains after a consumer lead)
            for _ in range(buf.size // hop + 2):
                play()
        report = {"underruns": getattr(buf, "underruns", 0),
                  "overwrites": getattr(buf, "overwrites", 0)}
        print(json.dumps({"write": report}), file=sys.stderr)
        return 0

    if args.input is None:
        print("error: write needs --in (or --live)", file=sys.stderr)
        return 2
    x, fs = wav_io.read_wav(args.input)
    mono = x[0]                          # the jackaudio topic is mono
    mono = np.pad(mono, (0, (-len(mono)) % hop))
    y = play_stream(mono.reshape(-1, hop), hop,
                    consumer_lead=args.consumer_lead)
    out_path = args.output or (args.input + ".write.wav")
    try:
        wav_io.write_wav(out_path, y[None, :], fs, fmt=args.out_format)
    except OSError as e:
        print(f"warning: could not open '{out_path}' ({e}); continuing "
              "without file output", file=sys.stderr)
    if args.report_json:
        print(json.dumps({"node": "write", "samples_in": int(x.shape[-1]),
                          "samples_out": int(len(y)),
                          "consumer_lead": args.consumer_lead}))
    return 0


def run_live(args, device, stdin=None, stdout=None) -> int:
    """The live loop, the reference's JACK client (rosjack_create +
    jack_callback): chunks of ``--live-chunk`` hops from the JACK graph
    (``--jack``), an ALSA PCM (``--alsa-device``) or stdin (raw interleaved
    float32), beamformed on ``device`` and played back (mono float32).
    Every chunk's wall time, up to its output being ready on the device, is
    held to the audio it carries; a miss counts as an xrun
    (rosjack.cpp:78-82). The run report goes to stderr as one JSON line.
    ``stdin``/``stdout``: binary streams of the pipe mode (default the
    process's own); stdin must have a file descriptor."""
    from beamform_tpu_torch.runtime import native
    from beamform_tpu_torch.utils.profiling import RealTimeMonitor

    array_cfg = (load_array_config(args.array_config) if args.array_config
                 else _colocated(args.live_channels or 1))
    channels = args.live_channels or array_cfg.num_mics
    params = _node_params(args)
    interf_ctrl = _interf_control(args, array_cfg, params)
    if isinstance(interf_ctrl, str):
        print(f"error: {interf_ctrl}", file=sys.stderr)
        return 2
    if args.jack and args.alsa_device:
        print("error: --jack and --alsa-device are mutually exclusive",
              file=sys.stderr)
        return 2

    # JACK-graph mode joins the graph first: the engine runs at the
    # server's rate (rosjack.cpp:141-145)
    jack = None
    if args.jack:
        try:
            jack = native.JackClient(
                args.jack, channels=channels,
                auto_connect=not args.jack_no_autoconnect,
                connect_out=not args.jack_no_autoconnect)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            print("hint: no JACK server on this host; use --alsa-device for "
                  "ALSA or pipe mode (--live alone)", file=sys.stderr)
            return 2
        if not args.jack_no_autoconnect and jack.connected_in < channels:
            logging.getLogger(__name__).warning(
                "connected %d/%d JACK input ports; sticking with the ones "
                "that were connected (rosjack.cpp:245-249)",
                jack.connected_in, channels)
    fs = jack.sample_rate if jack is not None else args.live_rate
    engine = EngineConfig(sample_rate=fs, window_size=args.window_size,
                          dtype=args.dtype)
    model = get_model(args.node, engine, array_cfg, params, device=device)
    if interf_ctrl is not None and hasattr(model, "capacity"):
        model.capacity = MAX_INTERFERENCES       # gss demixing slots
    sess = StreamingSession(model, monitor=True)

    # the in-process audio device: opened before the warm-up, so that a
    # missing sound stack fails fast with its reason
    alsa_in = alsa_out = None
    if args.alsa_device:
        try:
            alsa_in = native.AlsaPcm(args.alsa_device, capture=True,
                                     channels=channels, rate=fs)
            alsa_out = native.AlsaPcm(args.alsa_device_out
                                      or args.alsa_device, capture=False,
                                      channels=1, rate=fs)
        except RuntimeError as e:
            if alsa_in is not None:
                alsa_in.close()
            print(f"error: {e}", file=sys.stderr)
            print("hint: no usable ALSA runtime/device on this host; use "
                  "pipe mode (--live without --alsa-device, e.g. through "
                  "arecord/aplay on a machine that has them)",
                  file=sys.stderr)
            return 2

    theta = args.theta if args.theta is not None else array_cfg.initial_angle
    chunk = args.live_chunk * engine.hop

    def rows():
        """This chunk's interference rows (the /theta_interference topic,
        polled per chunk), or None."""
        if interf_ctrl is None:
            return None
        reset = interf_ctrl.poll()
        return interf_ctrl.machine.rows(args.live_chunk, reset_first=reset)

    def step(block) -> np.ndarray:
        nonlocal theta
        if args.theta_control:       # the /theta topic, polled per chunk
            theta = _poll_theta(args.theta_control, theta)
        y = sess.process(block, theta, interference=rows())
        return y.cpu().numpy().astype(np.float32, copy=False)

    # one zero chunk first, its output fetched: the kernels' first-use
    # build and first launches and copies must not count as xruns; then a
    # fresh state and monitor
    warm = (None if interf_ctrl is None
            else interf_ctrl.machine.rows(args.live_chunk))
    sess.process(np.zeros((channels, chunk), np.float32), theta,
                 interference=warm).cpu()
    sess.state = model.stream_init()
    sess.frames_done = 0
    sess.monitor = RealTimeMonitor(fs)
    if args.load_state:
        sess.load(args.load_state)

    def finish(**extra) -> int:
        report = dict(sess.monitor.report(),
                      chunk_ms=sess.monitor.latency_ms(),
                      device=str(device), **extra)
        print(json.dumps({"live": report}), file=sys.stderr)
        return 0

    if jack is not None:
        # graph-paced: the server's RT callback fills and drains the SPSC
        # rings on its own clock; capture overruns are dropped periods
        # counted by the callback, playback underruns play silence
        chunks_done = 0
        try:
            while args.max_chunks <= 0 or chunks_done < args.max_chunks:
                jack.write(step(jack.read(chunk)))
                chunks_done += 1
        except KeyboardInterrupt:
            pass
        except RuntimeError as e:     # server shutdown / stalled graph
            print(f"error: {e}", file=sys.stderr)
        extra = dict(jack_xruns=jack.xruns,
                     jack_connected_in=jack.connected_in)
        jack.close()
        return finish(**extra)

    if alsa_in is not None:
        # device-paced: the hardware clock gives the real-time contract
        # (blocking readi); overruns are ALSA xruns, recovered and counted
        chunks_done = 0
        try:
            while args.max_chunks <= 0 or chunks_done < args.max_chunks:
                chunks_done += 1
                alsa_out.write(step(alsa_in.read(chunk)))
        except KeyboardInterrupt:
            pass
        extra = dict(alsa_xruns=alsa_in.xruns + alsa_out.xruns)
        alsa_in.close()
        alsa_out.close()
        return finish(**extra)

    # pipe mode: raw-fd input with an explicit backlog, so that the 'drop'
    # policy can shed load the way JACK does ("miss the deadline, lose the
    # period"): a pipe blocks instead, so when the consumer falls behind
    # every backlogged chunk but the newest is skipped, silence written in
    # its place and counted as an xrun
    stdin = stdin or sys.stdin.buffer
    stdout = stdout or sys.stdout.buffer
    fd = stdin.fileno()
    frame_bytes = 4 * channels
    chunk_bytes = chunk * frame_bytes
    pending = b""
    eof = False

    def read_chunk() -> bytes:
        nonlocal pending, eof
        while len(pending) < chunk_bytes and not eof:
            d = os.read(fd, chunk_bytes)
            if not d:
                eof = True
                break
            pending += d
        out = pending[:chunk_bytes]
        pending = pending[len(out):]
        return out

    def drain_backlog() -> int:
        """Pull everything already queued in the pipe; drop all complete
        backlogged chunks but the newest. Returns the drop count."""
        nonlocal pending, eof
        while not eof and select.select([fd], [], [], 0)[0]:
            d = os.read(fd, 1 << 20)
            if not d:
                eof = True
                break
            pending += d
        dropped = 0
        while len(pending) >= 2 * chunk_bytes:
            pending = pending[chunk_bytes:]
            dropped += 1
        return dropped

    total_dropped = 0
    silence = np.zeros(chunk, dtype="<f4").tobytes()
    while True:
        raw = read_chunk()
        if not raw:
            break
        n = len(raw) // frame_bytes
        block = np.frombuffer(raw[:n * frame_bytes], dtype="<f4")
        block = block.reshape(n, channels).T.copy()
        if n < chunk:
            block = np.pad(block, ((0, 0), (0, chunk - n)))
        stdout.write(step(block)[:n].astype("<f4").tobytes())
        if args.live_overrun == "drop":
            dropped = drain_backlog()
            if dropped:
                total_dropped += dropped
                sess.monitor.xruns += dropped
                stdout.write(silence * dropped)
        stdout.flush()
    return finish(dropped_chunks=total_dropped)


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
    if args.node == "write":
        return run_write(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if args.live or args.jack:   # a JACK client has no offline file path
        return run_live(args, device)
    if args.input is None:
        print("error: --in is required (or use --live)", file=sys.stderr)
        return 2

    x, fs = wav_io.read_wav(args.input)
    if args.array_config:
        array_cfg = load_array_config(args.array_config)
    else:
        array_cfg = _colocated(x.shape[0])
        print(f"note: no --array-config; assuming {x.shape[0]} co-located "
              "mics (no steering)", file=sys.stderr)
    rosjack = (load_rosjack_config(args.rosjack_config)
               if args.rosjack_config else None)
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
    interference = None
    if args.interference_events:
        if args.node not in INTERF_NODES:
            print("error: --interference-events only applies to lcmv/gss",
                  file=sys.stderr)
            return 2
        interference = interference_from_spec(
            args.interference_events, num_frames, engine.hop, fs,
            array_cfg.interference_angles,
            float(params.get("interf_angle_threshold", 5.0)))
    interf_ctrl = _interf_control(args, array_cfg, params)
    if isinstance(interf_ctrl, str):
        print(f"error: {interf_ctrl}", file=sys.stderr)
        return 2
    if interf_ctrl is not None and not args.stream:
        print("error: --interf-control needs --stream or --live (chunk "
              "boundaries are the polling points)", file=sys.stderr)
        return 2

    if hasattr(model, "capacity"):
        # size the demixing state (gss) for the timeline's slot capacity
        # before stream_init runs, as the JAX CLI does
        if interf_ctrl is not None:
            model.capacity = MAX_INTERFERENCES
        elif interference is not None:
            model.capacity = interference.capacity

    t0 = time.perf_counter()
    monitor = None
    if args.stream:
        sess = StreamingSession(model, monitor=True)
        y = _run_stream(sess, x, theta, args, engine.hop, interference,
                        interf_ctrl)
        monitor = sess.monitor
    else:
        y = model.process(x, theta, interference=interference).cpu().numpy()
    wall = time.perf_counter() - t0
    audio_sec = x.shape[1] / fs
    xrt = audio_sec / wall if wall > 0 else float("inf")

    out_fs = fs
    if rosjack and rosjack.ros_output_sample_rate not in (None, fs):
        out_fs = rosjack.ros_output_sample_rate
        y = resample(y, fs, out_fs, device=device).cpu().numpy()

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
    wav_io.write_wav(out_path, y, out_fs, fmt=args.out_format)

    clip = int(np.sum(np.abs(y) >= 1.0))
    if clip:
        print(f"warning: {clip} output samples out of [-1,1] range",
              file=sys.stderr)
    report = {
        "node": args.node, "input": args.input, "output": out_path,
        "device": str(device), "mics": int(x.shape[0]),
        "samples": int(x.shape[1]), "sample_rate": fs,
        "out_sample_rate": out_fs, "wall_s": round(wall, 4),
        "xrt": round(xrt, 2), "clipped_samples": clip,
    }
    if monitor is not None:
        report["streaming"] = monitor.report()
    if args.report_json:
        print(json.dumps(report))
    else:
        print(f"{args.node}: {audio_sec:.2f}s audio in {wall:.3f}s "
              f"({xrt:.1f}x real-time, {device}) -> {out_path}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
