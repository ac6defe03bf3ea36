#!/usr/bin/env python3
"""One run of one cell of the port's benchmark on one NVIDIA H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness finds everything by name (``portbench/__init__.py``). A run:

1. set-up: makes the cell's input ring on the card from the seed, builds
   ``beamform_tpu_torch.runtime.batch.BatchRunner`` and runs the stream's
   first chunks through it, which builds or loads the kernel library and
   warms every shape of the cell (``setup_s``: the process's start to
   the first timed chunk);
2. the window: for ``--seconds``, a closed loop with one chunk in flight:
   ``process`` of the next chunk of all streams, then the copy of its
   output into a page-locked host buffer (``HostBuffers``); the carried
   state runs on from chunk to chunk;
3. the cell's end-to-end metrics, or with ``--trace 1`` (the window under
   ``torch.profiler``) its per-layer metrics, each read by a reader of its
   own (``metrics/<name>.py``) from the run's clock, spans and trace;
4. the check: the plain float64 reference (``reference/<node>.py``) works
   out again the outputs of a sample of chunks drawn from the seed (pairs
   of consecutive chunks, and the stream's first pair) and the widest gap
   is held to the cell's limit (``limits/<cell>.json``).

The last line of standard output is the result's JSON; the numbers
compared, each with its limit, are the last lines of standard error.
Without a card, or with fewer cards than the cell asks for, the run exits
1 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import yardstick  # noqa: E402
from portbench.generator import make_ring, talker_thetas  # noqa: E402
from portbench.reference import lanes as lanes_mod  # noqa: E402
from portbench.reference.common import Precision, gate_counts  # noqa: E402

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "beamform_tpu")
#: chunks run in set-up: the stream's first pair (checked from the
#: reference's own start) and one more
WARM_CHUNKS = 3
#: pairs of consecutive window chunks the check samples
SAMPLE_PAIRS = 4


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """The loaded modules' top-level names, compared whole, that are
    JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def load_cell(name: str, bench: Path = HERE) -> dict:
    """Everything a cell names, found by name: its entry, its
    configuration's file, its traffic mix, its limits and the metrics it
    reports; ``bench`` is the benchmark's folder, beside
    ``BENCHMARK.json``."""
    root = bench.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(
        cell=cell,
        cfg=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((bench / "traffic"
                        / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if listed(m)],
        per_layer=[m for m in spec["per_layer"] if listed(m)],
        bench=bench)


def load_file(path: Path):
    """A module from its file (metric names need not be identifiers)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class PairSampler:
    """A sample of the window's chunks drawn from the seed (reservoir
    sampling, so every finished chunk is equally likely whatever the
    window holds): for each, the program's state before it and the host
    outputs of it and of the chunk after it."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, np.random.default_rng(seed)
        self.n, self.entries, self._open = 0, [], None

    def offer(self, k: int, state_before, y_host):
        """Takes chunk ``k`` into the sample or not; returns the host
        buffers the sample no longer holds."""
        held_before = self.held()
        if self._open is not None:
            self._open["y"].append(y_host)
            self._open = None
        self.n += 1
        slot = (len(self.entries) if len(self.entries) < self.size
                else int(self.rng.integers(self.n)))
        if slot < self.size:
            entry = {"k": k, "state": state_before, "y": [y_host]}
            if slot == len(self.entries):
                self.entries.append(entry)
            else:
                self.entries[slot] = entry
            self._open = entry
        held = self.held()
        return [buf for i, buf in held_before.items() if i not in held] + (
            [] if id(y_host) in held or id(y_host) in held_before
            else [y_host])

    def held(self) -> dict:
        return {id(y): y for e in self.entries for y in e["y"]}


class HostBuffers:
    """Page-locked host buffers that the window's outputs are copied into,
    all allocated at set-up: one for the chunk in flight and one for each
    output the sample may hold, so the window allocates no host memory.
    (A ``.cpu()`` into fresh pageable memory a chunk spreads the chunk
    time by up to 2x between processes on the same card, from the host's
    page handling, not the program's work.)"""

    def __init__(self, shape, count: int, dtype, pin: bool):
        self.free = [torch.empty(shape, dtype=dtype, pin_memory=pin)
                     for _ in range(count)]

    def take(self) -> torch.Tensor:
        return self.free.pop()

    def give(self, bufs):
        self.free.extend(bufs)


class RunData:
    """What a metric's reader (``metrics/<name>.py``) reads: the cell's
    shapes, the set-up time, the window's chunks and host spans, the trace
    of a traced run (else None), and the work of the window's chunks by
    layer (``work/<layer>.py``)."""

    def __init__(self, c: dict, engine, chunks: int, first: int,
                 setup_s: float, window_s: float, chunk_ms, enqueue_ms,
                 trace, kind: str, pairs_by_slot, nib: int):
        self.cfg, self.mix, self.bench = c["cfg"], c["mix"], c["bench"]
        self.setup_s = setup_s
        self.node = self.cfg["node"]
        self.hop = engine.hop
        self.b, self.t = self.mix["streams"], self.mix["chunk_hops"]
        self.m = len([k for k in self.cfg["array"] if k.startswith("mic")])
        self.nib, self.chunks, self.first = nib, chunks, first
        self.window_s, self.chunk_ms, self.enqueue_ms = (window_s, chunk_ms,
                                                         enqueue_ms)
        self.trace, self.kind = trace, kind
        self.pairs_by_slot = pairs_by_slot
        self.audio_s = chunks * self.b * self.t * self.hop / engine.sample_rate
        self.log = log

    def window_work(self, layer: str):
        """(bytes, operations) of ``layer`` summed over the window's chunks,
        or None where the layer is not on this cell's path."""
        path = self.bench / "work" / f"{layer}.py"
        if not path.exists():
            return None
        mod = load_file(path)
        slots = len(self.pairs_by_slot)
        total = [0.0, 0.0]
        for k in range(self.first, self.first + self.chunks):
            w = mod.chunk_work(self, self.pairs_by_slot[k % slots])
            if w is None:
                return None
            total[0] += w[0]
            total[1] += w[1]
        return tuple(total)

    def least_seconds(self, nbytes: float, flops: float):
        return yardstick.least_seconds(self.kind, nbytes, flops)


def card_line() -> str:
    """``name, power.limit, clocks.sm`` of the first card by nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0",
             "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def stream_gaps(y_prog: np.ndarray, y_ref: np.ndarray) -> np.ndarray:
    """Per stream: max |program - reference| over the reference's peak;
    inf where the program is not finite where the reference is (or the
    other way)."""
    out = np.empty(len(y_ref))
    for b, (p, r) in enumerate(zip(y_prog, y_ref)):
        fin = np.isfinite(r)
        if (np.isfinite(p) != fin).any() or not fin.any():
            out[b] = np.inf
            continue
        peak = np.abs(r[fin]).max()
        out[b] = np.abs(p[fin] - r[fin]).max() / peak if peak else np.inf
    return out


def check(ref, ring, entries):
    """The widest gap of each sampled chunk, each entry a chunk and the
    one after it: the first from the program's state before it (the
    reference's own at the stream's start), the second on the reference's
    own state."""
    gaps_all, near, other = [], 0, 0
    for e in sorted(entries, key=lambda e: e["k"]):
        st = ref.start(e["k"], e["state"])
        for j, y in enumerate(e["y"]):
            k = e["k"] + j
            y_ref, lanes, finish = ref.chunk(
                ring.before(k, ref.pre_hops), ring.chunk(k), st)
            y_prog = y.double().numpy()
            chosen = lanes_mod.choose(lanes, y_prog, y_ref)
            st = finish(chosen)
            gaps = stream_gaps(y_prog, y_ref)
            near += len(lanes)
            other += sum(v != 0 for v in chosen)
            log(f"check: chunk {k}: out_gap {gaps.max():.6e} (stream "
                f"{int(gaps.argmax())}), {len(lanes)} near-threshold lanes, "
                f"{sum(v != 0 for v in chosen)} on the other branch")
            gaps_all.append(float(gaps.max()))
    log(f"check: {near} near-threshold lanes in all, {other} took the "
        "other branch")
    return gaps_all


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", overrides=None, serve=None, t_start=None,
             bench: Path = HERE):
    """One run of cell ``name``; returns the result's dict (the last line).

    ``overrides`` merges into the configuration and the mix ({"cfg": ...,
    "mix": ...}: the tests' small sizes); ``serve(cfg, thetas, hop, fs,
    device)`` builds what stands in the program's place (the control, or a
    fault), with ``process`` and ``state`` as ``BatchRunner`` has them."""
    t_start = T_START if t_start is None else t_start
    c = load_cell(name, bench=bench)
    for key, extra in (overrides or {}).items():
        c[key] = _merge(c[key], extra)
    cfg, mix = c["cfg"], c["mix"]
    from beamform_tpu_torch.config import EngineConfig, parse_array_config
    from beamform_tpu_torch.runtime.batch import BatchRunner
    ref_mod = importlib.import_module(f"portbench.reference.{cfg['node']}")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded at set-up: {', '.join(found)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    engine = EngineConfig(**{k: cfg["engine"][k] for k in
                             ("sample_rate", "window_size", "dtype")})
    hop, fs = engine.hop, engine.sample_rate
    b = mix["streams"]
    thetas = talker_thetas(cfg, b)
    ring = make_ring(cfg, mix, seed, hop, fs, dev)
    array_doc = dict(cfg["array"])
    for i, a in enumerate(cfg.get("interference_angles", [])):
        array_doc[f"angle_interf{i + 1}"] = a
    if serve is None:
        runner = BatchRunner(cfg["node"], engine,
                             parse_array_config(array_doc),
                             dict(cfg["params"]), batch=b, device=dev)
    else:
        runner = serve(cfg, thetas, hop, fs, dev)

    host = HostBuffers((b, mix["chunk_hops"] * hop), 2 * SAMPLE_PAIRS + 2,
                       getattr(torch, engine.dtype), dev.type == "cuda")
    start = {"k": 0, "state": runner.state, "y": []}
    for k in range(WARM_CHUNKS):
        buf = host.take()
        buf.copy_(runner.process(ring.chunk(k), thetas))
        if k < 2:
            start["y"].append(buf.clone())
        host.give([buf])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    sampler = PairSampler(SAMPLE_PAIRS, seed)
    chunk_ms, enqueue_ms = [], []
    prof = None
    span = contextlib.nullcontext
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        span = torch.profiler.record_function
    k = WARM_CHUNKS
    w0 = time.perf_counter()
    deadline = w0 + seconds
    with span("portbench.window"):
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline and k > WARM_CHUNKS:
                break
            x = ring.chunk(k)
            before = runner.state
            with span("portbench.process"):
                y = runner.process(x, thetas)
            t1 = time.perf_counter()
            with span("portbench.to_host"):
                y_host = host.take()
                y_host.copy_(y)
            t2 = time.perf_counter()
            chunk_ms.append((t2 - t0) * 1e3)
            enqueue_ms.append((t1 - t0) * 1e3)
            host.give(sampler.offer(k, before, y_host))
            k += 1
    window_s = t2 - w0
    chunks = k - WARM_CHUNKS
    trace_path = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace_path = Path(tempfile.mkdtemp()) / "trace.json"
        prof.export_chrome_trace(str(trace_path))
        del prof
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded by the window's close: "
                           f"{', '.join(found)}")
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    if dev.type == "cuda":
        log(f"card: {card_line()}")
    med = statistics.median(chunk_ms)
    log(f"window: {chunks} chunks of {b} streams x {mix['chunk_hops']} hops "
        f"in {window_s:.4f} s; chunk median {med:.4f} ms, p95 "
        f"{np.percentile(chunk_ms, 95):.4f} ms, enqueue median "
        f"{statistics.median(enqueue_ms):.4f} ms; setup {setup_s:.4f} s")

    del runner, before, y
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = ref_mod.Reference(cfg, thetas, hop, fs, dev, Precision("float64"))
    passed, total = gate_counts(ref, ring)
    share = float(passed.sum() / total.sum())
    log(f"gate: {share:.4f} of in-band (frame, bin) pairs pass (ring "
        f"slots {', '.join(f'{p / t:.4f}' for p, t in zip(passed, total))}"
        f"; {time.perf_counter() - t_ref:.2f} s)")

    tr = None
    if trace:
        from portbench.trace import Trace
        t_tr = time.perf_counter()
        tr = Trace(str(trace_path))
        shutil.rmtree(trace_path.parent)
        log(f"trace: {len(tr.device)} device events read in "
            f"{time.perf_counter() - t_tr:.2f} s")
    run = RunData(c, engine, chunks, WARM_CHUNKS, setup_s, window_s,
                  chunk_ms, enqueue_ms, tr, kind, [int(p) for p in passed],
                  len(ref.ib_host))
    metrics = {}
    for m in c["per_layer" if trace else "end_to_end"]:
        v = load_file(c["bench"] / "metrics" / f"{m['name']}.py").read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t_check = time.perf_counter()
    gaps = check(ref, ring, [start] + sampler.entries)
    log(f"reference: check {time.perf_counter() - t_check:.2f} s")
    limit = float(c["limits"]["out_gap"])
    gap = max(gaps)
    failed = sum(not g <= limit for g in gaps)
    correct = failed == 0
    log(f"out_gap {gap:.6e} limit {limit:.6e}")
    out = {"correct": correct, "attempted": chunks, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": kind, "count": 1,
                      "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {"out_gap": {"value": gap, "limit": limit}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        chips = load_cell(args.workload)["cell"]["chips"]
    except (KeyError, OSError) as exc:
        log(f"error: {exc}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"error: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 1
    torch.set_num_threads(1)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except (ImportError, RuntimeError):
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        log(f"error: loaded in this process: {', '.join(found)}")
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
