"""The serving path's spans (``beamform_tpu_torch.utils.profiling.span``):
no profiler, no range; under ``torch.profiler`` the span tree of
``BatchRunner.process`` in the exported Chrome trace; on the card, each
hand-written kernel after the start of its wrapper's span (one clock).

The file imports no JAX; its card test runs on a machine with only the
port's dependencies as

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from beamform_tpu_torch.config import EngineConfig, load_array_config
from beamform_tpu_torch.runtime.batch import BatchRunner
from beamform_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIRA3 = os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira3.yaml")
HOP, B, HOPS = 128, 2, 8
THETAS = np.array([10.0, -30.0])
GATED = dict(past_windows=4, freq_mag_threshold=0.0008, freq_max=16000.0,
             freq_min=100.0)
PARAMS = {"mvdr": GATED, "gss": dict(GATED, mu=0.001)}


def _runner(node, device="cpu"):
    return BatchRunner(node, EngineConfig(window_size=HOP),
                       load_array_config(AIRA3), PARAMS[node], batch=B,
                       device=device)


def _chunk(seed, device="cpu"):
    x = 0.1 * np.random.default_rng(seed).standard_normal(
        (B, 3, HOPS * HOP)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def _spans(prof, tmp_path):
    """(name, start, end) of the program's spans in the profiler's Chrome
    trace, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith("bf."))


def _inside(spans, outer, name):
    """The spans called ``name`` that lie within ``outer``."""
    s0, e0, _ = outer
    return [sp for sp in spans if sp[2] == name
            and s0 <= sp[0] and sp[1] <= e0]


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    """No profiler: every span is the one module-level no-op, and no
    profiler range is built, for the span helper or a whole chunk."""
    calls = []

    def counting(name):
        calls.append(name)
        return profiling._NO_SPAN

    monkeypatch.setattr(profiling, "_range", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert profiling.span("bf.process") is profiling._NO_SPAN
    assert profiling.span("bf.kernel.mvdr_stream") is profiling._NO_SPAN
    _runner("mvdr").process(_chunk(1), THETAS)
    assert calls == []
    # the same patch sees every span once a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        _runner("mvdr").process(_chunk(1), THETAS)
    assert calls[:2] == ["bf.process", "bf.controls"]
    assert "bf.steering" in calls and "bf.forward" in calls


def test_mvdr_chunk_emits_the_span_tree(tmp_path):
    """Each MVDR call: one bf.process holding bf.controls, then
    bf.forward, which holds the steering rebuild (every call); the CPU's
    plain versions open no kernel span."""
    runner = _runner("mvdr")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(2):
            runner.process(_chunk(k), THETAS)
    spans = _spans(prof, tmp_path)
    procs = [sp for sp in spans if sp[2] == "bf.process"]
    assert len(procs) == 2
    for proc in procs:
        (ctl,) = _inside(spans, proc, "bf.controls")
        (fwd,) = _inside(spans, proc, "bf.forward")
        assert ctl[1] <= fwd[0]
        assert len(_inside(spans, fwd, "bf.steering")) == 1
        assert not _inside(spans, ctl, "bf.steering")
    assert {sp[2] for sp in spans} == {"bf.process", "bf.controls",
                                       "bf.forward", "bf.steering"}


def test_gss_builds_its_steering_on_a_cache_miss_only(tmp_path):
    """GSS builds its constraints in bf.controls on the first call (a
    control-cache miss) and not on the second, whose thetas repeat."""
    runner = _runner("gss")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(2):
            runner.process(_chunk(k), THETAS)
    spans = _spans(prof, tmp_path)
    first, second = [sp for sp in spans if sp[2] == "bf.process"]
    (ctl,) = _inside(spans, first, "bf.controls")
    assert len(_inside(spans, ctl, "bf.steering")) == 1
    assert len(_inside(spans, second, "bf.controls")) == 1
    assert len(_inside(spans, second, "bf.forward")) == 1
    assert not _inside(spans, second, "bf.steering")


def test_trace_to_records_the_spans(tmp_path):
    """The operator's ``trace_to`` needs no switch: its trace holds the
    chunk's spans."""
    runner = _runner("mvdr")
    with profiling.trace_to(str(tmp_path)):
        runner.process(_chunk(3), THETAS)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert {"bf.process", "bf.controls", "bf.forward",
            "bf.steering"} <= names


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: the kernels each wrapper of the MVDR stream path launches
KERNELS = {"wola_analysis": "wola_analysis_kernel",
           "mvdr_stream": "mvdr_stream_kernel",
           "wola_synthesis": "wola_inv_kernel"}


@pytest.mark.cuda
def test_kernels_start_inside_their_wrappers_span_on_the_card(cuda,
                                                              tmp_path):
    """A profiled batched MVDR chunk on the card: one bf.kernel.<wrapper>
    span for each launch of the path's three hand-written kernels, and
    each kernel's device event starts after its own span starts (the
    spans and the device share the trace's clock)."""
    runner = _runner("mvdr", device=cuda)
    runner.process(_chunk(0, cuda), THETAS)          # builds and warms
    torch.cuda.synchronize(cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(3):
            runner.process(_chunk(k + 1, cuda), THETAS)
        torch.cuda.synchronize(cuda)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    procs = sorted(float(e["ts"]) for e in events
                   if e["name"] == "bf.process")
    assert len(procs) == 3
    for wrapper, kernel in KERNELS.items():
        spans = sorted(float(e["ts"]) for e in events
                       if e["name"] == f"bf.kernel.{wrapper}")
        launched = sorted(float(e["ts"]) for e in events
                          if e.get("cat", "").lower() == "kernel"
                          and kernel in e["name"])
        assert len(spans) == len(launched) == 3, wrapper
        for k, (s, d) in enumerate(zip(spans, launched)):
            assert procs[k] <= s < d, (wrapper, k)
            assert k + 1 == len(procs) or s < procs[k + 1]
