"""The readers of the program's spans (``metrics/_spans.py`` and the
four metrics on it) and ``Trace.idle_gaps``' names under them, on a
synthetic Chrome trace: a window, two chunks of nested ``bf.*`` spans as
the program emits them (``cpu_op`` ranges), host operations and device
events. Times are microseconds."""

import json
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.trace import Trace

METRICS = ("controls_ms", "steering_ms", "launch_host_ms", "process_idle_ms")


def _x(name, ts, end, cat):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts,
            "pid": 1, "tid": 1}


#: (name, start, end) of the program's spans, two chunks
PROGRAM = [
    ("bf.process", 105, 395), ("bf.controls", 110, 130),
    ("bf.forward", 135, 390), ("bf.steering", 140, 200),
    ("bf.kernel.wola_analysis", 210, 230), ("bf.kernel.mvdr_stream", 240, 260),
    ("bf.kernel.wola_synthesis", 300, 310),
    ("bf.process", 505, 795), ("bf.controls", 510, 520),
    ("bf.forward", 525, 790), ("bf.steering", 540, 560),
    ("bf.kernel.wola_analysis", 600, 620), ("bf.kernel.mvdr_stream", 640, 670),
    ("bf.kernel.wola_synthesis", 700, 705),
]
#: the card's busy intervals: a kernel each, one a copy
BUSY = [(0, 145), (165, 180), (200, 240), (250, 320), (330, 500),
        (560, 900)]


def _trace(tmp_path, program=True):
    events = [_x("portbench.window", 0, 1000, "user_annotation"),
              _x("portbench.process", 100, 400, "user_annotation"),
              _x("portbench.process", 500, 800, "user_annotation"),
              _x("aten::mul", 150, 160, "cpu_op"),
              _x("cudaLaunchKernel", 220, 225, "cuda_runtime")]
    if program:
        events += [_x(n, s, e, "cpu_op") for n, s, e in PROGRAM]
    events += [_x(f"kernel_{i}", s, e, "kernel")
               for i, (s, e) in enumerate(BUSY[:-1])]
    events.append(_x("Memcpy DtoH", *BUSY[-1], "gpu_memcpy"))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(path))


def _run(trace):
    return SimpleNamespace(trace=trace, chunks=2, log=lambda msg: None)


def _read(name, rd):
    return run.load_file(run.HERE / "metrics" / f"{name}.py").read(rd)


@pytest.mark.parametrize("name, want", [
    ("controls_ms", 0.015),            # median of 20 and 10 us
    ("steering_ms", 0.040),            # (60 + 20) us over 2 chunks
    ("launch_host_ms", 0.0525),        # median of 20+20+10 and 20+30+5 us
    ("process_idle_ms", 0.0575),       # (60 + 55) us idle over 2 chunks
])
def test_span_readers_give_the_hand_computed_values(tmp_path, name, want):
    assert _read(name, _run(_trace(tmp_path))) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_span_readers_give_none_without_program_spans(tmp_path, name):
    """A program without spans (the parent of the spans' change) and an
    untraced run report nothing, and raise nothing."""
    assert _read(name, _run(_trace(tmp_path, program=False))) is None
    assert _read(name, _run(None)) is None


def test_idle_gaps_name_the_innermost_program_span(tmp_path):
    """A gap under ``bf.steering`` and no host operation is named by it;
    one inside an operation by the operation, as before; gaps outside the
    program's spans keep their names."""
    gaps = dict(_trace(tmp_path).idle_gaps())
    assert gaps == pytest.approx({
        "portbench.process: aten::mul": 20e-6,
        "portbench.process: bf.steering": 20e-6,
        "portbench.process: bf.kernel.mvdr_stream": 10e-6,
        "portbench.process: bf.forward": 70e-6,
        "portbench loop": 100e-6})
    bare = dict(_trace(tmp_path, program=False).idle_gaps())
    assert bare == pytest.approx({"portbench.process: aten::mul": 20e-6,
                                  "portbench.process": 100e-6,
                                  "portbench loop": 100e-6})
