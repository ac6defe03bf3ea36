"""GSC's spans in the serving path (``models/gsc.py``): under
``torch.profiler`` one batched chunk records ``bf.steering`` (the steering
rebuild), ``bf.gsc.align`` (the stage-1 product) and ``bf.gsc.lookahead``
(``gram_refresh``) inside ``bf.process``; without a profiler the spans
change no output bit; on the card one launch of the per-sample kernel a
chunk, after the start of its wrapper's span.

The file imports no JAX; its card test runs on a machine with only the
port's dependencies as

    python -m pytest --noconftest -m cuda tests/test_torch_gsc_spans.py
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from beamform_tpu_torch.config import EngineConfig, load_array_config
from beamform_tpu_torch.kernels import gsc as gsc_kernels
from beamform_tpu_torch.models import gsc as gsc_model
from beamform_tpu_torch.runtime.batch import BatchRunner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIRA3 = os.path.join(ROOT, "beamform_tpu_torch", "configs", "aira3.yaml")
HOP, B, HOPS = 128, 2, 4
THETAS = np.array([10.0, -30.0])
PARAMS = dict(mu0=0.0001, mu_max=0.1, filter_size=32)
GSC_SPANS = ("bf.steering", "bf.gsc.align", "bf.gsc.lookahead")


def _runner(device="cpu", params=PARAMS):
    return BatchRunner("gsc", EngineConfig(window_size=HOP),
                       load_array_config(AIRA3), params, batch=B,
                       device=device)


def _chunks(n=2, device="cpu"):
    x = 0.1 * np.random.default_rng(4).standard_normal(
        (n, B, 3, HOPS * HOP)).astype(np.float32)
    return [torch.as_tensor(c, device=device) for c in x]


def test_gsc_chunk_records_its_spans_inside_bf_process(tmp_path):
    runner = _runner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.process(_chunks()[0], THETAS)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("bf.")]
    (proc,) = [sp for sp in spans if sp[2] == "bf.process"]
    (fwd,) = [sp for sp in spans if sp[2] == "bf.forward"]
    for name in GSC_SPANS:
        (sp,) = [sp for sp in spans if sp[2] == name]
        assert proc[0] <= fwd[0] <= sp[0] and sp[1] <= fwd[1] <= proc[1]
    order = sorted((sp[0], sp[2]) for sp in spans if sp[2] in GSC_SPANS)
    assert [n for _, n in order] == list(GSC_SPANS)


def test_spans_change_no_output_bit(monkeypatch):
    """Two chunks (state carried) with the spans, under a profiler and
    without one, and with the model's spans replaced by a bare
    ``nullcontext``: the same bits."""
    def outputs():
        runner = _runner()
        return [runner.process(c, THETAS) for c in _chunks()]

    plain = outputs()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = outputs()
    monkeypatch.setattr(gsc_model, "span",
                        lambda name: contextlib.nullcontext())
    bare = outputs()
    for a, b, c in zip(plain, traced, bare):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_sample_kernel_launch_a_chunk_on_the_card(cuda, tmp_path):
    """Three profiled batched chunks on the card (128 taps, the kernel's):
    ``gsc_sample.launches`` rises by one a chunk, and each
    ``gsc_sample_kernel`` starts after its ``bf.kernel.gsc_sample`` span,
    which lies in the chunk's ``bf.process`` after ``bf.gsc.align``."""
    runner = _runner(cuda, dict(PARAMS, filter_size=128))
    chunks = _chunks(4, cuda)
    runner.process(chunks[0], THETAS)                 # builds and warms
    torch.cuda.synchronize(cuda)
    before = gsc_kernels.gsc_sample.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in chunks[1:]:
            runner.process(c, THETAS)
        torch.cuda.synchronize(cuda)
    assert gsc_kernels.gsc_sample.launches == before + 3
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]

    def starts(pred):
        return sorted(float(e["ts"]) for e in events if pred(e))

    procs = starts(lambda e: e["name"] == "bf.process")
    aligns = starts(lambda e: e["name"] == "bf.gsc.align")
    spans = starts(lambda e: e["name"] == "bf.kernel.gsc_sample")
    kernels = starts(lambda e: e.get("cat", "").lower() == "kernel"
                     and "gsc_sample_kernel" in e["name"])
    assert len(procs) == len(aligns) == len(spans) == len(kernels) == 3
    for k in range(3):
        assert procs[k] <= aligns[k] < spans[k] < kernels[k]
        assert k == 2 or spans[k] < procs[k + 1]
