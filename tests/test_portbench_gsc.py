"""The benchmark's GSC cell (``gsc-noisy-b32``) on the CPU at a small size:
the plain float64 reference (``portbench/reference/gsc.py``) follows the
port's float64 path to round-off, from the stream's start and from the
port's state in the middle of a stream; the sound float32 program is
correct and the TF32 control and the planted faults are not; the
reference loads nothing of JAX or of either package; and the adaptive
stage's work count (``portbench/work/gsc_sample.py``) at the cell's shape.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import run
from portbench.generator import make_ring, talker_thetas
from portbench.reference import gsc as ref_gsc
from portbench.reference.common import Precision
from portbench.tests.bench_fixtures import SMALL

CELL = "gsc-noisy-b32"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 11
#: the limit at SMALL's size: the port's float32 CPU path reads 1.5e-6 to
#: 2.2e-6 there over seeds 2**31 + 0..5, the TF32 control 6.0e-5 to 7.8e-5
SMALL_LIMIT = 1e-5


#: the harness refuses to run in a process that has loaded JAX, as this
#: one has (``conftest.py``): its runs go to a child process, one for all
#: the cases, which prints one JSON line a case
RUN_CASES = """
import json, sys, time
import torch
from portbench import calibrate, run
from portbench.tests.bench_fixtures import SMALL
from portbench.tests.test_portbench_check import Broken
torch.set_num_threads(2)
for case in sys.argv[2:]:
    serve = None
    if case == "control":
        serve = calibrate.control("gsc")
    elif case != "sound":
        def serve(cfg, thetas, hop, fs, dev, fault=case):
            return Broken(fault, cfg, hop, dev, len(thetas))
    out = run.run_cell(%r, int(sys.argv[1]), 0.3, False, device="cpu",
                       overrides=dict(SMALL, limits={"out_gap": %r}),
                       serve=serve, t_start=time.perf_counter())
    print(json.dumps({"case": case, "correct": out["correct"],
                      "checks": out["checks"]}), flush=True)
""" % (CELL, SMALL_LIMIT)
FAULTS = ["state_unchanged", "half_batch", "answer_altered"]


@pytest.fixture(scope="module")
def runs():
    """{case: the run's correct and checks} for the sound program, the
    control and each fault, run by the harness in a child process."""
    out = subprocess.run(
        [sys.executable, "-c", RUN_CASES, str(SEED), "sound", "control",
         *FAULTS], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return {r["case"]: r for r in map(json.loads, out.stdout.splitlines())}


@pytest.mark.parametrize("first, use_vad", [(0, False), (2, False),
                                            (2, True)],
                         ids=["stream_start", "mid_stream", "mid_stream_vad"])
def test_reference_equals_the_ports_float64_path(first, use_vad):
    """The port's float64 CPU runner over three chunks; the reference
    from the stream's start (two chunks on its own state) or from the
    port's state before chunk 2; with the VAD on at the launch file's
    threshold 0.1, which holds ~40% of the updates here."""
    from beamform_tpu_torch.config import EngineConfig, parse_array_config
    from beamform_tpu_torch.runtime.batch import BatchRunner
    torch.set_num_threads(2)
    c = run.load_cell(CELL)
    cfg = run._merge(c["cfg"], run._merge(
        SMALL["cfg"], {"engine": {"dtype": "float64"},
                       "params": {"use_vad": use_vad}}))
    mix = run._merge(c["mix"], SMALL["mix"])
    engine = EngineConfig(**{k: cfg["engine"][k] for k in
                             ("sample_rate", "window_size", "dtype")})
    hop, fs, b = engine.hop, engine.sample_rate, mix["streams"]
    thetas = talker_thetas(cfg, b)
    ring = make_ring(cfg, mix, SEED, hop, fs, "cpu")
    runner = BatchRunner("gsc", engine, parse_array_config(cfg["array"]),
                         dict(cfg["params"]), batch=b, device="cpu")
    states, ys = [], []
    for k in range(3):
        states.append(runner.state)
        ys.append(runner.process(ring.chunk(k), thetas).numpy())
    ref = ref_gsc.Reference(cfg, thetas, hop, fs, "cpu",
                            Precision("float64"))
    st = ref.start(first, states[first])
    for k in range(first, 3):
        y_ref, lanes, finish = ref.chunk(ring.before(k, ref.pre_hops),
                                         ring.chunk(k), st)
        assert lanes == []
        assert run.stream_gaps(ys[k], y_ref).max() < 1e-10, k
        st = finish([])


def test_sound_program_is_correct(runs):
    assert runs["sound"]["correct"], runs["sound"]["checks"]


def test_control_is_not_correct(runs):
    assert not runs["control"]["correct"], runs["control"]["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_are_not_correct(runs, fault):
    """Each fault a one-card serving cell can have, planted under the
    timed path as ``test_portbench_check.Broken`` plants it."""
    assert not runs[fault]["correct"], runs[fault]["checks"]


def test_reference_loads_no_jax_and_neither_package():
    code = ("import sys, portbench.reference.gsc; print(sorted({m.split('.')"
            "[0] for m in sys.modules} & {'jax', 'jaxlib', 'beamform_tpu', "
            "'beamform_tpu_torch'}))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def _run_at(config: str, **params):
    cfg = json.loads((run.HERE / "configs" / f"{config}.json").read_text())
    cfg["params"].update(params)
    return SimpleNamespace(node=cfg["node"], cfg=cfg, b=32, m=16, t=93,
                           hop=1024)


def test_gsc_sample_work_at_the_cells_shape():
    """32 streams x 93 hops of 1024 samples, 16 mics (15 blocking
    channels), 128 taps: 4 C K operations a stream-sample; the aligned
    audio in, the output out, the registers in and out, float32."""
    work = run.load_file(run.HERE / "work" / "gsc_sample.py").chunk_work
    s = 93 * 1024
    nbytes = 4 * 32 * 16 * s + 4 * 32 * s + 2 * 4 * (2 * 32 * 15 * 128
                                                     + 32 * 128)
    assert nbytes == 208_240_640
    assert work(_run_at("aira16-gsc"), 0) == (nbytes, 23_404_216_320)
    assert work(_run_at("aira16-gsc", solver="block", write_mu=True),
                0) == (nbytes, 23_404_216_320)
    assert work(_run_at("aira16-gsc", solver="blocklms"), 0) is None
    assert work(_run_at("aira16-mvdr"), 0) is None
    assert work(_run_at("aira16-gss3"), 0) is None
