"""BENCHMARK.json's cells resolve to their files by name, a cell, a mix
and a metric added as new files run without an edit to any file there,
and each mix gives the same audio for the same seed."""

import json
import re
import shutil
import time

import pytest
import torch

from portbench.tests.bench_fixtures import cuda, small  # noqa: F401
from portbench import generator, run

SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(len(v) <= 128 for v in layers.values())
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(cells) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = run.load_cell(cell)
    bench = run.HERE
    assert c["cfg"]["name"] == c["cell"]["config"]
    assert (bench / "reference" / f"{c['cfg']['node']}.py").exists()
    assert set(c["cfg"]["reduced"]) == set(
        next(x for x in SPEC["configs"]
             if x["name"] == c["cell"]["config"])["reduced"])
    assert c["limits"]["out_gap"] > 0
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(run.load_file(bench / "metrics"
                                      / f"{m['name']}.py").read)
    for path in (bench / "work").glob("*.py"):
        assert callable(run.load_file(path).chunk_work)


def test_new_cell_mix_and_metric_run_as_new_files(tmp_path, small):
    """A later change adds files and entries only: a traffic mix, a cell
    on it, its limits and a per-layer metric, in a copy of the
    benchmark."""
    bench = tmp_path / "portbench"
    shutil.copytree(run.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    mix = json.loads((bench / "traffic" / "noisy.json").read_text())
    mix["noise_sigma"] = 0.03
    (bench / "traffic" / "hum.json").write_text(json.dumps(mix))
    spec["workloads"].append({"name": "mvdr-hum-b3", "config": "aira16-mvdr",
                              "traffic": "hum", "chips": 1, "why": "test"})
    (bench / "limits" / "mvdr-hum-b3.json").write_text(
        json.dumps({"out_gap": 1e-3}))
    (bench / "metrics" / "chunks.per.s.py").write_text(
        "def read(run):\n    return run.chunks / run.window_s\n")
    spec["per_layer"].append({"name": "chunks.per.s", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "audio_s_per_s",
                              "workloads": ["mvdr-hum-b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    before = {p: p.read_bytes() for p in run.HERE.rglob("*.*")
              if "__pycache__" not in p.parts}
    out = run.run_cell("mvdr-hum-b3", 5, 0.3, True, device="cpu",
                       overrides=small, t_start=time.perf_counter(),
                       bench=bench)
    assert out["correct"]
    assert out["metrics"]["chunks.per.s"]["value"] > 0
    assert "mvdr_stream_roofline" not in out["metrics"]
    assert before == {p: p.read_bytes() for p in run.HERE.rglob("*.*")
                      if "__pycache__" not in p.parts}


@pytest.mark.parametrize("mix", ["noisy", "quiet"])
def test_each_mix_is_deterministic_per_seed(mix):
    cfg = json.loads((run.HERE / "configs" / "aira16-gss3.json").read_text())
    m = json.loads((run.HERE / "traffic" / f"{mix}.json").read_text())
    m.update(streams=2, chunk_hops=8, ring_chunks=2)

    def ring(seed):
        return generator.make_ring(cfg, m, seed, 128, 48000, "cpu").data

    a, b, c = ring(2**31 + 7), ring(2**31 + 7), ring(2**31 + 8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (2, 2, 16, 8 * 128)
