"""The run's process: it loads neither JAX nor the JAX package, and it
fails, printing no result, without a card or without the program."""

import os
import shutil
import subprocess
import sys

from portbench import run

ROOT = run.ROOT


def test_harness_and_reference_load_no_jax():
    code = (
        "import sys, glob, importlib, runpy\n"
        "sys.path.insert(0, '.')\n"
        "import portbench.run as r, portbench.calibrate, portbench.trace\n"
        "import portbench.reference.mvdr, portbench.reference.gss\n"
        "for p in glob.glob('portbench/metrics/*.py') + "
        "glob.glob('portbench/work/*.py'):\n"
        "    r.load_file(__import__('pathlib').Path(p))\n"
        "import beamform_tpu_torch.runtime.batch\n"
        "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole_top_level_names():
    sys.modules.setdefault("beamform_tpu_torch_like", sys)
    try:
        assert "beamform_tpu" not in run.forbidden_modules() or \
            "beamform_tpu" in {n.split(".")[0] for n in sys.modules}
    finally:
        sys.modules.pop("beamform_tpu_torch_like", None)


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mvdr-noisy-b32",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    assert out.stdout == ""


def test_run_fails_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mvdr-noisy-b32",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
