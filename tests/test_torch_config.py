"""The port's configuration layer parses the reference schemas exactly as
the JAX package does, from byte-identical YAML copies."""

import dataclasses
import os

import pytest

from beamform_tpu import config as jcfg
from beamform_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ("aira3.yaml", "aira16.yaml", "launch_params.yaml")
NODES = ("das", "mvdr", "lcmv", "gss", "gsc", "phase", "mcra", "phasempf")


def _path(pkg, name):
    return os.path.join(ROOT, pkg, "configs", name)


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_copies_are_byte_identical(name):
    with open(_path("beamform_tpu", name), "rb") as a, \
            open(_path("beamform_tpu_torch", name), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["aira3.yaml", "aira16.yaml"])
@pytest.mark.parametrize("rereference_polar", [False, True])
def test_array_config_parses_identically(name, rereference_polar):
    j = jcfg.load_array_config(_path("beamform_tpu", name),
                               rereference_polar=rereference_polar)
    t = tcfg.load_array_config(_path("beamform_tpu_torch", name),
                               rereference_polar=rereference_polar)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_mics == j.num_mics > 0


@pytest.mark.parametrize("node", NODES)
def test_launch_params_parse_identically(node):
    assert tcfg.load_launch_params(node) == jcfg.load_launch_params(node)


def test_interference_sentinel_and_rosjack_config():
    doc = {"mic0": {"id": 0, "x": 0.1, "y": 0.2},
           "angle_interf1": 30.0, "angle_interf2": -170.0,
           "angle_interf3": 181.0, "angle_interf4": 10.0}
    assert (dataclasses.asdict(tcfg.parse_array_config(doc))
            == dataclasses.asdict(jcfg.parse_array_config(doc)))
    assert tcfg.parse_array_config(doc).interference_angles == (30.0,
                                                                -170.0)
    for rj in ({}, {"output_type": 7, "ros_output_sample_rate": 16000,
                    "write_file": True, "write_file_path": "/x.wav"}):
        assert (dataclasses.asdict(tcfg.parse_rosjack_config(rj))
                == dataclasses.asdict(jcfg.parse_rosjack_config(rj)))


def test_mvdr_params_match():
    for kw in ({}, tcfg.load_launch_params("mvdr"), {"solver": "dense"}):
        assert (dataclasses.asdict(tcfg.make_params("mvdr", kw))
                == dataclasses.asdict(jcfg.make_params("mvdr", kw)))


def test_lcmv_params_match():
    for kw in ({}, tcfg.load_launch_params("lcmv"), {"solver": "dense"}):
        assert (dataclasses.asdict(tcfg.make_params("lcmv", kw))
                == dataclasses.asdict(jcfg.make_params("lcmv", kw)))
    assert tcfg.make_params("lcmv", tcfg.load_launch_params(
        "lcmv")).interf_angle_threshold == 1.0


def test_engine_config_and_das_params_match():
    for kw in ({}, {"window_size": 128, "dtype": "float64",
                    "exact_freqs": True}):
        j, t = jcfg.EngineConfig(**kw), tcfg.EngineConfig(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hop, t.fft_win) == (j.hop, j.fft_win)
    assert tcfg.make_params("das", {"unknown": 1}) == tcfg.DasParams()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcfg.make_params("write")
