"""One rank of the gloo world of tests/test_torch_parallel.py (not a pytest
file).

The test starts four of these, as ``torchrun`` would on two nodes of two
ranks (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` = 2). Each joins the world through
``init_multihost``, builds the node-aware (stream, bin) = (2, 2) mesh,
runs every case of :data:`CASES` and the spectral pipelines on its own
streams, and writes what it holds (its outputs, its state shards and the
bin axis of each shard) to ``<outdir>/rank<r>.npz``. Inputs come from the
test as ``<inputs>.npz``. Imports no JAX.

Usage: python tests/torch_parallel_worker.py <inputs.npz> <outdir>
"""

import os
import sys

import numpy as np

HOP = 64
FS = 48000
AIRA3 = [(0.0, 0.0), (0.0, -0.18), (-0.156, -0.09)]
# 44 in-band bins at hop 64: divisible by the bin axis
BAND = dict(freq_max=16500.0, freq_min=100.0)
COV = dict(past_windows=6, freq_mag_threshold=0.0008, **BAND)
# 41 in-band bins: not divisible by the bin axis
PAD = dict(past_windows=4, freq_mag_threshold=0.0008, freq_max=15700.0,
           freq_min=100.0)
#: case -> (node, dtype, params): each runs one sharded_batched_step chunk
#: of two streams (one a stream group) from sharded_state_init
CASES = {
    "mvdr_dense": ("mvdr", "float64", dict(COV, solver="dense")),
    "lcmv_dense": ("lcmv", "float64", dict(COV, solver="dense")),
    "gss": ("gss", "float64", dict(freq_mag_threshold=0.0008, mu=0.001,
                                   **BAND)),
    "phase": ("phase", "float64", {}),
    "mcra": ("mcra", "float64", dict(L=4)),
    "phasempf": ("phasempf", "float64", dict(mcra_L=4)),
    "mvdr_stream": ("mvdr", "float32", dict(COV, solver="stream")),
    "lcmv_stream": ("lcmv", "float32", dict(COV, solver="stream")),
    "autopad_dense": ("mvdr", "float64", dict(PAD, solver="dense")),
    "autopad_stream": ("mvdr", "float32", dict(PAD, solver="stream")),
}
#: cases that run a second chunk on the state the first left
TWO_CHUNKS = ("autopad_dense", "autopad_stream")
THETAS = np.linspace(-30.0, 30.0, 2)


def aira3_config():
    from beamform_tpu_torch.config import parse_array_config
    return parse_array_config({f"mic{i}": {"id": i, "x": x, "y": y}
                               for i, (x, y) in enumerate(AIRA3)})


def local_rows(mesh, xs):
    """This rank's rows of a global batch: its stream group's share."""
    n = mesh.size(0)
    b = xs.shape[0] // n
    g = mesh.get_local_rank("stream")
    return xs[g * b:(g + 1) * b], slice(g * b, (g + 1) * b)


def save_state(res, key, model, state, mesh):
    from torch.utils import _pytree as pytree
    from beamform_tpu_torch.parallel.sharded import state_partition_specs
    specs = pytree.tree_leaves(state_partition_specs(model, state, mesh))
    for i, (leaf, spec) in enumerate(zip(pytree.tree_leaves(state), specs)):
        res[f"{key}/state{i}"] = leaf.numpy()
        res[f"{key}/bin_dim{i}"] = np.array(
            spec.index("bin") if "bin" in spec else -1)


def main(inputs: str, outdir: str) -> int:
    import torch
    import torch.distributed as dist
    from beamform_tpu_torch.config import EngineConfig, GssParams
    from beamform_tpu_torch.models import get_model
    from beamform_tpu_torch.parallel.mesh import make_mesh3
    from beamform_tpu_torch.parallel.multihost import (dcn_safety_report,
                                                       init_multihost,
                                                       multihost_mesh,
                                                       process_local_batch)
    from beamform_tpu_torch.parallel.sharded import (
        make_training_state, sharded_batched_step, sharded_spectral_pipeline,
        sharded_state_init, sharded_training_step)

    torch.set_num_threads(1)
    if not init_multihost(device_type="cpu"):
        raise RuntimeError("no launch configured")
    mesh = multihost_mesh(device_type="cpu")
    data = np.load(inputs)
    res = {"mesh": np.array(mesh.mesh), "coord": np.array(
        mesh.get_coordinate())}
    rep = dcn_safety_report(mesh)
    res["report"] = np.array([rep["stream"], rep["bin"]])
    cfg = aira3_config()

    def engine(dtype):
        return EngineConfig(sample_rate=FS, window_size=HOP, dtype=dtype)

    # stateless DAS: the 2-axis mesh, then (stream, frame, bin) = (1, 2, 2)
    xs, _ = local_rows(mesh, data["das2/x"])
    x, b_glob, off = process_local_batch(mesh, xs)
    res["das2/placed"] = np.array([b_glob, off])
    res["das2/x"] = x.numpy()
    res["das2/out"] = sharded_spectral_pipeline(
        mesh, engine("float64"), data["das/w"], x).numpy()
    mesh3 = make_mesh3(device_type="cpu")
    res["das3/coord"] = np.array(mesh3.get_coordinate())
    res["das3/out"] = sharded_spectral_pipeline(
        mesh3, engine("float64"), data["das/w"], data["das3/x"]).numpy()

    for case, (node, dtype, params) in CASES.items():
        model = get_model(node, engine(dtype), cfg, params, device="cpu")
        xs, rows = local_rows(mesh, data[f"{case}/x"])
        x, _, _ = process_local_batch(mesh, xs)
        state = sharded_state_init(mesh, model, 2)
        save_state(res, f"{case}/init", model, state, mesh)
        out, state = sharded_batched_step(mesh, model, x, THETAS[rows],
                                          state)
        res[f"{case}/out"] = out.numpy()
        save_state(res, case, model, state, mesh)
        if case in TWO_CHUNKS:
            out2, _ = sharded_batched_step(mesh, model, x, THETAS[rows],
                                           state)
            res[f"{case}/out2"] = out2.numpy()
        if case == "gss":
            res["gss/single"] = np.stack([
                model.process(xi, float(th)).numpy()
                for xi, th in zip(xs, THETAS[rows])])

    # the GSS streaming learner over all nfft bins
    e32 = engine("float32")
    w = data["train/w"]
    state = make_training_state(mesh, e32, 2, 3, 2, w)
    res["train/init"] = state.numpy()
    xs, _ = local_rows(mesh, data["train/x"])
    out, state, power = sharded_training_step(
        mesh, e32, GssParams(freq_mag_threshold=1e-6, mu=0.001), xs, w,
        state)
    res["train/out"] = out.numpy()
    res["train/state"] = state.numpy()
    res["train/power"] = power.numpy()

    np.savez(os.path.join(outdir, f"rank{dist.get_rank()}.npz"), **res)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1], sys.argv[2]))
