"""Multi-node scaffolding: process-group init and a node-aware mesh.

Counterpart of ``beamform_tpu/parallel/multihost.py``. Every rank runs the
same program with one device; ``torch.distributed`` joins the processes
(``torchrun`` sets ``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``), and the mesh keeps the two
network tiers apart:

* between nodes only the ``stream`` axis travels: data parallelism over
  independent recordings, no collective in the hot path (the one
  cross-stream reduction is the training step's power diagnostic);
* within a node the ``bin`` axis travels: its all-gather before each
  synthesis is the hot path's only collective.

Ranks are node-major: the node of rank r is ``r // LOCAL_WORLD_SIZE``.
``multihost_mesh`` takes bin groups of consecutive ranks no larger than a
node, so a bin group never spans nodes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from beamform_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   backend: Optional[str] = None,
                   device_type: str = "cuda") -> bool:
    """Initialise ``torch.distributed`` when a multi-process launch is
    configured: explicit arguments (``init_method`` such as
    ``tcp://localhost:29500``, or a ``world_size``), or the environment
    ``torchrun`` sets (``MASTER_ADDR``, ``WORLD_SIZE`` > 1).

    Returns True if it initialised the world, False when nothing is
    configured (a single process, nothing to join). The backend is
    ``nccl`` for ``cuda`` and ``gloo`` for ``cpu``; an explicit
    ``backend`` overrides it (NCCL refuses two ranks on one card, gloo
    takes them). On ``cuda`` each rank takes card ``LOCAL_RANK`` (else its
    rank) modulo the cards it sees; without a card it raises.
    """
    configured = (init_method is not None or (world_size or 0) > 1
                  or os.environ.get("MASTER_ADDR")
                  or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if not configured:
        return False
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost(device_type='cuda') needs a "
                               "CUDA device; pass device_type='cpu' for gloo "
                               "on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank if rank is not None
                                   else os.environ.get("RANK", "0")))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    return True


def local_world_size() -> int:
    """Ranks per node: ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, else
    the whole world (one node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def multihost_mesh(bin_size: Optional[int] = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """A (stream, bin) mesh over every rank of every node, with bin groups
    inside one node, so only the stream axis crosses nodes.

    bin_size: ranks per bin group (defaults to the single-node heuristic
    on the node's rank count); it must divide the ranks of a node.
    """
    n = dist.get_world_size()
    n_local = local_world_size()
    if bin_size is None:
        _, bin_size = mesh_shape_for(n_local)
    if n % n_local or n_local % bin_size:
        raise ValueError(f"{n} ranks, {n_local} a node, bin groups of "
                         f"{bin_size}: a bin group must fit in a node")
    return make_mesh(shape=(n // bin_size, bin_size),
                     device_type=device_type)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def process_local_batch(mesh: DeviceMesh,
                        local_batch) -> Tuple[torch.Tensor, int, int]:
    """This rank's streams (B_local, ...) on its device, with the global
    stream count and the rank's first global stream.

    Each rank holds only its own streams: the ranks of one bin group pass
    the same streams, and the stream axis orders the groups. Nothing
    crosses a node on ingest.
    """
    n_groups = mesh.size(mesh.mesh_dim_names.index("stream"))
    g = mesh.get_local_rank("stream")
    x = torch.as_tensor(local_batch).to(mesh_device(mesh))
    return x, x.shape[0] * n_groups, x.shape[0] * g


def dcn_safety_report(mesh: DeviceMesh) -> dict:
    """For each mesh axis, the most nodes one row along it spans. The
    invariant this module exists for: only ``stream`` may exceed 1."""
    ranks = mesh.mesh
    nodes = ranks // local_world_size()
    out = {}
    for i, ax in enumerate(mesh.mesh_dim_names):
        rows = nodes.movedim(i, -1).reshape(-1, ranks.shape[i])
        out[ax] = max(len(set(r.tolist())) for r in rows)
    return out
