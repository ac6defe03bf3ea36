"""Device mesh construction over ``torch.distributed``.

Counterpart of ``beamform_tpu/parallel/mesh.py``. The JAX package lays a
``jax.sharding.Mesh`` over the chips of one program; here every rank is a
process with one device, and a ``torch.distributed`` ``DeviceMesh`` over
the world names the two axes:

* ``stream`` (data parallel): independent audio streams / files / mic
  arrays, the fleet-scale batch axis;
* ``bin`` (tensor parallel): frequency bins of one stream. The per-bin
  solves (MVDR/LCMV, GSS demixing updates) are independent across bins,
  so bins shard with a single all-gather before each synthesis.

``mesh.get_group(axis)`` is the process group of the rank's row along an
axis; the collectives of ``parallel/sharded.py`` run over those groups.
The world must be initialised first (``parallel/multihost.init_multihost``
or ``torch.distributed.init_process_group``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Pick a (stream, bin) mesh shape: favor a bin axis of 2-4 when the
    device count allows, streams take the rest."""
    for tp in (4, 2, 1):
        if n_devices % tp == 0 and n_devices >= tp:
            return n_devices // tp, tp
    return n_devices, 1


def _world(n_devices: Optional[int], device_type: str) -> int:
    """The world's size, checked against ``n_devices`` and the device
    type: a ``cuda`` mesh without a card raises, it never becomes a CPU
    mesh."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device; pass "
                           "device_type='cpu' for a CPU (gloo) mesh")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.multihost.init_multihost first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans the whole world: n_devices "
                         f"{n_devices}, world size {n}")
    return n


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (stream, bin) mesh over the world, one device a rank; rank r sits
    at (r // bin, r % bin), so a bin group is consecutive ranks."""
    n = _world(n_devices, device_type)
    if shape is None:
        shape = mesh_shape_for(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {tuple(shape)} for {n} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=("stream", "bin"))


def make_mesh3(n_devices: Optional[int] = None,
               shape: Optional[Tuple[int, int, int]] = None,
               device_type: str = "cuda") -> DeviceMesh:
    """3-axis (stream, frame, bin) mesh: data parallel over streams,
    sequence parallel over frames (frames of a stateless model are
    independent; ``sharded_spectral_pipeline`` exchanges the one-hop halo
    and the overlap-add seam), tensor parallel over frequency bins."""
    n = _world(n_devices, device_type)
    if shape is None:
        if n % 8 == 0:
            shape = (n // 8, 2, 4)
        elif n % 4 == 0:
            shape = (n // 4, 2, 2)
        else:
            shape = (n, 1, 1)
    if shape[0] * shape[1] * shape[2] != n:
        raise ValueError(f"mesh shape {tuple(shape)} for {n} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=("stream", "frame", "bin"))
