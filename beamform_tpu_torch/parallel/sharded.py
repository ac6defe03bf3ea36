"""Multi-device execution over a (stream, bin) mesh.

Counterpart of ``beamform_tpu/parallel/sharded.py``. Each rank of a
``torch.distributed`` world owns one device and holds only its shards: a
sharded tensor is the rank's local shard, a plain tensor on its device,
and :class:`Spec` names the mesh axis of each of its dimensions (as JAX's
``PartitionSpec``). The kernels take plain tensors, so no DTensor is
needed. The two parallel axes of this workload:

* ``stream`` (data parallel): independent recordings / mic arrays. A rank
  holds the streams of its row of the mesh, and no collective crosses it
  but the training step's power diagnostic;
* ``bin`` (tensor parallel): per-frequency-bin state and solves (GSS
  demixing matrices, MVDR/LCMV histories). A rank holds its bin group of
  the per-bin state; bin-sharded math needs one all-gather over the bin
  group before each synthesis.

Collectives run over the mesh's per-axis process groups, on whatever
backend the world was initialised with: NCCL, or gloo, which takes two
ranks on one card and CUDA tensors for the all-gather and the all-reduce
this module makes. Nothing falls back from one backend to another.

Pipeline parallelism is absent, as in the JAX package: the per-frame
graph is two FFTs deep with no layer stack to cut.

``sharded_training_step`` is the framework's "training" step: the online
adaptive beamformers are streaming learners (GSS natural-gradient
demixing updates, gss.cpp:124-136), so one step ingests a chunk of frames,
produces beamformed audio and updates the learned per-bin demixing state,
sharded over (stream, bin).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

from beamform_tpu_torch.config import EngineConfig
from beamform_tpu_torch.dsp.wola import frame_signal, overlap_add
from beamform_tpu_torch.kernels.gss_stream import gss_update
from beamform_tpu_torch.models import common
from beamform_tpu_torch.models.mvdr import MvdrModel
from beamform_tpu_torch.parallel.multihost import mesh_device


class Spec(tuple):
    """The mesh axis of each dimension of a sharded tensor (None:
    replicated along every axis), as ``jax.sharding.PartitionSpec``. A
    leaf of a state's pytree, not a node."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"Spec{tuple(self)!r}"


def axis(mesh: Optional[DeviceMesh], name: str) -> Tuple[int, int]:
    """(size, this rank's index) of the mesh axis ``name``; (1, 0) when
    the mesh has no such axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1, 0
    return (mesh.size(mesh.mesh_dim_names.index(name)),
            mesh.get_local_rank(name))


def all_gather_axis(mesh: DeviceMesh, name: str,
                    t: torch.Tensor) -> List[torch.Tensor]:
    """``t`` of every rank of this rank's row along mesh axis ``name``, in
    the axis' order; each rank passes a tensor of the same shape."""
    group = mesh.get_group(name)
    flat = torch.view_as_real(t) if t.is_complex() else t
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat.contiguous(), group=group)
    return ([torch.view_as_complex(p) for p in parts] if t.is_complex()
            else parts)


def _shard(t: torch.Tensor, dim: int, size: int, index: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` equal pieces of ``t`` along ``dim``."""
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n).contiguous()


def _nib(model) -> int:
    return len(getattr(model, "ib_host", ()))


def _bin_pad(model, bin_size: int) -> int:
    """Padding that rounds the in-band bin count up to the mesh's ``bin``
    axis, so every rank holds an equal bin group."""
    nib = _nib(model)
    if not nib or bin_size <= 1:
        return 0
    return (-nib) % bin_size


def _map_bin_axis(state, size: int, fn):
    """``fn(leaf, dim)`` on every leaf whose first axis past the stream
    axis of length ``size`` is its bin axis; other leaves unchanged."""
    def one(leaf):
        for i in range(1, leaf.dim()):
            if leaf.shape[i] == size:
                return fn(leaf, i)
        return leaf
    return pytree.tree_map(one, state)


def pad_state_bins(model, state, bin_size: int):
    """Zero-pad every per-bin state axis (size nib) to the next multiple
    of the mesh ``bin`` axis. The generic step slices the padded lanes off
    again before the model's math, so they never enter it."""
    nib, pad = _nib(model), _bin_pad(model, bin_size)
    if pad == 0:
        return state

    def pad_leaf(leaf, i):
        shape = list(leaf.shape)
        shape[i] = pad
        return torch.cat([leaf, leaf.new_zeros(shape)], dim=i)

    return _map_bin_axis(state, nib, pad_leaf)


def unpad_state_bins(model, state, bin_size: int):
    """Inverse of :func:`pad_state_bins`: slice padded per-bin axes back
    to the model's in-band bin count."""
    nib, pad = _nib(model), _bin_pad(model, bin_size)
    if pad == 0:
        return state
    return _map_bin_axis(state, nib + pad,
                         lambda leaf, i: leaf.narrow(i, 0, nib))


def state_partition_specs(model, state, mesh: Optional[DeviceMesh] = None):
    """:class:`Spec` of each leaf of a model's batched carried state: the
    leading axis is ``stream``; the axis matching the model's in-band bin
    count (raw or padded up to the mesh's ``bin`` axis) is ``bin``. MVDR /
    LCMV histories (B, W, M, NIB) and GSS demixing stacks (B, NIB, S, M)
    are per-bin independent (mvdr.cpp:77-105), the textbook bin-sharded
    state. ``state`` may be the global state or a rank's shard."""
    nib = _nib(model)
    bin_size = axis(mesh, "bin")[0]
    nib_pad = nib + _bin_pad(model, bin_size)
    shard_sizes = ({s for s in (nib, nib_pad) if s and s % bin_size == 0}
                   | {nib_pad // bin_size} if nib and bin_size > 1 else set())

    def spec_of(leaf):
        dims = [None] * leaf.dim()
        if leaf.dim():
            dims[0] = "stream"
        for i in range(1, leaf.dim()):
            if leaf.shape[i] in shard_sizes:
                dims[i] = "bin"
                break
        return Spec(*dims)

    return pytree.tree_map(spec_of, state)


def _local_shards(mesh: DeviceMesh, state, specs):
    """Each bin-sharded leaf of a rank's stream slice -> its bin group."""
    size, index = axis(mesh, "bin")
    leaves, tree = pytree.tree_flatten(state)
    spec_leaves = pytree.tree_leaves(specs)
    out = [_shard(leaf, spec.index("bin"), size, index) if "bin" in spec
           else leaf for leaf, spec in zip(leaves, spec_leaves)]
    return pytree.tree_unflatten(out, tree)


def sharded_state_init(mesh: DeviceMesh, model, batch: int):
    """This rank's shard of the model's batched carried state for
    ``batch`` streams over the mesh: its streams, and of each per-bin leaf
    its bin group. A bin count that does not divide the mesh's ``bin``
    axis is zero-padded up to it, so the state is bin-sharded, not
    replicated."""
    n_stream, _ = axis(mesh, "stream")
    if batch % n_stream:
        raise ValueError(f"{batch} streams over a stream axis of "
                         f"{n_stream}")
    state = pad_state_bins(model, model.batched_state_init(batch // n_stream),
                           axis(mesh, "bin")[0])
    return _local_shards(mesh, state, state_partition_specs(model, state,
                                                            mesh))


def _broadcast_thetas(thetas, b: int, t: int):
    th = np.asarray(thetas, dtype=np.float64)
    if th.ndim == 0:
        th = np.full((b, t), float(th))
    elif th.ndim == 1:
        th = np.repeat(th[:, None], t, axis=1)
    return th


def _bin_group(model, size: int, index: int):
    """(positions in the band (NIBp/size,), the spectrum bins they name)
    of bin group ``index`` of ``size``, as int64 tensors on the model's
    device. A band that does not divide the group count is padded by
    repeating its last bin, whose lanes keep their covariances and solves
    as well defined as a real bin's and are dropped after the gather."""
    def build():
        nib = _nib(model)
        sel = np.concatenate([np.arange(nib),
                              np.full(_bin_pad(model, size), nib - 1)])
        n = len(sel) // size
        sel = torch.as_tensor(sel[index * n:(index + 1) * n],
                              device=model.device)
        return sel, model.ib.index_select(0, sel)

    return model._cached(("bin_group", size, index), build)


def _sharded_stream_step(mesh: DeviceMesh, model, x, kernel, bins, state):
    """One batched MVDR/LCMV chunk with the streaming solve kernel sharded
    over bin groups.

    The solve is per-bin independent (mvdr.cpp:77-105): each rank analyses
    its streams (one analysis launch with the gate statistic), runs
    ``kernel``, the model's stream kernel on its bin group ``bins`` of the
    band (``MvdrModel.stream_solve``), once with its history shard and its
    slice of the gate (the kernel applies the gate's 0.01 * x0 fallback,
    mvdr.cpp:96), makes one all-gather of the (B, T, NIBp/size) result over
    the bin group, drops the pad lanes and synthesises with the DC bin
    passed through (mvdr.cpp:76), in ``MvdrModel.gated_forward``'s
    pipeline. A lane's math does not depend on which bins share a block,
    so each rank's output equals the single-process batched run
    (``runtime/batch.BatchRunner``) bit for bit."""
    nib = _nib(model)

    def solve(spec, hist0, gate):
        y_g = kernel(spec, hist0, gate)
        return torch.cat(all_gather_axis(mesh, "bin", y_g), dim=2)[..., :nib]

    return model.gated_forward(x, state, solve, bins=bins)


def sharded_batched_step(mesh: DeviceMesh, model, x_local, thetas,
                         state_local):
    """One batched chunk of a model over the (stream, bin) mesh.

    x_local (B_local, M, S): this rank's streams; thetas scalar, (B_local,)
    or (B_local, T) for them; state_local: this rank's shard
    (:func:`sharded_state_init`). Returns (out (B_local, S), new state
    shard); every rank of a bin group returns its streams' output.

    MVDR/LCMV whose ``stream_solve`` names a stream kernel (``stream``, or
    ``mega``, which runs the stream kernels here, as in the JAX package)
    take :func:`_sharded_stream_step`. Every other model takes the generic
    path: the bin-sharded state leaves are all-gathered within the bin
    group, the model's own ``batched_forward`` runs on the rank's streams
    (one launch of each kernel for the B_local streams), and the rank keeps
    its bin group of the new state.
    """
    bin_size = axis(mesh, "bin")[0]
    x = torch.as_tensor(x_local).to(device=model.device, dtype=model.rdtype)
    b, t = x.shape[0], x.shape[-1] // model.engine.hop
    ctrl = model.batch_controls(_broadcast_thetas(thetas, b, t))
    if isinstance(model, MvdrModel):
        sel, bins = _bin_group(model, bin_size, axis(mesh, "bin")[1])
        kernel = model.stream_solve(ctrl, sel, bins)
        if kernel is not None:
            return _sharded_stream_step(mesh, model, x.contiguous(), kernel,
                                        bins, state_local)
    specs = state_partition_specs(model, state_local, mesh)
    leaves, tree = pytree.tree_flatten(state_local)
    full = [torch.cat(all_gather_axis(mesh, "bin", leaf),
                      dim=spec.index("bin")) if "bin" in spec else leaf
            for leaf, spec in zip(leaves, pytree.tree_leaves(specs))]
    state = unpad_state_bins(model, pytree.tree_unflatten(full, tree),
                             bin_size)
    out, new = model.batched_forward(x.contiguous(), ctrl, state)
    new = pad_state_bins(model, new, bin_size)
    return out, _local_shards(mesh, new, state_partition_specs(model, new,
                                                               mesh))


def _ext_weights(weights, engine: EngineConfig, cdtype, device):
    """(M, nfft) weights in the JAX package's full FFT layout, or (M, NB)
    in the active layout -> the active layout on ``device``: the extended
    rFFT keeps bins 0..nfft/2 and the shadow bin nfft/2+1 (steering
    weights are Hermitian about nfft/2 but there, which the shadow bin
    carries; models/common.py)."""
    w = torch.as_tensor(weights).to(device=device, dtype=cdtype)
    n, nb = engine.fft_win, common.num_bins(engine)
    if w.shape[-1] == n and nb != n:
        w = torch.cat([w[:, :n // 2 + 1], w[:, n // 2 + 1:n // 2 + 2]], -1)
    if w.shape[-1] != nb:
        raise ValueError(f"weights of {w.shape[-1]} bins; the engine's "
                         f"layout has {nb} (or pass nfft = {n})")
    return w


def _split(n: int, size: int, index: int) -> Tuple[int, int, int]:
    """(start, stop, per) of piece ``index`` of ``n`` items cut into
    ``size`` pieces of ``per`` = ceil(n / size), the last ones short."""
    per = -(-n // size)
    start = min(index * per, n)
    return start, min(start + per, n), per


def _gather_cat(mesh, name: str, t: torch.Tensor, per: int, n: int):
    """Gather ``t`` (..., k) with k <= ``per`` along the last axis over
    ``name``: each piece padded to ``per``, the whole cut to ``n``."""
    size, _ = axis(mesh, name)
    if size == 1:
        return t
    pad = t.new_zeros(t.shape[:-1] + (per - t.shape[-1],))
    parts = all_gather_axis(mesh, name, torch.cat([t, pad], dim=-1))
    return torch.cat(parts, dim=-1)[..., :n]


def sharded_spectral_pipeline(mesh: DeviceMesh, engine: EngineConfig,
                              weights, x_local, kind: str = "das"):
    """Run a stateless spectral beamformer over this rank's streams.

    x_local (B_local, M, S), S a multiple of the hop; weights (M, nfft)
    in the JAX package's full layout or (M, NB) in the engine's. Returns
    (B_local, S) on the rank's device, the same on every rank of the
    streams' bin (and frame) group.

    On a 2-axis (stream, bin) mesh the rank analyses its streams, weights
    and sums its bin slice, and one all-gather over the bin group joins
    the slices before synthesis. On the 3-axis (stream, frame, bin) mesh
    the rank also takes only its frames: it analyses them with a one-hop
    halo of input before the first, synthesises them, gets the overlap-add
    seam (the previous rank's last half-window) from the frame group and
    all-gathers the frames' audio. On CUDA the WOLA kernels analyse and
    synthesise.
    """
    if kind != "das":
        raise ValueError(kind)
    dev = mesh_device(mesh)
    rdtype, cdtype = common.dtypes_of(engine)
    hop = engine.hop
    x = torch.as_tensor(x_local).to(device=dev, dtype=rdtype)
    b, m, s = x.shape
    if s % hop:
        raise ValueError(f"signal length {s} not a multiple of hop {hop}")
    t_all = s // hop
    window = common.make_window(engine, rdtype).to(dev)
    w = _ext_weights(weights, engine, cdtype, dev)
    nb = w.shape[-1]
    n_fr, i_fr = axis(mesh, "frame")
    t0, t1, t_per = _split(t_all, n_fr, i_fr)
    if (n_fr - 1) * t_per >= t_all:
        raise ValueError(f"{t_all} frames leave a rank of the {n_fr}-way "
                         "frame axis none")
    tail = (x[..., (t0 - 1) * hop:t0 * hop] if t0 else
            x.new_zeros((b, m, hop)))
    spec, _, _ = common.stft_streams_carry(
        x[..., t0 * hop:t1 * hop].contiguous(), engine, window, cdtype,
        tail.contiguous())                                 # (T, B, M, NB)
    n_bin, i_bin = axis(mesh, "bin")
    k0, k1, k_per = _split(nb, n_bin, i_bin)
    wb = w[:, k0:k1][None, None].expand(b, 1, m, k1 - k0).contiguous()
    y = (wb.conj() * spec[..., k0:k1].movedim(0, 1)).sum(dim=2) / m
    y = _gather_cat(mesh, "bin", y, k_per, nb)             # (B, T, NB)
    out, prev = common.istft_channels_carry(y, engine, window,
                                            x.new_zeros((b, hop)))
    if n_fr > 1:
        seams = all_gather_axis(mesh, "frame", prev)
        if i_fr:
            out[:, :hop] += seams[i_fr - 1]
        out = _gather_cat(mesh, "frame", out, t_per * hop, s)
    return out


def make_training_state(mesh: DeviceMesh, engine: EngineConfig, batch: int,
                        num_mics: int, num_sources: int, steering):
    """This rank's shard of the per-stream, per-bin GSS demixing state W =
    A^H, (B_local, nfft / bin, S, M), sharded (stream, bin) over all nfft
    bins of the full FFT layout.

    ``steering``: (M, nfft) DOI weights; sources beyond the DOI start from
    the same steering column (a cold start, as in the JAX package)."""
    _, cdtype = common.dtypes_of(engine)
    n_stream, _ = axis(mesh, "stream")
    n_bin, i_bin = axis(mesh, "bin")
    n = engine.fft_win
    if batch % n_stream or n % n_bin:
        raise ValueError(f"{batch} streams, {n} bins over a mesh of "
                         f"({n_stream}, {n_bin})")
    a_h = torch.as_tensor(steering).to(cdtype).T.conj()
    w0 = a_h[None, :, None, :].expand(batch // n_stream, n, num_sources,
                                      num_mics)
    return _shard(w0, 1, n_bin, i_bin).to(mesh_device(mesh))


def sharded_training_step(mesh: DeviceMesh, engine: EngineConfig, params,
                          x_local, steering, w_state):
    """One streaming-learning step over the mesh.

    x_local (B_local, M, S): a chunk of frames of this rank's streams;
    steering (M, nfft); w_state: this rank's (B_local, nfft / bin, S, M)
    shard of the demixing state. Each frame runs the plain GSS update
    (``kernels/gss_stream.gss_update``, the JAX step's ``jnp`` update) on
    the rank's bins; one all-gather over the bin group joins the outputs
    before synthesis. Returns (outputs (B_local, S), new state shard, the
    output power over every stream of the world: one all-reduce).
    """
    rdtype, cdtype = common.dtypes_of(engine)
    dev = w_state.device
    n, hop = engine.fft_win, engine.hop
    window = common.make_window(engine, rdtype).to(dev)
    x = torch.as_tensor(x_local).to(device=dev, dtype=rdtype)
    n_bin, i_bin = axis(mesh, "bin")
    n_stream, _ = axis(mesh, "stream")
    k0, k1, _ = _split(n, n_bin, i_bin)
    frames = frame_signal(x, hop) * window                 # (B, M, T, N)
    spec = torch.fft.fft(frames.to(cdtype), dim=-1).movedim(1, 2)
    mag = common.mag_mean_over_mics(spec, n)[..., k0:k1]   # (B, T, N/bin)
    spec = spec[..., k0:k1]                                # (B, T, M, N/bin)
    w = torch.as_tensor(steering).to(device=dev, dtype=cdtype)
    a_mat = w[:, k0:k1].T[:, :, None].expand(-1, -1, w_state.shape[-2])
    a_h = a_mat.conj().transpose(-1, -2)                   # (N/bin, S, M)
    state, ys = w_state, []
    for t in range(spec.shape[1]):
        x_t, gate = spec[:, t], mag[:, t] > params.freq_mag_threshold
        steps = [gss_update(state[i], a_mat, a_h, x_t[i], gate[i],
                            params.mu, params.lam)
                 for i in range(x.shape[0])]
        state = torch.stack([s for s, _ in steps])
        y0 = torch.stack([y for _, y in steps])
        ys.append(torch.where(gate, y0, x_t[:, 0, :] * 0.01))
    y = torch.cat(all_gather_axis(mesh, "bin", torch.stack(ys, 1)), dim=-1)
    out = overlap_add(torch.fft.ifft(y, dim=-1).real * window, hop)
    # each stream counted once: by the first rank of its bin group
    sq = (out.to(torch.float64) ** 2).sum() if i_bin == 0 else \
        out.new_zeros((), dtype=torch.float64)
    dist.all_reduce(sq)
    power = sq / (x.shape[0] * n_stream * out.shape[-1])
    return out, state, power.to(rdtype)
