"""The benchmark of ``beamform_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json``. Everything that belongs to
one configuration, traffic mix, per-layer metric, layer's work count or
cell's limits is a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``work/<layer>.py``, ``limits/<cell>.json`` and
``reference/<node>.py``. Nothing here imports ``jax`` or the JAX package.
"""
