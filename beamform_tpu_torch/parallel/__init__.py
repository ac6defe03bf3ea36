"""Multi-device execution over ``torch.distributed``: the (stream, bin)
and (stream, frame, bin) meshes (``mesh``), process-group init and the
node-aware mesh (``multihost``), and the sharded steps (``sharded``).
Counterpart of ``beamform_tpu/parallel``."""

from beamform_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from beamform_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_spectral_pipeline,
    sharded_training_step,
)
