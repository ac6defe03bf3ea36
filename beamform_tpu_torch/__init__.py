"""beamform_tpu_torch — the PyTorch/CUDA port of ``beamform_tpu``.

The JAX package stays the reference; this package re-implements it slice
by slice in PyTorch, with every Pallas kernel of a ported slice replaced by
a kernel written by hand for NVIDIA Hopper (``csrc/``). Ported so far: the
delay-and-sum path (offline, streaming, CLI) through the fused WOLA
analysis and synthesis kernels, and MVDR (``stream`` and ``dense``
solvers) through the streaming Cholesky solve and the batched Gauss-Jordan
inverse kernels. ROADMAP.md lists what follows.

Importing this package never loads JAX.
"""

__version__ = "0.1.0"

import logging as _logging

_logging.getLogger(__name__).addHandler(_logging.NullHandler())

from beamform_tpu_torch.config import (  # noqa: E402,F401
    ArrayConfig,
    EngineConfig,
    load_array_config,
)
from beamform_tpu_torch.geometry import ArrayGeometry  # noqa: E402,F401
from beamform_tpu_torch.models import get_model  # noqa: E402,F401
from beamform_tpu_torch.runtime.offline import run_offline  # noqa: E402,F401
from beamform_tpu_torch.runtime.streaming import (  # noqa: E402,F401
    StreamingSession,
)
