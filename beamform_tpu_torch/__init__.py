"""beamform_tpu_torch — the PyTorch/CUDA port of ``beamform_tpu``.

The JAX package stays the reference; this package re-implements it slice
by slice in PyTorch, with every Pallas kernel of a ported slice replaced by
a kernel written by hand for NVIDIA Hopper (``csrc/``). Ported so far, each
offline, streaming and through the CLI: delay-and-sum, through the WOLA
analysis and synthesis kernels; MVDR and LCMV, through the streaming
solves, the batched Gauss-Jordan inverse and the fused audio-to-audio
kernel; GSS, through its fused kernel; phase and phasempf, through the
phase-mask and MPF kernels; mcra, through the MCRA march kernel; GSC,
through the per-sample, block-LMS and lookahead-8 adaptive-stage kernels;
the ref and read utility nodes (plain torch: no kernel); batched serving;
the live serving path (``--live`` over a pipe, a JACK graph or an ALSA
PCM, the write node, output resampling, the run monitor), the DOA
steering refiners, the evaluation harness and the multi-device layer
(``parallel``: the (stream, bin) mesh over ``torch.distributed``).
ROADMAP.md lists what follows.

Models run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``). Importing this package never loads JAX.
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
