"""Closed-loop steering: the reference's rospy DOA refiners and VAD
(scripts/energy2theta*.py, SIR2theta.py, vad.py) as host-side numpy
controllers, and a driver that steers a ``StreamingSession`` with them
chunk by chunk."""

from beamform_tpu_torch.doa.vad import EnergyVad  # noqa: F401
from beamform_tpu_torch.doa.energy2theta import (  # noqa: F401
    GradientDoa, DiffGradientDoa, SpecGradientDoa)
from beamform_tpu_torch.doa.sir2theta import (  # noqa: F401
    SirToTheta, SirDummy, SpeakerIdStub)
from beamform_tpu_torch.doa.monitor import SpecDoaMonitor  # noqa: F401
from beamform_tpu_torch.doa.closed_loop import run_closed_loop  # noqa: F401
