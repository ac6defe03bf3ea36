from beamform_tpu_torch.utils.profiling import (  # noqa: F401
    RealTimeMonitor, trace_to, xrt_report)
