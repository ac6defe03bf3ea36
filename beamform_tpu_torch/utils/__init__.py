from beamform_tpu_torch.utils.profiling import (  # noqa: F401
    RealTimeMonitor, span, trace_to, xrt_report)
