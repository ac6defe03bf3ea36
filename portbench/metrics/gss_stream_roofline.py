"""The fused GSS kernel against its roofline (%)."""

from portbench.metrics._roofline import roofline_pct

PATTERNS = ("gss_kernel",)


def read(run):
    return roofline_pct(run, PATTERNS, "gss_stream")
