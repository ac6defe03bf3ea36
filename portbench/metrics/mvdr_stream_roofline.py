"""MVDR's stream solve against its roofline (%)."""

from portbench.metrics._roofline import roofline_pct

PATTERNS = ("mvdr_stream_kernel",)


def read(run):
    return roofline_pct(run, PATTERNS, "mvdr_stream")
