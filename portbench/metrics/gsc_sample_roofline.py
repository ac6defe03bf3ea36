"""GSC's per-sample adaptive kernel against its roofline (%)."""

from portbench.metrics._roofline import roofline_pct

PATTERNS = ("gsc_sample_kernel",)


def read(run):
    return roofline_pct(run, PATTERNS, "gsc_sample")
