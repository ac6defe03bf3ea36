"""The WOLA analysis and synthesis kernels against their roofline (%)."""

from portbench.metrics._roofline import roofline_pct

PATTERNS = ("wola_analysis_kernel", "wola_inv_kernel")


def read(run):
    return roofline_pct(run, PATTERNS, "wola")
