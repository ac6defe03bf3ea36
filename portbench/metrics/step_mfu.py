"""The whole step's share of the card's float32 peak (%): the operations
every layer's work count gives for the window's chunks, over the window's
seconds (host clock), over the peak."""

import glob
import os


def read(run):
    flops = 0.0
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "work")
    for path in sorted(glob.glob(os.path.join(here, "*.py"))):
        work = run.window_work(os.path.basename(path)[:-3])
        if work is not None:
            flops += work[1]
    least = run.least_seconds(0.0, flops)
    if not flops or least is None:
        return None
    return 100.0 * least[0] / run.window_s
