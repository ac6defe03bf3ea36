"""The host's time building a chunk's controls, the program's span
``bf.controls`` (the theta timelines' expansion and the model's
``batch_controls`` with its control cache), median over the window's
chunks (ms)."""

import statistics

from portbench.metrics._spans import chunks


def read(run):
    found = chunks(run)
    if found is None:
        return None
    return statistics.median(sum(c["bf.controls"]) for c in found[1]) * 1e-3
