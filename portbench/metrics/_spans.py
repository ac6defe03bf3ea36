"""The program's spans in a traced window: ``bf.*`` ranges that
``beamform_tpu_torch.utils.profiling.span`` opens while the profiler
records, which the trace files among the host's operations
(``Trace.host``). A chunk is one ``bf.process`` span (one
``BatchRunner.process`` call); a span belongs to the chunk whose
``bf.process`` holds its start. A program without spans gives no chunk,
and its readers None."""

import bisect
from collections import defaultdict

PROCESS = "bf.process"
KERNEL = "bf.kernel."


def chunks(run):
    """(the ``bf.process`` spans as (start, end) microseconds, and per
    chunk {span name: [durations in microseconds]}), or None where the
    run has no trace or its trace no ``bf.process`` span."""
    if not run.trace:
        return None
    spans = [h for h in run.trace.host if h[2].startswith("bf.")]
    procs = [(s, e) for s, e, name in spans if name == PROCESS]
    if not procs:
        return None
    starts = [s for s, _ in procs]
    by_chunk = [defaultdict(list) for _ in procs]
    for s, e, name in spans:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < procs[i][1]:
            by_chunk[i][name].append(e - s)
    return procs, by_chunk


def idle_inside(busy, procs) -> float:
    """Microseconds of the ``procs`` intervals (sorted, disjoint) that no
    ``busy`` interval (sorted, merged: ``Trace.busy_intervals``) covers."""
    total, j = 0.0, 0
    for s, e in procs:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        covered, k = 0.0, j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        total += (e - s) - covered
    return total
