"""The host's time in ``BatchRunner.process``, from the call to its return
before ``.cpu()`` (the harness's span around it), median over the
window's chunks (ms)."""

import statistics


def read(run):
    return statistics.median(run.enqueue_ms) if run.enqueue_ms else None
