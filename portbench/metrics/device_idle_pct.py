"""The window's share with no kernel and no copy on the card (%), from the
profiler's device timeline."""


def read(run):
    if not run.trace or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
