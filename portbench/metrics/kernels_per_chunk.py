"""Kernel launches on the card in the window (the profiler's count) per
chunk."""


def read(run):
    if not run.trace or not run.chunks:
        return None
    return len(run.trace.kernels()) / run.chunks
