"""Seconds from the top of ``run.py`` to the first timed chunk: torch and
the CUDA context, the input ring, building or loading the kernel library,
the model and the warm chunks."""


def read(run):
    return run.setup_s
