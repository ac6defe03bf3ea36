"""The host's time in the hand-written kernels' wrappers (checks, output
allocations, the launch), the program's ``bf.kernel.<wrapper>`` spans
summed per chunk, median over the window's chunks (ms)."""

import statistics

from portbench.metrics._spans import KERNEL, chunks


def read(run):
    found = chunks(run)
    if found is None:
        return None
    per_chunk = [[d for name, ds in c.items() if name.startswith(KERNEL)
                  for d in ds] for c in found[1]]
    run.log(f"launch_host: {sum(map(len, per_chunk)) / len(per_chunk):.4f} "
            "kernel spans a chunk")
    return statistics.median(sum(ds) for ds in per_chunk) * 1e-3
