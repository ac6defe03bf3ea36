"""The host's time building steering and constraints, the program's span
``bf.steering``, summed over the window and over its chunks (ms): a mean,
so a cache that rebuilds once in many chunks still shows; 0.0 where no
chunk rebuilt."""

from portbench.metrics._spans import chunks


def read(run):
    found = chunks(run)
    if found is None:
        return None
    total = sum(sum(c["bf.steering"]) for c in found[1])
    return total / len(found[1]) * 1e-3
