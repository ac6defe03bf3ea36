"""Fixtures of the benchmark's own tests (run them from the repository's
root with ``python -m pytest portbench/tests``; the repository's tier-1
run does not collect them). They run on the CPU at small sizes; those
marked ``cuda`` skip without a card."""

import pytest
import torch

#: a cell at a size the CPU runs in seconds: 3 streams of 16 hops of 128
#: samples, a ring of 3 chunks
SMALL = {"cfg": {"engine": {"window_size": 128}},
         "mix": {"streams": 3, "chunk_hops": 16, "ring_chunks": 3}}
#: the limits at that size, by node: the port's float32 CPU paths read
#: ~1e-4 (MVDR) and ~1e-6 (GSS) there, the TF32 control 30-90 and
#: 6e-4-2e-3 (the cells' own limits hold at their own sizes on the card)
SMALL_LIMITS = {"mvdr": 1e-2, "gss": 2e-5}


@pytest.fixture
def small():
    torch.set_num_threads(2)
    return SMALL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
