"""The port's CUDA kernels against their plain-torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs on a machine that has only the port's dependencies;
there, skip the JAX-based tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from beamform_tpu_torch import run_offline
from beamform_tpu_torch.config import EngineConfig, load_array_config
from beamform_tpu_torch.kernels import wola as kw
from beamform_tpu_torch.models import get_model

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5      # float32 kernel vs float32 torch.fft: sums in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("hop", [128, 1024, 2048])
@pytest.mark.parametrize("with_mag", [False, True])
def test_analysis_kernel_matches_plain(cuda, hop, with_mag):
    rng = np.random.default_rng(hop)
    x = torch.as_tensor(rng.standard_normal((5, 7 * hop)),
                        dtype=torch.float32, device=cuda)
    tail = torch.as_tensor(rng.standard_normal((5, hop)),
                           dtype=torch.float32, device=cuda)
    before = kw.wola_analysis.launches
    spec, mag, new_tail = kw.wola_analysis(x, tail, with_mag)
    torch.cuda.synchronize()
    assert kw.wola_analysis.launches == before + 1
    ref_spec, ref_mag, ref_tail = kw.wola_analysis_plain(x, tail, with_mag)
    assert spec.shape == (7, 5, hop + 2) and spec.dtype == torch.complex64
    assert _rel(spec, ref_spec) < REL
    assert torch.equal(new_tail, ref_tail)
    if with_mag:
        assert _rel(mag, ref_mag) < REL


@pytest.mark.parametrize("hop", [128, 1024, 2048])
@pytest.mark.parametrize("c", [1, 5])
def test_synthesis_kernel_matches_plain(cuda, hop, c):
    rng = np.random.default_rng(hop + c)
    y = torch.complex(*(torch.as_tensor(rng.standard_normal((c, 9, hop + 2)),
                                        dtype=torch.float32)
                        for _ in range(2))).to(cuda)
    prev = torch.as_tensor(rng.standard_normal((c, hop)),
                           dtype=torch.float32, device=cuda)
    before = kw.wola_synthesis.launches
    out, new_prev = kw.wola_synthesis(y, prev)
    torch.cuda.synchronize()
    assert kw.wola_synthesis.launches == before + 1
    ref_out, ref_prev = kw.wola_synthesis_plain(y, prev)
    assert _rel(out, ref_out) < REL
    assert (new_prev - ref_prev).abs().max() / ref_out.abs().max() < REL


def test_unsupported_modes_raise_on_cuda(cuda):
    x = torch.zeros((2, 4 * 128), device=cuda)
    with pytest.raises(ValueError, match="ROADMAP"):
        kw.wola_analysis(x.double(), torch.zeros((2, 128), device=cuda,
                                                 dtype=torch.float64))
    with pytest.raises(ValueError, match="ROADMAP"):
        kw.wola_analysis(torch.zeros((2, 4 * 96), device=cuda),
                         torch.zeros((2, 96), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        kw.wola_analysis(torch.zeros((8 * 128, 2), device=cuda).T,
                         torch.zeros((2, 128), device=cuda))
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira3.yaml"))
    for eng in (EngineConfig(window_size=128, dtype="float64"),
                EngineConfig(window_size=128, full_fft=True)):
        with pytest.raises(ValueError, match="ROADMAP"):
            run_offline("das", np.zeros((3, 512)), engine=eng,
                        array_cfg=cfg, device="cuda")


def test_das_on_cuda_matches_float64_cpu(cuda):
    cfg = load_array_config(os.path.join(ROOT, "beamform_tpu_torch",
                                         "configs", "aira16.yaml"))
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal((16, 40 * 1024))).astype(np.float32)
    th = np.full(40, 20.0)
    th[20:] = -35.0
    model = get_model("das", EngineConfig(), cfg, device=cuda)
    got = model.process(x, th).cpu().numpy()
    ref = run_offline("das", x, engine=EngineConfig(dtype="float64"),
                      array_cfg=cfg, theta=th, device="cpu")
    # BASELINE budget is 1e-3; float32 round-off here is ~1e-6
    assert np.abs(got - ref).max() <= 1e-5
