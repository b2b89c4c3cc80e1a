"""Tests that need an NVIDIA card: the remap_banded CUDA kernel against its
plain PyTorch version, and the port's model on the card against the CPU.
They skip without CUDA.  This file imports no jax, so on the card's
machine it runs on its own:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.ops import remap as tremap  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.remap import remap_banded  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _column(lead, K, band, seed):
    """(pe1, pe2, fields): pe2 displaced smoothly by up to 0.9 x band/2
    layers (interfaces at fractional source index k + a sin(pi k / K)),
    so target layers stay comparable to source layers; a sorted random
    displacement makes near-empty target layers, whose f32 remap is
    ill-conditioned (the plain f32 version then differs from f64 by ~1e-4
    relative)."""
    rng = np.random.default_rng(seed)
    dp1 = rng.uniform(0.5, 1.5, lead + (K,))
    pe1 = np.concatenate([np.zeros(lead + (1,)), np.cumsum(dp1, -1)], -1)
    amp = rng.uniform(-1.0, 1.0, lead + (1,)) * 0.45 * min(band, K - 1)
    k = np.arange(K + 1)
    x = k + amp * np.sin(np.pi * k / K)
    idx = np.clip(np.floor(x).astype(int), 0, K - 1)
    pe2 = (np.take_along_axis(pe1, idx, -1)
           + (x - idx) * np.take_along_axis(dp1, idx, -1))
    pe2[..., 0], pe2[..., -1] = pe1[..., 0], pe1[..., -1]
    qs = [(100.0 * (rng.standard_normal(lead + (K,)) + 5.0)).astype(np.float32)
          for _ in range(4)]
    return pe1.astype(np.float32), pe2.astype(np.float32), qs


@pytest.mark.parametrize("lead,K,n,band", [((6, 7, 5), 16, 2, 6),
                                           ((6, 6, 7), 16, 1, 6),
                                           ((3, 5, 4), 9, 4, 3),
                                           ((2, 3), 2, 1, 6)])
def test_kernel_matches_plain(cuda, lead, K, n, band):
    pe1, pe2, qs = _column(lead, K, band, seed=11)
    qd = [torch.from_numpy(q).to(cuda) for q in qs[:n]]
    p1, p2 = torch.from_numpy(pe1).to(cuda), torch.from_numpy(pe2).to(cuda)
    before = remap_banded.launches
    got = remap_banded(qd, p1, p2, band=band)
    torch.cuda.synchronize()
    assert remap_banded.launches == before + 1
    want = tremap.remap_fields_banded(qd, p1, p2, band=band)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_kernel_rejects_bad_inputs(cuda):
    pe1, pe2, qs = _column((4,), 8, 6, seed=13)
    q = torch.from_numpy(qs[0]).to(cuda)
    p1, p2 = torch.from_numpy(pe1).to(cuda), torch.from_numpy(pe2).to(cuda)
    with pytest.raises(TypeError):
        remap_banded([q.double()], p1, p2)
    with pytest.raises(ValueError):
        remap_banded([q[:, :7]], p1, p2)
    with pytest.raises(ValueError):
        remap_banded([q.t().contiguous().t()], p1, p2)
    with pytest.raises(ValueError):
        remap_banded([q] * 5, p1, p2)


def test_model_on_card_matches_cpu(cuda):
    """3 steps at c12-L8 from one numpy state, on the card (through the
    kernel: 3 launches per step) and on the CPU (plain version)."""
    cfg = DycoreConfig(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6)
    m_cpu = build_model(cfg, "cpu")
    m_gpu = build_model(cfg, cuda)
    start = state_to_numpy(m_cpu.init(perturb=3.0))
    a = state_to_numpy(m_cpu.run(state_from_numpy(start, "cpu"), 3))
    before = remap_banded.launches
    b = state_to_numpy(m_gpu.run(state_from_numpy(start, cuda), 3))
    assert remap_banded.launches == before + 9
    for f in ("u", "v", "delp", "pt", "ps"):
        scale = float(np.abs(a[f]).max())
        atol = 6e-3 if f in ("u", "v") else 0.0
        assert float(np.abs(a[f] - b[f]).max()) <= max(1e-4 * scale, atol), f


def test_model_rejects_unported_option_on_card(cuda):
    cfg = dataclasses.replace(DycoreConfig(npx=12, npz=8), hydrostatic=False)
    with pytest.raises(NotImplementedError):
        build_model(cfg, cuda)
