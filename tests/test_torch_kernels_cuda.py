"""The port's CUDA kernels against their plain torch twins, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 kernels against float32 twins (or float64 CPU
runs), summed in another order; errors are taken relative to the
largest magnitude of each compared quantity, since heat-current samples
pass through zero.
"""

import numpy as np
import pytest
import torch

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.kernels import block_corr as K2
from sclmd_tpu_torch.kernels import gle_block as K1
from sclmd_tpu_torch.models.harmonic import chain_dynmat

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = (torch.view_as_real(x) if x.is_complex() else x for x in (a, b))
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("ntraj", [1, 70])
def test_block_corr_freq_matches_twin(cuda, ntraj):
    gen = torch.Generator(device=cuda).manual_seed(0)
    khat = torch.randn((33, 90, 90), dtype=torch.complex64, device=cuda,
                       generator=gen)
    hhat = torch.randn((ntraj, 33, 90), dtype=torch.complex64, device=cuda,
                       generator=gen)
    before = K2.launches
    got = K2.block_corr_freq(khat, hhat)
    want = K2.block_corr_freq_plain(khat, hhat)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    assert _rel(got, want) < 1e-5


def _system(device, dtype, ntraj, nph=36, nmd=128, ml=40, constrained=False):
    """Two non-local baths of different widths (6 contiguous DOFs, 4
    scattered ones) on a 36-DOF chain."""
    gwl = np.linspace(0.0, 0.6, 16)
    baths = []
    rng = np.random.default_rng(1)
    for T, cats in ((320.0, range(6)), (280.0, [30, 31, 33, 32])):
        nc = len(cats)
        gam = np.array([np.eye(nc) * 0.02 * np.exp(-(w / 0.3) ** 2)
                        for w in gwl])
        b = TB.phbath(T, cats, 0.3, 32, 0.4, nmd, ml=ml, gamma=gam, gwl=gwl,
                      dtype=dtype, device=device)
        noise = 0.01 * rng.standard_normal((ntraj, nmd, nc))
        baths.append(b.replace(noise=torch.as_tensor(noise, dtype=dtype,
                                                     device=device)))
    mask = torch.ones(nph, dtype=dtype, device=device)
    if constrained:
        mask[[0, 35]] = 0.0
    return TMD.GLESystem(
        dyn=chain_dynmat(nph, 0.05, dtype=dtype).to(device),
        baths=tuple(baths), mask=mask, dt=0.4, nph=nph, ml=ml, nmd=nmd,
        unconstrained=not constrained)


def _card_vs_cpu(cuda, ntraj, constrained, ml):
    """run_segment_blocked with both kernels on the card (float32)
    against the twins on the CPU (float64), 96 steps in blocks of 32."""
    out = {}
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        system = _system(dev, dtype, ntraj, ml=ml, constrained=constrained)
        rng = np.random.default_rng(2)
        st = TMD.initial_state(system, ntraj, dtype=dtype).replace(
            p=torch.as_tensor(0.05 * rng.standard_normal((ntraj, 36)),
                              dtype=dtype, device=dev))
        k1, k2 = K1.launches, K2.launches
        fin, ys = TMD.run_segment_blocked(system, st, 96, t0=7, block=32)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert K1.launches == k1 + 3 and K2.launches == k2 + 6
        out[dev if dev == "cpu" else "cuda"] = (fin, ys)
    (fg, yg), (fc, yc) = out["cuda"], out["cpu"]
    for a, b in ((fg.p, fc.p), (fg.q, fc.q), (fg.phis, fc.phis),
                 (fg.qhis, fc.qhis), (yg["cur"], yc["cur"]),
                 (yg["etot"], yc["etot"])):
        assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("ntraj,constrained,ml", [(3, False, 40),
                                                  (37, False, 12),
                                                  (5, True, 40)])
def test_run_segment_blocked_card_matches_cpu(cuda, ntraj, constrained, ml):
    """Ragged trajectory tiles, baths of different widths, a
    non-contiguous bath, a kernel shorter than the block (ml 12), the
    constrained path without force carry-forward."""
    _card_vs_cpu(cuda, ntraj, constrained, ml)


@pytest.mark.parametrize("tile", [2, 4])
def test_multi_trajectory_tiles_match_cpu(cuda, tile):
    """Enough trajectories that the wrapper picks two or four per CTA
    (it wants about 1.5 CTAs per SM), with a ragged last tile: the
    per-tile indexing of the kernel against the float64 twins."""
    want = (3 * torch.cuda.get_device_properties(cuda)
            .multi_processor_count) // 2
    ntraj = 2 * want + 1 if tile == 2 else 4 * want - 1
    assert ntraj % tile
    assert K1.tile_size(ntraj, 36, 2, 6, cuda) == tile
    _card_vs_cpu(cuda, ntraj, False, 40)
