"""The `primary` junction of the JAX package's bench.py (bench.py:93-115,
:249-308) at its full widths: a 100-atom harmonic chain (nph 300), two
non-local phonon baths of 90 DOFs with 1000 memory taps, nmd 2048,
dt 0.25/0.658, T 300 K +- 5 %, block 256.
"""

import numpy as np
import torch

NATOMS, ML, NMD, NC = 100, 1000, 2048, 90
NPH = 3 * NATOMS
DT, T, DELTA = 0.25 / 0.658, 300.0, 0.1
BLOCK = 256


def primary_baths(dtype, device):
    """The two phonon baths of the primary junction (bench.py:109-114)."""
    from sclmd_tpu_torch import baths as B

    gwl = np.linspace(0.0, 0.6, 64)
    gam = np.array([np.eye(NC) * 0.01 * np.exp(-(w / 0.25) ** 2)
                    for w in gwl])
    return [B.phbath(T * (1 + s * DELTA / 2), dofs, 0.3, 128, DT, NMD,
                     ml=ML, gamma=gam, gwl=gwl, dtype=dtype, device=device)
            for s, dofs in ((1, range(NC)), (-1, range(NPH - NC, NPH)))]


def primary_runner(dtype, device, outdir):
    """An ``md.md`` runner of the primary junction writing to ``outdir``."""
    from sclmd_tpu_torch.md import md
    from sclmd_tpu_torch.models.harmonic import chain_dynmat

    r = md(DT, NMD, T, dyn=chain_dynmat(NPH, 0.04).numpy(),
           axyz=[["C", 1.4 * i, 0, 0] for i in range(NATOMS)],
           dtype=dtype, outdir=outdir, block=BLOCK, device=device)
    for b in primary_baths(dtype, device):
        r.AddBath(b)
    return r


def block_operands(r, ntraj: int, seed: int, gen: torch.Generator):
    """K1's operands for one block of the primary junction: a thermal
    start, real colored noise, and the K2 tails of a random history.
    Returns (system, args of ``gle_block``, per-bath (khat, hhat))."""
    from sclmd_tpu_torch.kernels import gle_block as K1
    from sclmd_tpu_torch.md import _next_pow2
    from sclmd_tpu_torch.parallel.ensemble import bath_factors, draw_chunk

    dev = r.device
    system = r._build_system()
    facs = bath_factors(r.baths, dev)
    noises, st = draw_chunk(facs, seed, 0, ntraj, DT, NMD,
                            r._thermal_start(T), system)
    nfft = _next_pow2(ML + BLOCK + 2)
    ops, corr = [], []
    for b, nz in zip(r.baths, noises):
        khat = torch.fft.rfft(torch.nn.functional.pad(
            b.kernel, (0, 0, 0, 0, 0, nfft - ML)), dim=0).contiguous()
        hist = 0.05 * torch.randn((ntraj, ML - 1, NC), device=dev,
                                  generator=gen)
        corr.append((khat, torch.fft.rfft(hist, n=nfft, dim=1).contiguous()))
        kin = b.block_tap_kernel(BLOCK)
        ops.append(K1.BathOperands(
            nz,
            b.block_corr(hist, BLOCK, khat, nfft).contiguous(),
            kin, K1.tap_major(kin, BLOCK), b.kernel[0].contiguous(), b.cols,
            torch.as_tensor(b.cids, dtype=torch.int32, device=dev)))
    args = (st.p, st.q, system.potential_force(st.q), system.dyn,
            system.mask, ops, 3, NMD, DT, True, BLOCK)
    return system, args, corr
