"""A periodic graphene sheet under a single-element Tersoff driver: the
runner path of kernel K8 (``TersoffDriver`` in float32 on the card).

The sheet is ``graphene_ribbon(NX, NY)`` (NX even) closed by its lattice
cell, NX * 1.5 a by NY * sqrt(3) a in the plane and 20 angstrom across
it: 192 carbons, nph 576, every atom three bonds, no edge. Two electron
baths with friction I / (100 fs) sit on the two columns of atoms at x = 0
and at half the cell, at T (1 +- delta/2), T 300 K, delta 0.1, wmax 1.0,
nw 500; dt 0.25/0.658, nmd 1024, as the flagship junction
(``tools.flagship``). No dynamical matrix: trajectories start at rest
and the baths heat them.
"""

import numpy as np
import torch

NX, NY, A = 12, 8, 1.42
NMD, T, DELTA = 1024, 300.0, 0.1
DT = 0.25 / 0.658
DAMP = 100 / 0.658211814201041          # 100 fs in natural time units


def sheet(nx: int = NX, ny: int = NY, a: float = A):
    """(axyz, cell) of the periodic sheet."""
    from sclmd_tpu_torch.models.tersoff import graphene_ribbon

    cell = np.array([nx * 1.5 * a, ny * np.sqrt(3) * a, 20.0])
    return [["C", *row] for row in graphene_ribbon(nx, ny, a)], cell


def sheet_runner(dtype, device, outdir, nx: int = NX, ny: int = NY,
                 nmd: int = NMD, seed: int = 11,
                 temps=(T * (1 + DELTA / 2), T * (1 - DELTA / 2))):
    """An ``md.md`` runner of the sheet writing to ``outdir``, with the
    Tersoff driver through ``AddPotential`` (kernel K8 in float32 on the
    card) and its two baths at ``temps``."""
    from sclmd_tpu_torch import baths as B
    from sclmd_tpu_torch.md import md
    from sclmd_tpu_torch.models.tersoff import TersoffDriver

    axyz, cell = sheet(nx, ny)
    r = md(DT, nmd, T, axyz=axyz, dtype=dtype, seed=seed, outdir=outdir,
           device=device)
    r.AddPotential(TersoffDriver(axyz, cell=cell, dtype=dtype,
                                 device=device))
    x = np.array([p[1] for p in axyz])
    step = 1.5 * A
    for x0, tt in zip((0.0, (nx // 2) * step), temps):
        atoms = np.nonzero((x >= x0 - 0.1) & (x < x0 + step - 0.1))[0]
        cats = (3 * atoms[:, None] + np.arange(3)).ravel()
        eta = (1.0 / DAMP) * np.identity(len(cats))
        r.AddBath(B.ebath(cats, tt, r.dt, r.nmd, wmax=1.0, nw=500,
                          efric=eta, dtype=dtype, device=device))
    return r
