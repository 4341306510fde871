"""The two slab paths: a silicon slab under Stillinger-Weber forces (kernel
K9) and a gold slab under EAM forces (kernel K10, analytic Sutton-Chen or
its setfl tabulation), each between two wideband phonon baths.

Silicon: ``diamond_cell(12, 6, 6)``, 3,456 atoms (nph 10,368) in their
periodic cell, ``SWDriver`` with a 16-wide table (skin 0.4 angstrom), as
the JAX package's ``scripts/exp_sw_large.py``. Gold: the same layout in
fcc, ``fcc_cell(12, 6, 6, 4.08)``, 1,728 atoms (nph 5,184), ``EAMDriver``
on the published Au set (cutoff 1.7 a, skin 0.3 angstrom), or the same
set through ``sutton_chen_tables("Au")``. The baths sit on the first and
the last conventional cell along x (288 silicon or 144 gold atoms, 864 or
432 DOFs): ``phbath(T (1 +- delta/2), cats, 0.3, 16, dt, nmd, ml=1)`` with
the wideband friction 0.01 I at 16 points up to 0.6, as
``exp_sw_large.py`` builds them; T 300 K, delta 0.1, dt 0.25/0.658, nmd
1024. No dynamical matrix: trajectories start at rest and the baths heat
them. ``nx, ny, nz`` cut the slab for the CPU tests.
"""

import numpy as np
import torch

SI = dict(cells=(12, 6, 6), nn=16, skin=0.4)
AU = dict(cells=(12, 6, 6), a0=4.08, skin=0.3)
NMD, T, DELTA = 1024, 300.0, 0.1
DT = 0.25 / 0.658
GWL = np.linspace(0.0, 0.6, 16)
GAMMA = 0.01


def si_slab(nx: int = 12, ny: int = 6, nz: int = 6):
    """(axyz, cell) of the silicon slab."""
    from sclmd_tpu_torch.models.sw import diamond_cell
    pos, cell = diamond_cell(nx, ny, nz)
    return [["Si", *p] for p in pos], cell


def gold_slab(nx: int = 12, ny: int = 6, nz: int = 6, a0: float = AU["a0"]):
    """(axyz, cell) of the gold slab."""
    from sclmd_tpu_torch.models.eam import fcc_cell
    pos, cell = fcc_cell(nx, ny, nz, a0)
    return [["Au", *p] for p in pos], cell


def slab_driver(kind: str, dtype, device, cells=None):
    """The force driver of a slab: ``kind`` "sw" (K9), "eam" (K10,
    analytic) or "eam_tab" (K10, tabulated)."""
    from sclmd_tpu_torch.models.eam import EAMDriver, sutton_chen_tables
    from sclmd_tpu_torch.models.sw import SWDriver
    if kind == "sw":
        axyz, cell = si_slab(*(cells or SI["cells"]))
        return SWDriver(axyz, cell=cell, max_nnei=SI["nn"],
                        cutoff_skin=SI["skin"], dtype=dtype, device=device)
    axyz, cell = gold_slab(*(cells or AU["cells"]))
    setfl = sutton_chen_tables("Au") if kind == "eam_tab" else None
    return EAMDriver(axyz, setfl=setfl, cell=cell, cutoff_skin=AU["skin"],
                     dtype=dtype, device=device)


def slab_runner(kind: str, dtype, device, outdir, cells=None,
                nmd: int = NMD, seed: int = 11,
                temps=(T * (1 + DELTA / 2), T * (1 - DELTA / 2)),
                driver=None):
    """An ``md.md`` runner of a slab writing to ``outdir``: the driver of
    ``slab_driver(kind, ...)`` (or ``driver``, one already built for the
    same slab) through ``AddPotential`` and the two wideband baths at
    ``temps``."""
    from sclmd_tpu_torch import baths as B
    from sclmd_tpu_torch.md import md

    drv = driver or slab_driver(kind, dtype, device, cells)
    r = md(DT, nmd, T, axyz=drv.axyz, dtype=dtype, seed=seed, outdir=outdir,
           device=device)
    r.AddPotential(drv)
    ny, nz = (cells or (SI if kind == "sw" else AU)["cells"])[1:]
    nlayer = 3 * ny * nz * (8 if kind == "sw" else 4)  # DOFs of one cell
    gam = np.broadcast_to(GAMMA * np.eye(nlayer), (len(GWL), nlayer, nlayer))
    for cats, tt in ((range(nlayer), temps[0]),
                     (range(r.nph - nlayer, r.nph), temps[1])):
        r.AddBath(B.phbath(tt, cats, 0.3, 16, r.dt, r.nmd, ml=1, gamma=gam,
                           gwl=GWL, dtype=dtype, device=device))
    return r
