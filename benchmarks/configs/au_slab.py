"""au_slab: a gold slab under Sutton-Chen EAM forces between two wideband
phonon baths (the gold slab of the port's ``tools/slab.py``): the EAM
force (kernel K10 on the card, analytic, twice a step) and the bath force
on 5,184-wide vectors (K7 staged, three times a step).

``build`` makes the program's runner through its public API from the
sizes of ``au_slab.json``: its ``cells`` (12 x 6 x 6 conventional fcc
cells; the CPU tests cut them), the published Au set with its cutoff,
the table's skin, and the baths. The geometry and the baths' DOF lists
are this file's own, so the program and the reference get the same atoms
in the same order.
"""

import numpy as np

from benchmarks.configs.si_slab import friction_table

# the four atoms of a conventional fcc cell, in quarters of a0
BASIS = np.array([[0, 0, 0], [0, 2, 2], [2, 0, 2], [2, 2, 0]], float) / 4.0
# the Sutton-Chen set as the driver takes it: the rest of the block is
# the truncation
SC_KEYS = ("eps", "a", "n", "m", "c")


def geometry(cfg):
    """(axyz rows [element, x, y, z], periodic cell lengths (3,)): the
    cells in x-major order, so the first ny nz cells are the first
    layer along x."""
    nx, ny, nz = cfg["cells"]
    a0 = cfg["a0"]
    offs = np.array([[i, j, k] for i in range(nx) for j in range(ny)
                     for k in range(nz)], float)
    pos = ((offs[:, None, :] + BASIS[None]) * a0).reshape(-1, 3)
    return ([[cfg["element"], *map(float, p)] for p in pos],
            np.array([nx, ny, nz], float) * a0)


def partition(cfg):
    """DOF lists (left, right) of the baths: the first and the last
    ``bath_cells`` layers of cells along x."""
    _, ny, nz = cfg["cells"]
    nph = 3 * len(BASIS) * int(np.prod(cfg["cells"]))
    n = 3 * len(BASIS) * ny * nz * cfg["wideband_baths"]["bath_cells"]
    return list(range(n)), list(range(nph - n, nph))


def build(cfg, device, dtype, seed, outdir):
    """The program's ``md`` runner of the slab, writing to ``outdir``."""
    from sclmd_tpu_torch import baths as B
    from sclmd_tpu_torch.md import md
    from sclmd_tpu_torch.models.eam import EAMDriver

    axyz, cell = geometry(cfg)
    left, right = partition(cfg)
    r = md(cfg["dt"], cfg["nmd"], cfg["T"], axyz=axyz, dtype=dtype,
           seed=seed, outdir=outdir, device=device)
    sc = cfg["sutton_chen"]
    drv = EAMDriver(axyz, cell=cell, cutoff_skin=cfg["neighbours"]["skin"],
                    params={k: sc[k] for k in SC_KEYS}, rcut=sc["rcut"],
                    dtype=dtype, device=device)
    # the driver's switch has a fixed width
    r_on = drv.energy_fn.terms["r_on"]
    if abs(sc["rcut"] - sc["switch_width"] - r_on) > 1e-12:
        raise ValueError(f"au_slab: the program switches from {r_on} "
                         f"angstrom, the configuration from "
                         f"{sc['rcut'] - sc['switch_width']}")
    r.AddPotential(drv)
    wb = cfg["wideband_baths"]
    gwl, _ = friction_table(cfg)
    T, d = cfg["T"], cfg["delta"]
    for cats, tt in ((left, T * (1 + d / 2)), (right, T * (1 - d / 2))):
        gam = np.broadcast_to(wb["gamma"] * np.identity(len(cats)),
                              (len(gwl), len(cats), len(cats)))
        r.AddBath(B.phbath(tt, cats, wb["debye"], wb["nw"], r.dt, r.nmd,
                           ml=wb["ml"], gamma=gam, gwl=gwl, dtype=dtype,
                           device=device))
    return r
