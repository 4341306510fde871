"""si_slab: a silicon slab under Stillinger-Weber forces between two
wideband phonon baths (the JAX package's ``scripts/exp_sw_large.py``):
the SW force (kernel K9 on the card, twice a step) and the bath force
on 10,368-wide vectors (K7's unstaged route, three times a step).

``build`` makes the program's runner through its public API from the
sizes of ``si_slab.json``: its ``cells`` (12 x 6 x 6 conventional
diamond cells; the CPU tests cut them), the SW set, the table's slots
and skin, and the baths. The geometry and the baths' DOF lists are this
file's own, so the program and the reference get the same atoms in the
same order.
"""

import numpy as np

# the eight atoms of a conventional diamond cell, in quarters of a0
BASIS = np.array([[0, 0, 0], [0, 2, 2], [2, 0, 2], [2, 2, 0],
                  [1, 1, 1], [1, 3, 3], [3, 1, 3], [3, 3, 1]], float) / 4.0


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


def friction_table(cfg):
    """(gwl, scale): Gamma(gwl_k) = scale_k I."""
    wb = cfg["wideband_baths"]
    gwl = np.linspace(0.0, wb["table_wmax"], wb["table_points"])
    return gwl, np.full(len(gwl), wb["gamma"])


def build(cfg, device, dtype, seed, outdir):
    """The program's ``md`` runner of the slab, writing to ``outdir``."""
    from sclmd_tpu_torch import baths as B
    from sclmd_tpu_torch.md import md
    from sclmd_tpu_torch.models.sw import SWDriver

    axyz, cell = geometry(cfg)
    left, right = partition(cfg)
    r = md(cfg["dt"], cfg["nmd"], cfg["T"], axyz=axyz, dtype=dtype,
           seed=seed, outdir=outdir, device=device)
    nb = cfg["neighbours"]
    r.AddPotential(SWDriver(axyz, cell=cell, max_nnei=nb["slots"],
                            cutoff_skin=nb["skin"], dtype=dtype,
                            params=dict(cfg["sw"]), device=device))
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
