"""Static padded neighbour tables and the C2-smooth switch (counterparts
of ``sclmd_tpu.models.nnp.build_neighbors`` and ``smooth_switch``; the
neural-network potential of that module is not ported yet).

The table is built once from the reference geometry with a skin and is
never rebuilt during a run: atoms of a junction vibrate around fixed
sites.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def build_neighbors(xyz, cutoff: float, max_nnei: Optional[int],
                    cell: Optional[np.ndarray] = None, skin: float = 0.5,
                    backend: str = "auto"):
    """Padded neighbour table (na, max_nnei) and its mask, from the
    reference geometry: per atom the neighbours within ``cutoff + skin``,
    nearest first. Padding entries point at atom 0 with mask False.

    ``max_nnei=None`` sizes the table to the observed occupancy, rounded
    up to a multiple of 4 (the three-body cost of the many-body
    potentials grows as the square of the width). ``backend``: "numpy" or
    "auto" (both the O(na^2) numpy builder); "native" (the C++ cell
    lists) is not ported and raises.
    """
    if backend == "native":
        raise NotImplementedError(
            "build_neighbors: the native cell-list backend is not ported "
            "(ROADMAP queue 1 item 5); use backend=\"numpy\"")
    if backend not in ("auto", "numpy"):
        raise ValueError(f"build_neighbors: unknown backend {backend!r}")
    x = np.asarray(xyz, dtype=float).reshape(-1, 3)
    na = len(x)
    if max_nnei is None:
        # build with a generous cap, grow it while saturated, then shrink
        # the table to what is occupied
        cap = 64
        while True:
            nbr, mask = build_neighbors(x, cutoff, cap, cell=cell, skin=skin,
                                        backend=backend)
            occ = int(mask.sum(1).max()) if mask.any() else 1
            if occ < cap or cap >= 1024:
                break
            cap *= 2
        nn = max(4, -(-occ // 4) * 4)
        return nbr[:, :nn], mask[:, :nn]
    d = x[None, :, :] - x[:, None, :]
    if cell is not None:
        d -= np.round(d / np.asarray(cell)) * np.asarray(cell)
    r = np.sqrt((d ** 2).sum(-1))
    np.fill_diagonal(r, np.inf)
    nbr = np.full((na, max_nnei), -1, dtype=np.int64)
    for i in range(na):
        js = np.nonzero(r[i] < cutoff + skin)[0]
        js = js[np.argsort(r[i][js])][:max_nnei]
        nbr[i, : len(js)] = js
    mask = nbr >= 0
    return np.where(mask, nbr, 0), mask


def smooth_switch(r: torch.Tensor, r_on: float, r_cut: float) -> torch.Tensor:
    """C2-smooth switching function: 1 below r_on, 0 above r_cut."""
    u = ((r - r_on) / (r_cut - r_on)).clamp(0.0, 1.0)
    return 1.0 - 6 * u ** 5 + 15 * u ** 4 - 10 * u ** 3
