"""Junction set-up helpers (counterpart of ``sclmd_tpu.utils.junction``,
the geometric lead partition; numpy only)."""

from __future__ import annotations

import numpy as np


def partition_by_axis(axyz, axis: int = 0, frac_fixed: float = 0.0995,
                      frac_lead: float = 0.2488):
    """Split atoms into [fixed | lead L | device | lead R | fixed] along a
    coordinate axis.

    Returns a dict with atom index arrays (``fixed_atoms``, ``leadl``,
    ``leadr``, ``device``) and flat DOF lists (``fixdofs``, ``ecatsl``,
    ``ecatsr``) in the 3*i..3*i+2 convention. The defaults give 20 fixed
    and 50 lead atoms on each side of a 201-atom junction."""
    na = len(axyz)
    coord = np.array([a[1 + axis] for a in axyz], dtype=float)
    order = np.argsort(coord, kind="stable")
    nfix = max(2, round(frac_fixed * na))
    nlead = max(2, round(frac_lead * na))
    if 2 * (nfix + nlead) >= na:
        raise ValueError("partition_by_axis: fractions leave no device")

    def dofs(atoms):
        return sorted(int(d) for i in atoms
                      for d in range(3 * i, 3 * i + 3))

    fixed = np.concatenate([order[:nfix], order[-nfix:]])
    leadl = order[nfix:nfix + nlead]
    leadr = order[-nfix - nlead:-nfix]
    device = order[nfix + nlead:-nfix - nlead]
    return dict(fixed_atoms=fixed, leadl=leadl, leadr=leadr,
                device=device, fixdofs=dofs(order[:nfix]) +
                dofs(order[-nfix:]), ecatsl=dofs(leadl),
                ecatsr=dofs(leadr))
