"""Junction set-up helpers (counterpart of ``sclmd_tpu.utils.junction``):
the geometric lead partition (numpy only) and the re-relaxation of an
imported structure for the model that drives it here."""

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


def relax_for_model(axyz, make_driver, fixed_atoms=None, tol: float = 5e-3,
                    maxit: int = 2000, iters: int = 2,
                    method: str = "lbfgs"):
    """Relax a structure for the model built by ``make_driver`` (a
    callable axyz -> driver with ``.energy_fn``), holding ``fixed_atoms``
    frozen. ``method``: "lbfgs" (default) or "fire". Float64 on the CPU,
    whatever device the driver was built for.

    ``iters`` rounds of rebuild and relax: a driver that takes rest
    geometry from its input (the C/H terminator springs) shifts its
    minimum when rebuilt, so one more round converges again.
    Returns (axyz_relaxed, fmax, steps_of_last_round)."""
    from sclmd_tpu_torch.models import relax as R

    relaxer = R.lbfgs_relax if method == "lbfgs" else R.fire_relax
    x = np.array([a[1:] for a in axyz], dtype=float)
    mask = np.zeros(x.shape, bool)
    if fixed_atoms is not None:
        mask[np.asarray(fixed_atoms, int)] = True
    out = list(axyz)
    fmax, nit = np.inf, 0
    for _ in range(max(1, iters)):
        drv = make_driver(out)
        x, fmax, nit = relaxer(drv.energy_fn, x, tol=tol, maxit=maxit,
                               fixed_mask=mask)
        out = [[a[0]] + list(p) for a, p in zip(out, x)]
    return out, fmax, nit
