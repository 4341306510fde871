"""Embedded-atom-method (EAM) potentials (counterpart of
``sclmd_tpu.models.eam``).

    E  =  1/2 sum_{i != j} phi_{t_i t_j}(r_ij)  +  sum_i F_{t_i}(rho_i)
    rho_i = sum_{j != i} rho_{t_j}(r_ij)

Two parameterisations:

- **Analytic Sutton-Chen** (Sutton & Chen, Philos. Mag. Lett. 61, 139
  (1990)): phi = eps (a/r)^n, rho = (a/r)^m, F = -eps c sqrt(rho), with
  the published fcc-metal sets below. A C2-smooth switch truncates both
  phi and rho at ``rcut`` so forces and the Hessian stay smooth.
- **Tabulated DYNAMO/LAMMPS ``setfl`` files** (``pair_style eam/alloy``
  format): F(rho), rho(r) per element and r*phi(r) per element pair on
  uniform grids, evaluated through natural cubic splines made once on
  the host. ``write_setfl`` exports any analytic set.

Energies take positions (..., na, 3) in angstrom with leading batch axes
and return eV per leading index. On the card in float32 the force of
``EAMDriver`` is kernel K10 (``kernels.eam_force``, both routes), whose
plain twin is the autograd of these functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.models.driver import Consts, DriverShell

# published Sutton-Chen fcc parameter sets (public constants);
# eps in eV, a = fcc lattice constant in Ang, c dimensionless
SUTTON_CHEN_PARAMS = {
    "Ni": dict(eps=1.5707e-2, a=3.52, n=9, m=6, c=39.432),
    "Cu": dict(eps=1.2382e-2, a=3.61, n=9, m=6, c=39.432),
    "Rh": dict(eps=4.9371e-3, a=3.80, n=12, m=6, c=144.41),
    "Pd": dict(eps=4.1790e-3, a=3.89, n=12, m=7, c=108.27),
    "Ag": dict(eps=2.5415e-3, a=4.09, n=12, m=6, c=144.41),
    "Ir": dict(eps=2.4489e-3, a=3.84, n=14, m=6, c=334.94),
    "Pt": dict(eps=1.9833e-2, a=3.92, n=10, m=8, c=34.408),
    "Au": dict(eps=1.2793e-2, a=4.08, n=10, m=8, c=34.408),
    "Al": dict(eps=3.3147e-2, a=4.05, n=7, m=6, c=16.399),
    "Pb": dict(eps=5.5765e-3, a=4.95, n=10, m=7, c=45.778),
}


def fcc_cell(nx: int, ny: int, nz: int, a0: float):
    """fcc slab of nx x ny x nz conventional cells.

    Returns (positions (na, 3) Ang, cell (3,) lengths for the periodic
    wrap)."""
    basis = np.array([[0, 0, 0], [0, 2, 2], [2, 0, 2], [2, 2, 0]],
                     dtype=float) * (a0 / 4.0)
    pos = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                off = np.array([i, j, k], dtype=float) * a0
                pos.extend(basis + off)
    cell = np.array([nx, ny, nz], dtype=float) * a0
    return np.array(pos), cell


def _geometry(x, k):
    """(r, mask) of the padded table; masked entries get r = 1 from a
    masked square root."""
    d = x[..., k["nbr"], :] - x[..., :, None, :]            # (..., na, nn, 3)
    if "cell" in k:
        d = d - torch.round(d / k["cell"]) * k["cell"]
    r2 = (d * d).sum(-1)
    return torch.sqrt(torch.where(k["mask"], r2, torch.ones_like(r2)))


def _table_consts(neighbors, nmask, cell, **extra) -> Consts:
    arrays = dict(nbr=np.asarray(neighbors).astype(np.int64),
                  mask=np.asarray(nmask).astype(bool), **extra)
    if cell is not None:
        arrays["cell"] = np.asarray(cell, float)
    return Consts(**arrays)


# ---------------------------------------------------------------------------
# analytic Sutton-Chen
# ---------------------------------------------------------------------------
def sutton_chen_energy(element: str, neighbors, nmask,
                       cell: Optional[np.ndarray] = None,
                       params: Optional[dict] = None,
                       rcut: Optional[float] = None,
                       switch_width: float = 0.5):
    """Energy-function factory for a single-element Sutton-Chen system:
    returns ``energy(x)`` (x (..., na, 3) Ang -> eV) over a static padded
    neighbour table (``models.nnp.build_neighbors``)."""
    from sclmd_tpu_torch.models.nnp import smooth_switch

    p = dict(SUTTON_CHEN_PARAMS[element]) if params is None else dict(params)
    consts = _table_consts(neighbors, nmask, cell)
    eps, a, c = p["eps"], p["a"], p["c"]
    n, m = p["n"], p["m"]
    rc = float(rcut if rcut is not None else p.get("rcut", 1.7 * a))
    r_on = rc - switch_width

    def energy(x):
        k = consts.on(x)
        r = _geometry(x, k)
        sw = smooth_switch(r, r_on, rc)
        ar = a / r
        w = torch.where(k["mask"] & (r < rc), sw, torch.zeros_like(sw))
        e_pair = 0.5 * eps * (w * ar ** n).sum((-2, -1))
        rho = (w * ar ** m).sum(-1)                          # (..., na)
        pos = rho > 0.0
        e_emb = -eps * c * (torch.sqrt(torch.where(
            pos, rho, torch.ones_like(rho))) * pos).sum(-1)
        return e_pair + e_emb

    energy.terms = dict(kind="analytic", params=p, rcut=rc, r_on=r_on,
                        nbr=consts._np["nbr"], mask=consts._np["mask"],
                        cell=consts._np.get("cell"))
    return energy


# ---------------------------------------------------------------------------
# natural cubic splines on uniform grids (host precompute, device eval)
# ---------------------------------------------------------------------------
def _natural_cubic_coefs(y: np.ndarray, h: float) -> np.ndarray:
    """(nseg, 4) coefficients [a, b, c, d] of the natural cubic spline
    through uniform samples y (value = a + b t + c t^2 + d t^3 with
    t = x - x_left on each segment). Thomas-algorithm tridiagonal
    solve; one-time host cost."""
    y = np.asarray(y, float)
    npts = len(y)
    if npts < 3:
        b = np.diff(y) / h
        return np.stack([y[:-1], b, np.zeros_like(b),
                         np.zeros_like(b)], axis=1)
    # second derivatives M, natural ends M[0] = M[-1] = 0
    rhs = 6.0 * (y[:-2] - 2.0 * y[1:-1] + y[2:]) / (h * h)
    ni = npts - 2
    cp = np.empty(ni)
    dp = np.empty(ni)
    cp[0] = 1.0 / 4.0
    dp[0] = rhs[0] / 4.0
    for i in range(1, ni):
        den = 4.0 - cp[i - 1]
        cp[i] = 1.0 / den
        dp[i] = (rhs[i] - dp[i - 1]) / den
    mi = np.empty(ni)
    mi[-1] = dp[-1]
    for i in range(ni - 2, -1, -1):
        mi[i] = dp[i] - cp[i] * mi[i + 1]
    M = np.zeros(npts)
    M[1:-1] = mi
    a0 = y[:-1]
    b0 = np.diff(y) / h - h * (2.0 * M[:-1] + M[1:]) / 6.0
    c0 = M[:-1] / 2.0
    d0 = (M[1:] - M[:-1]) / (6.0 * h)
    return np.stack([a0, b0, c0, d0], axis=1)


def _spline_eval(coefs, h, x, sel):
    """Evaluate stacked splines: coefs (K, nseg, 4), sel an integer tensor
    (broadcast against x) choosing the table; past the last knot the end
    segment extrapolates."""
    nseg = coefs.shape[1]
    idx = torch.clamp((x / h).to(torch.int32), 0, nseg - 1).long()
    t = x - idx.to(x.dtype) * h
    cc = coefs[sel, idx]                                    # (..., 4)
    return ((cc[..., 3] * t + cc[..., 2]) * t + cc[..., 1]) * t \
        + cc[..., 0]


# ---------------------------------------------------------------------------
# DYNAMO/LAMMPS setfl (eam/alloy) tables
# ---------------------------------------------------------------------------
def read_setfl(path: str) -> dict:
    """Parse a DYNAMO ``setfl`` file (LAMMPS ``pair_style eam/alloy``).

    Returns dict with: elements (list), mass (nel,), nrho, drho, nr,
    dr, cutoff, F (nel, nrho), rho (nel, nr), rphi (npair, nr) in
    LAMMPS pair order (i, j<=i), pair_index (nel, nel) into rphi.
    """
    with open(path) as fh:
        lines = fh.read().split("\n")
    toks = " ".join(lines[3:]).split()
    pos = 0

    def take(k):
        nonlocal pos
        out = toks[pos:pos + k]
        pos += k
        return out

    nel = int(take(1)[0])
    elements = take(nel)
    nrho, drho, nr, dr, cutoff = take(5)
    nrho, nr = int(nrho), int(nr)
    drho, dr, cutoff = float(drho), float(dr), float(cutoff)
    F = np.empty((nel, nrho))
    rho = np.empty((nel, nr))
    mass = np.empty(nel)
    for e in range(nel):
        _zn, ms, _lat, _struct = take(4)
        mass[e] = float(ms)
        F[e] = np.array(take(nrho), float)
        rho[e] = np.array(take(nr), float)
    npair = nel * (nel + 1) // 2
    rphi = np.empty((npair, nr))
    pair_index = np.zeros((nel, nel), np.int32)
    k = 0
    for i in range(nel):
        for j in range(i + 1):
            rphi[k] = np.array(take(nr), float)
            pair_index[i, j] = pair_index[j, i] = k
            k += 1
    return dict(elements=list(elements), mass=mass, nrho=nrho,
                drho=drho, nr=nr, dr=dr, cutoff=cutoff, F=F, rho=rho,
                rphi=rphi, pair_index=pair_index)


def write_setfl(path: str, elements, mass, F, rho, rphi, drho, dr,
                cutoff, comment="generated by sclmd_tpu_torch.models.eam"):
    """Write a DYNAMO ``setfl`` file (inverse of read_setfl); rphi in
    LAMMPS pair order (i, j<=i). Makes any analytic set usable from
    LAMMPS ``pair_style eam/alloy``."""
    F = np.asarray(F)
    rho = np.asarray(rho)
    rphi = np.asarray(rphi)
    nel, nrho = F.shape
    nr = rho.shape[1]
    with open(path, "w") as fh:
        fh.write(comment + "\n\n\n")
        fh.write("%d %s\n" % (nel, " ".join(elements)))
        fh.write("%d %.16e %d %.16e %.10f\n"
                 % (nrho, drho, nr, dr, cutoff))
        for e in range(nel):
            zn = U.PeriodicTable.get(elements[e], 0)
            fh.write("%d %.6f 0.0 fcc\n" % (zn, mass[e]))
            for arr in (F[e], rho[e]):
                for i in range(0, len(arr), 5):
                    fh.write(" ".join("%.16e" % v
                                      for v in arr[i:i + 5]) + "\n")
        for k in range(nel * (nel + 1) // 2):
            for i in range(0, nr, 5):
                fh.write(" ".join("%.16e" % v
                                  for v in rphi[k][i:i + 5]) + "\n")


def sutton_chen_tables(element, nr=2000, nrho=2000,
                       rcut=None, switch_width=0.5, rho_max=None,
                       params=None):
    """Tabulate an analytic Sutton-Chen set on setfl grids (the
    smooth-switch truncation applied, so tabulated == analytic)."""
    p = dict(SUTTON_CHEN_PARAMS[element]) if params is None else dict(params)
    eps, a, c = p["eps"], p["a"], p["c"]
    rc = float(rcut if rcut is not None else 1.7 * a)
    dr = rc / (nr - 1)
    r = np.arange(nr) * dr
    rs = np.where(r > 1e-6, r, 1e-6)
    u = np.clip((r - (rc - switch_width)) / switch_width, 0.0, 1.0)
    sw = 1.0 - 6 * u ** 5 + 15 * u ** 4 - 10 * u ** 3
    phi = eps * (a / rs) ** p["n"] * sw
    rho_r = (a / rs) ** p["m"] * sw
    # clamp the r->0 divergence so splines stay sane below the first
    # physical neighbor distance (never sampled in MD)
    rmin = 0.35 * a
    phi = np.where(r < rmin, eps * (a / rmin) ** p["n"], phi)
    rho_r = np.where(r < rmin, (a / rmin) ** p["m"], rho_r)
    if rho_max is None:
        rho_max = 3.0 * 12.0 * (a / (a / np.sqrt(2.0))) ** p["m"]
    drho = rho_max / (nrho - 1)
    rho_grid = np.arange(nrho) * drho
    F = -eps * c * np.sqrt(rho_grid)
    return dict(elements=[element], mass=np.array([0.0]), nrho=nrho,
                drho=drho, nr=nr, dr=dr, cutoff=rc, F=F[None],
                rho=rho_r[None], rphi=(r * phi)[None],
                pair_index=np.zeros((1, 1), np.int32))


def eam_tabulated_energy(table: dict, types, neighbors, nmask,
                         cell: Optional[np.ndarray] = None):
    """Energy-function factory from setfl tables (multi-element):
    returns ``energy(x)`` evaluating F/rho/r*phi through natural cubic
    splines. ``types`` maps each atom to its element row in the table.
    """
    nbr = np.asarray(neighbors).astype(np.int64)
    t_np = np.asarray(types, np.int32)
    tj = t_np[nbr]                                          # (na, nn)
    pidx = np.asarray(table["pair_index"])[t_np[:, None], tj]
    dr, drho, rc = table["dr"], table["drho"], table["cutoff"]
    coefs = dict(
        F_c=np.stack([_natural_cubic_coefs(f, drho) for f in table["F"]]),
        rho_c=np.stack([_natural_cubic_coefs(g, dr) for g in table["rho"]]),
        rphi_c=np.stack([_natural_cubic_coefs(g, dr)
                         for g in table["rphi"]]))
    consts = _table_consts(nbr, nmask, cell, ti=t_np.astype(np.int64),
                           tj=tj.astype(np.int64),
                           pidx=pidx.astype(np.int64), **coefs)

    def energy(x):
        k = consts.on(x)
        r = _geometry(x, k)
        w = torch.where(k["mask"] & (r < rc), torch.ones_like(r),
                        torch.zeros_like(r))
        rho_i = (w * _spline_eval(k["rho_c"], dr, r, k["tj"])).sum(-1)
        rphi = _spline_eval(k["rphi_c"], dr, r, k["pidx"])
        e_pair = 0.5 * (w * rphi / r).sum((-2, -1))
        e_emb = _spline_eval(k["F_c"], drho, rho_i, k["ti"]).sum(-1)
        return e_pair + e_emb

    energy.terms = dict(kind="tabulated", table=table, types=t_np,
                        nbr=nbr, mask=consts._np["mask"],
                        cell=consts._np.get("cell"), dr=dr, drho=drho,
                        rcut=rc, pair_index=pidx, **coefs)
    return energy


class EAMDriver(DriverShell):
    """Force driver for an EAM metal (the JAX package's signature, plus
    ``device``, default the CUDA card).

    ``setfl``: path to a LAMMPS eam/alloy file (or a read_setfl dict)
    for tabulated multi-element systems; otherwise the analytic
    Sutton-Chen set for the (single) element is used. ``rcut`` and
    ``params`` configure the analytic set only — with ``setfl`` the
    table's own cutoff is authoritative, so combining them is an error
    rather than a silent ignore.

    In float32 the forces of both routes go through kernel K10
    (``kernels.eam_force``) on the card, whose f0 is the kernel's own
    force at q = 0, and through its autograd twin on CPU tensors (powers
    n and m that are not small integers take powf in the kernel); float64
    keeps the autograd of the energy on either device."""

    def __init__(self, axyz, setfl=None, cutoff_skin=0.3, max_nnei=None,
                 cell=None, dtype=torch.float64, params=None, rcut=None,
                 device=None):
        from sclmd_tpu_torch.models.nnp import build_neighbors

        els = [a[0] for a in axyz]
        x0 = np.array([a[1:] for a in axyz], dtype=float)
        if setfl is not None:
            if rcut is not None or params is not None:
                raise ValueError(
                    "rcut=/params= apply to the analytic Sutton-Chen "
                    "path only; the setfl table fixes its own cutoff "
                    "and functions")
            table = setfl if isinstance(setfl, dict) else read_setfl(setfl)
            missing = sorted(set(els) - set(table["elements"]))
            if missing:
                raise ValueError(f"setfl lacks elements {missing}")
            types = np.array([table["elements"].index(e) for e in els],
                             np.int32)
            rc = table["cutoff"]
            nbr, nmask = build_neighbors(x0, rc, max_nnei, cell=cell,
                                         skin=cutoff_skin)
            efn = eam_tabulated_energy(table, types, nbr, nmask,
                                       cell=cell)
            self.table = table
        else:
            uniq = sorted(set(els))
            if len(uniq) != 1:
                raise NotImplementedError(
                    "analytic Sutton-Chen is single-element; pass a "
                    "setfl table for alloys")
            p = dict(SUTTON_CHEN_PARAMS[uniq[0]]) if params is None \
                else dict(params)
            rc = float(rcut if rcut is not None
                       else p.get("rcut", 1.7 * p["a"]))
            nbr, nmask = build_neighbors(x0, rc, max_nnei, cell=cell,
                                         skin=cutoff_skin)
            efn = sutton_chen_energy(uniq[0], nbr, nmask, cell=cell,
                                     params=p, rcut=rc)
            self.table = None
        self._attach(efn, axyz, dtype, device)
        if dtype == torch.float32:
            from sclmd_tpu_torch.kernels.eam_force import EAMForce
            self._use_kernel(EAMForce(efn.terms, self._drv))
