"""Tersoff bond-order potential (counterpart of
``sclmd_tpu.models.tersoff``).

Functional form (J. Tersoff, PRB 39, 5566 (1989)):

    E = 1/2 sum_i sum_j fc(r_ij) [ fR(r_ij) + b_ij fA(r_ij) ]
    fR = A exp(-l1 r),  fA = -B exp(-l2 r)
    b_ij = (1 + (beta zeta_ij)^n)^(-1/2n)
    zeta_ij = sum_k fc(r_ik) g(th_ijk) exp[l3^m (r_ij - r_ik)^m]
    g(th) = gamma (1 + c^2/d^2 - c^2/(d^2 + (h - cos th)^2))

All tensors have a fixed shape (a padded static neighbour table), and the
positions carry leading batch axes: ``energy(x)`` takes (..., na, 3) in
angstrom and returns eV per leading index. On the card the force of the
C/H junction is kernel K5 and that of a single-element Tersoff system in
float32 kernel K8 (both ``kernels.ch_force``), whose plain twin is the
autograd of these functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch.models.driver import Consts, DriverShell

# Tersoff (1989) single-element parameter sets (public constants).
TERSOFF_PARAMS = {
    "C": dict(A=1393.6, B=346.74, lam1=3.4879, lam2=2.2119, lam3=0.0,
              beta=1.5724e-7, n=0.72751, c=38049.0, d=4.3484,
              h=-0.57058, R=1.95, D=0.15, gamma=1.0, m=3.0),
    "Si": dict(A=1830.8, B=471.18, lam1=2.4799, lam2=1.7322, lam3=0.0,
               beta=1.1e-6, n=0.78734, c=100390.0, d=16.217,
               h=-0.59825, R=2.85, D=0.15, gamma=1.0, m=3.0),
    "Ge": dict(A=1769.0, B=419.23, lam1=2.4451, lam2=1.7047, lam3=0.0,
               beta=9.0166e-7, n=0.75627, c=106430.0, d=15.652,
               h=-0.43884, R=2.95, D=0.15, gamma=1.0, m=3.0),
}

# inter-element bond-strength correction chi_ij (Tersoff PRB 39, 5566)
TERSOFF_CHI = {("Si", "C"): 0.9776, ("Si", "Ge"): 1.00061,
               ("C", "Ge"): 1.0}


def _chi(e1, e2):
    if e1 == e2:
        return 1.0
    return TERSOFF_CHI.get((e1, e2), TERSOFF_CHI.get((e2, e1), 1.0))


def _cutoff(r, R, D):
    inner = r < R - D
    outer = r > R + D
    mid = 0.5 - 0.5 * torch.sin(0.5 * np.pi * (r - R) / D)
    return torch.where(inner, torch.ones_like(r),
                       torch.where(outer, torch.zeros_like(r), mid))


def _angular(cos, gamma, c2, d2, h):
    """g(theta) = gamma (1 + c^2/d^2 - c^2/(d^2 + (h - cos)^2)).

    The published form subtracts two numbers near c^2/d^2 (7.7e7 for
    carbon) to leave g, which near cos = h is of order 1: in float32 that
    loses g altogether, and since dE/dzeta grows as zeta^(n-1) the force
    is then wrong by tenths of an eV/angstrom (measured on the 201-atom
    C/H junction). Below float64 the same function is therefore taken as
    gamma (1 + c^2 (h - cos)^2 / (d^2 (d^2 + (h - cos)^2))), which has no
    cancellation; float64 keeps the published form, digit for digit the
    JAX package's."""
    hc2 = (h - cos) ** 2
    if cos.dtype == torch.float64:
        return gamma * (1.0 + c2 / d2 - c2 / (d2 + hc2))
    return gamma * (1.0 + (c2 / d2) * hc2 / (d2 + hc2))


def _bond_order(zeta, beta, n):
    # (beta zeta)^n has an unbounded derivative at zeta = 0 (n < 1), and
    # the untaken branch of a where still feeds its gradient: the base is
    # made safe before the power, so gradient and Hessian stay finite for
    # isolated bonds and padded entries
    bz = beta * zeta
    pos = bz > 0
    bz_safe = torch.where(pos, bz, torch.ones_like(bz))
    bterm = torch.where(pos, bz_safe ** n, torch.zeros_like(bz))
    return (1.0 + bterm) ** (-1.0 / (2.0 * n))


def _pair_geometry(x, nbr, mask, cell):
    """(rij, rhat) of the padded table: masked entries get r = 1 from a
    masked square root, whose gradient at 0 would be infinite."""
    dij = x[..., nbr, :] - x[..., :, None, :]
    if cell is not None:
        dij = dij - torch.round(dij / cell) * cell
    r2 = (dij * dij).sum(-1)
    rij = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
    return rij, dij / rij[..., None]


def tersoff_energy_multi(elements, neighbors, nmask,
                         cell: Optional[np.ndarray] = None,
                         params: Optional[dict] = None):
    """Multi-element Tersoff with the 1989 mixing rules.

    ``elements``: per-atom element symbols. Pair quantities use
    lam_ij = (lam_i + lam_j)/2, A_ij = sqrt(A_i A_j),
    B_ij = chi_ij sqrt(B_i B_j), R_ij = sqrt(R_i R_j),
    D_ij = sqrt(D_i D_j); the bond-order parameters (beta, n, c, d, h)
    are those of the centre atom i.
    """
    table = params or TERSOFF_PARAMS
    els = list(elements)
    na = len(els)
    nbr = np.asarray(neighbors)
    mask = np.asarray(nmask)
    nn = nbr.shape[1]

    def per_atom(key):
        return np.array([table[e][key] for e in els], float)

    def per_pair(fn):
        out = np.zeros(nbr.shape)
        for i in range(na):
            for jn in range(nn):
                out[i, jn] = fn(els[i], els[nbr[i, jn]])
        return out

    def mix_avg(key):
        return per_pair(lambda a, b: 0.5 * (table[a][key] + table[b][key]))

    def mix_sqrt(key):
        return per_pair(lambda a, b: np.sqrt(table[a][key] * table[b][key]))

    lam3_np = per_atom("lam3")
    arrays = dict(
        nbr=nbr.astype(np.int64), mask=mask.astype(bool),
        notself=~np.eye(nn, dtype=bool)[None],
        # Tersoff 1989 applies chi to the attractive B term only
        A=mix_sqrt("A"),
        B=per_pair(lambda a, b: _chi(a, b) *
                   np.sqrt(table[a]["B"] * table[b]["B"])),
        l1=mix_avg("lam1"), l2=mix_avg("lam2"),
        R=mix_sqrt("R"), D=mix_sqrt("D"),
        # centre-atom parameters, broadcast over the neighbours
        beta=per_atom("beta")[:, None], n=per_atom("n")[:, None],
        c=per_atom("c")[:, None, None], d=per_atom("d")[:, None, None],
        h=per_atom("h")[:, None, None],
        gamma=per_atom("gamma")[:, None, None],
        l3=lam3_np[:, None, None], m=per_atom("m")[:, None, None])
    if cell is not None:
        arrays["cell"] = np.asarray(cell, float)
    consts = Consts(**arrays)
    with_l3 = bool(np.any(lam3_np != 0.0))

    def energy(x):
        k = consts.on(x)
        mask_t = k["mask"]
        rij, rhat = _pair_geometry(x, k["nbr"], mask_t, k.get("cell"))
        fcij = torch.where(mask_t, _cutoff(rij, k["R"], k["D"]),
                           torch.zeros_like(rij))
        cos_ijk = torch.einsum("...ija,...ika->...ijk", rhat, rhat)
        c2, d2 = k["c"] ** 2, k["d"] ** 2
        g = _angular(cos_ijk, k["gamma"], c2, d2, k["h"])
        term = fcij[..., None, :] * g
        if with_l3:
            # the lam3/m exponential of the centre atom
            term = term * torch.exp(
                (k["l3"] * (rij[..., :, None] - rij[..., None, :]))
                ** k["m"])
        zeta = torch.where(k["notself"], term,
                           torch.zeros_like(term)).sum(-1)
        bij = _bond_order(zeta, k["beta"], k["n"])
        fR = k["A"] * torch.exp(-k["l1"] * rij)
        fA = -k["B"] * torch.exp(-k["l2"] * rij)
        e_pair = fcij * (fR + bij * fA)
        return 0.5 * torch.where(mask_t, e_pair,
                                 torch.zeros_like(e_pair)).sum((-2, -1))

    energy.terms = dict(elements=els, params=table, nbr=arrays["nbr"],
                        mask=arrays["mask"], cell=arrays.get("cell"))
    return energy


def tersoff_energy(element: str, neighbors, nmask,
                   cell: Optional[np.ndarray] = None,
                   params: Optional[dict] = None):
    """Energy-function factory for a single-element Tersoff system.

    ``neighbors``/``nmask``: the padded (na, nn) static neighbour table
    (``models.nnp.build_neighbors``). Returns ``energy(x)`` for x
    (..., na, 3) in angstrom -> eV.
    """
    p = dict(TERSOFF_PARAMS[element]) if params is None else dict(params)
    nbr = np.asarray(neighbors)
    nn = nbr.shape[1]
    arrays = dict(nbr=nbr.astype(np.int64),
                  mask=np.asarray(nmask).astype(bool),
                  notself=~np.eye(nn, dtype=bool)[None])     # k != j
    if cell is not None:
        arrays["cell"] = np.asarray(cell, float)
    consts = Consts(**arrays)
    R, D = p["R"], p["D"]
    c2, d2 = p["c"] ** 2, p["d"] ** 2

    def energy(x):
        k = consts.on(x)
        mask_t = k["mask"]
        rij, rhat = _pair_geometry(x, k["nbr"], mask_t, k.get("cell"))
        fcij = torch.where(mask_t, _cutoff(rij, R, D),
                           torch.zeros_like(rij))            # (..., na, nn)
        # angular sum over k for every (i, j), from the same padded table
        cos_ijk = torch.einsum("...ija,...ika->...ijk", rhat, rhat)
        g = _angular(cos_ijk, p["gamma"], c2, d2, p["h"])
        term = fcij[..., None, :] * g                        # (..., na, nn, nn)
        if p["lam3"] != 0.0:
            term = term * torch.exp(
                (p["lam3"] * (rij[..., :, None] - rij[..., None, :]))
                ** p["m"])
        zeta = torch.where(k["notself"], term,
                           torch.zeros_like(term)).sum(-1)   # (..., na, nn)
        bij = _bond_order(zeta, p["beta"], p["n"])
        fR = p["A"] * torch.exp(-p["lam1"] * rij)
        fA = -p["B"] * torch.exp(-p["lam2"] * rij)
        e_pair = fcij * (fR + bij * fA)
        return 0.5 * torch.where(mask_t, e_pair,
                                 torch.zeros_like(e_pair)).sum((-2, -1))

    energy.terms = dict(params=p, nbr=arrays["nbr"], mask=arrays["mask"],
                        cell=arrays.get("cell"))
    return energy


def graphene_ribbon(nx: int, ny: int, a: float = 1.42):
    """An armchair graphene-ribbon geometry: the (na, 3) positions in
    angstrom (open boundaries)."""
    pos = []
    dx = 1.5 * a
    dy = np.sqrt(3) * a
    for i in range(nx):
        for j in range(ny):
            x0 = i * dx
            y0 = j * dy + (0.5 * dy if i % 2 else 0.0)
            pos.append([x0, y0, 0.0])
            pos.append([x0 + a * 0.5, y0 + dy / 2, 0.0])
    return np.array(pos)


class TersoffDriver(DriverShell):
    """Force driver for a Tersoff system.

    A single-element system in float32 takes kernel K8 on the card
    (``kernels.ch_force`` with a Tersoff-only pack, periodic cell and any
    table width included, up to 65535 atoms; shared memory holds the
    kernel's constants up to about 350 carbons and its working memory up
    to about 700, global memory beyond), whose f0 is the kernel's own
    force at q = 0,
    and the autograd twin on CPU tensors. A multi-element system (mixed
    pair parameters) and float64 keep the autograd of the energy on
    either device."""

    def __init__(self, axyz, cutoff_skin=0.4, max_nnei=None, cell=None,
                 element=None, dtype=torch.float64, params=None,
                 device=None):
        from sclmd_tpu_torch.models.nnp import build_neighbors
        els = [a[0] for a in axyz]
        uniq = sorted(set(els))
        x0 = np.array([a[1:] for a in axyz], dtype=float)
        table = params or TERSOFF_PARAMS
        if len(uniq) == 1:
            element = element or uniq[0]
            if element not in table:
                raise NotImplementedError(
                    f"no Tersoff parameters for element {element!r}; "
                    "supply params=")
            pcut = table[element]
            nbr, mask = build_neighbors(x0, pcut["R"] + pcut["D"],
                                        max_nnei, cell=cell,
                                        skin=cutoff_skin)
            efn = tersoff_energy(element, nbr, mask, cell=cell,
                                 params=None if params is None else pcut)
        else:
            missing = [e for e in uniq if e not in table]
            if missing:
                raise NotImplementedError(
                    f"no Tersoff parameters for elements {missing}; "
                    "supply params=")
            rcut = max(table[e]["R"] + table[e]["D"] for e in uniq)
            nbr, mask = build_neighbors(x0, rcut, max_nnei, cell=cell,
                                        skin=cutoff_skin)
            efn = tersoff_energy_multi(els, nbr, mask, cell=cell,
                                       params=table)
        self._attach(efn, axyz, dtype, device)
        if len(uniq) == 1 and dtype == torch.float32:
            from sclmd_tpu_torch.kernels.ch_force import CHForce, pack_tersoff
            self._use_kernel(CHForce(efn.terms, self._drv, pack=pack_tersoff))
