"""Stillinger-Weber potential (counterpart of ``sclmd_tpu.models.sw``).

Functional form (Stillinger & Weber, PRB 31, 5262 (1985)):

    E  = sum_{i<j} phi2(r_ij) + sum_i sum_{j<k} phi3(r_ij, r_ik, th_jik)
    phi2 = A eps [B (sig/r)^p - (sig/r)^q] exp(sig / (r - a sig))
    phi3 = lam eps [cos th - cos th0]^2
           exp(gam sig / (r_ij - a sig)) exp(gam sig / (r_ik - a sig))

Both terms vanish smoothly (with all derivatives) at r = a sig. The
parameters are the published 1985 silicon set and the common Ge fit. The
energy is summed over a static padded neighbour table with leading batch
axes: ``energy(x)`` takes (..., na, 3) in angstrom and returns eV per
leading index. On the card in float32 the force of ``SWDriver`` is kernel
K9 (``kernels.sw_force``), whose plain twin is the autograd of
``sw_energy``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch.models.driver import Consts, DriverShell

# published parameter sets (public constants); energies eV, lengths Ang
SW_PARAMS = {
    "Si": dict(eps=2.1683, sigma=2.0951, a=1.80, lam=21.0, gam=1.20,
               costheta0=-1.0 / 3.0, A=7.049556277, B=0.6022245584,
               p=4.0, q=0.0),
    "Ge": dict(eps=1.93, sigma=2.181, a=1.80, lam=31.0, gam=1.20,
               costheta0=-1.0 / 3.0, A=7.049556277, B=0.6022245584,
               p=4.0, q=0.0),
}


def _powi(x, e):
    """x**e, unrolled to multiplies when e is a small integer (the
    published sets use p = 4, q = 0)."""
    ei = int(e)
    if float(ei) != float(e) or not (0 <= ei <= 16):
        return x ** e
    if ei == 0:
        return torch.ones_like(x)
    acc = None
    base = x
    while ei:
        if ei & 1:
            acc = base if acc is None else acc * base
        ei >>= 1
        if ei:
            base = base * base
    return acc


def sw_energy(element: str, neighbors, nmask,
              cell: Optional[np.ndarray] = None,
              params: Optional[dict] = None):
    """Energy-function factory: returns ``energy(x)`` (x (..., na, 3)
    angstrom -> eV) for a single-element Stillinger-Weber system over a
    static padded neighbour table (``models.nnp.build_neighbors``)."""
    p = dict(SW_PARAMS[element]) if params is None else dict(params)
    nbr = np.asarray(neighbors)
    mask = np.asarray(nmask).astype(bool)
    nn = nbr.shape[1]
    arrays = dict(nbr=nbr.astype(np.int64), mask=mask,
                  pairm=mask[:, :, None] & mask[:, None, :]
                  & ~np.eye(nn, dtype=bool)[None])
    if cell is not None:
        arrays["cell"] = np.asarray(cell, float)
    consts = Consts(**arrays)
    eps, sig, a = p["eps"], p["sigma"], p["a"]
    rcut = a * sig

    def _tail(r, pref):
        """exp(pref*sig/(r - a sig)) with a smooth hard zero at rcut."""
        inside = r < rcut - 1e-9
        denom = torch.where(inside, r - rcut, -torch.ones_like(r))
        return torch.where(inside, torch.exp(pref * sig / denom),
                           torch.zeros_like(r))

    def energy(x):
        k = consts.on(x)
        mask_t = k["mask"]
        d = x[..., k["nbr"], :] - x[..., :, None, :]         # (..., na, nn, 3)
        if "cell" in k:
            d = d - torch.round(d / k["cell"]) * k["cell"]
        r2 = (d * d).sum(-1)
        r = torch.sqrt(torch.where(mask_t, r2, torch.ones_like(r2)))

        # two-body (counted once per pair via the 1/2)
        sr = sig / r
        phi2 = p["A"] * eps * (p["B"] * _powi(sr, p["p"])
                               - _powi(sr, p["q"])) * _tail(r, 1.0)
        e2 = 0.5 * torch.where(mask_t, phi2,
                               torch.zeros_like(phi2)).sum((-2, -1))

        # three-body: centre i, legs j and k (each unordered pair once via
        # the 1/2 and a j != k mask)
        rhat = d / r[..., None]
        cosq = torch.einsum("...ija,...ika->...ijk", rhat, rhat)
        h = _tail(r, p["gam"])
        phi3 = p["lam"] * eps * (cosq - p["costheta0"]) ** 2 \
            * h[..., :, None] * h[..., None, :]
        e3 = 0.5 * torch.where(k["pairm"], phi3,
                               torch.zeros_like(phi3)).sum((-3, -2, -1))
        return e2 + e3

    energy.terms = dict(params=p, nbr=arrays["nbr"], mask=mask,
                        cell=arrays.get("cell"))
    return energy


def diamond_cell(nx: int, ny: int, nz: int, a0: float = 5.431):
    """Diamond-lattice slab of nx x ny x nz conventional cells.

    Returns (positions (na, 3) Ang, cell (3,) lengths for the periodic
    wrap). a0 = 5.431 is the SW-silicon equilibrium lattice constant.
    """
    basis = np.array([[0, 0, 0], [0, 2, 2], [2, 0, 2], [2, 2, 0],
                      [1, 1, 1], [1, 3, 3], [3, 1, 3], [3, 3, 1]],
                     dtype=float) * (a0 / 4.0)
    pos = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                off = np.array([i, j, k], dtype=float) * a0
                pos.extend(basis + off)
    cell = np.array([nx, ny, nz], dtype=float) * a0
    return np.array(pos), cell


class SWDriver(DriverShell):
    """Force driver for a Stillinger-Weber system (the JAX package's
    signature, plus ``device``, default the CUDA card).

    In float32 the forces go through kernel K9 (``kernels.sw_force``) on
    the card, whose f0 is the kernel's own force at q = 0, and through its
    autograd twin on CPU tensors (powers p and q that are not small
    integers take powf in the kernel); float64 keeps the autograd of the
    energy on either device."""

    def __init__(self, axyz, cutoff_skin=0.4, max_nnei=None, cell=None,
                 element=None, dtype=torch.float64, params=None,
                 device=None):
        from sclmd_tpu_torch.models.nnp import build_neighbors
        els = [a[0] for a in axyz]
        uniq = sorted(set(els))
        if len(uniq) != 1:
            raise NotImplementedError(
                "SWDriver is single-element; supply per-system params "
                "or use TersoffDriver for mixed systems")
        element = element or uniq[0]
        table = params or SW_PARAMS.get(element)
        if table is None:
            raise NotImplementedError(
                f"no SW parameters for element {element!r}; supply "
                "params=")
        x0 = np.array([a[1:] for a in axyz], dtype=float)
        rcut = table["a"] * table["sigma"]
        nbr, mask = build_neighbors(x0, rcut, max_nnei, cell=cell,
                                    skin=cutoff_skin)
        efn = sw_energy(element, nbr, mask, cell=cell, params=table)
        self._attach(efn, axyz, dtype, device)
        if dtype == torch.float32:
            from sclmd_tpu_torch.kernels.sw_force import SWForce
            self._use_kernel(SWForce(efn.terms, self._drv))
