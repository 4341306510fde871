"""Pair potentials over static neighbour lists (counterpart of
``sclmd_tpu.models.pair``).

Each factory returns ``energy(x)`` for positions (..., na, 3) in
angstrom -> eV per leading index; forces come from ``torch.autograd``
(``models.driver.TorchDriver``). Pair lists are static: computed once
from the relaxed structure with a skin.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from sclmd_tpu_torch.models.driver import Consts, DriverShell


def neighbor_pairs(xyz: np.ndarray, cutoff: float, skin: float = 0.3,
                   cell: Optional[np.ndarray] = None):
    """Static (i, j) half pair list within cutoff+skin of the reference
    geometry. ``cell``: optional (3,) orthorhombic box for the
    minimum-image displacement (None: open boundaries)."""
    x = np.asarray(xyz).reshape(-1, 3)
    d = x[None, :, :] - x[:, None, :]
    if cell is not None:
        cell = np.asarray(cell)
        d -= np.round(d / cell) * cell
    r = np.sqrt((d ** 2).sum(-1))
    ii, jj = np.nonzero((r < cutoff + skin) & (r > 0))
    keep = ii < jj
    return ii[keep], jj[keep]


def _pair_disp(x, i, j, cell=None):
    d = x[..., j, :] - x[..., i, :]
    if cell is not None:
        d = d - torch.round(d / cell) * cell
    return d


def _pair_consts(pairs, cell, **extra) -> Consts:
    arrays = dict(i=np.asarray(pairs[0], np.int64),
                  j=np.asarray(pairs[1], np.int64), **extra)
    if cell is not None:
        arrays["cell"] = np.asarray(cell, float)
    return Consts(**arrays)


def lennard_jones_energy(epsilon, sigma, cutoff, pairs, cell=None,
                         shift=True):
    """LJ 12-6 energy function factory. ``epsilon``/``sigma`` may be
    scalars or per-pair arrays (precomputed mixing)."""
    eps_np = np.asarray(epsilon, float)
    sig_np = np.asarray(sigma, float)
    sr6c = (sig_np / cutoff) ** 6
    eshift = 4.0 * eps_np * (sr6c ** 2 - sr6c) if shift \
        else np.zeros_like(eps_np)
    consts = _pair_consts(pairs, cell, eps=eps_np, sig=sig_np,
                          eshift=eshift)

    def energy(x):
        c = consts.on(x)
        d = _pair_disp(x, c["i"], c["j"], c.get("cell"))
        r2 = (d ** 2).sum(-1)
        sr6 = (c["sig"] ** 2 / r2) ** 3
        e = 4.0 * c["eps"] * (sr6 ** 2 - sr6) - c["eshift"]
        return torch.where(r2 < cutoff ** 2, e, torch.zeros_like(e)).sum(-1)

    return energy


def morse_energy(D, alpha, r0, cutoff, pairs, cell=None, shift=False):
    """Morse potential energy factory: D (e^{-2a(r-r0)} - 2 e^{-a(r-r0)}).

    ``shift=True`` subtracts e(cutoff) inside the cutoff so the energy is
    continuous at the cutoff (the LJ factory's convention), for MD where
    pairs may cross it; the raw form is the convention for fixed bond
    lists."""
    exc = np.exp(-alpha * (cutoff - r0))
    eshift = D * (exc ** 2 - 2.0 * exc) if shift else 0.0
    consts = _pair_consts(pairs, cell)

    def energy(x):
        c = consts.on(x)
        d = _pair_disp(x, c["i"], c["j"], c.get("cell"))
        r = torch.sqrt((d ** 2).sum(-1))
        ex = torch.exp(-alpha * (r - r0))
        e = D * (ex ** 2 - 2.0 * ex) - eshift
        return torch.where(r < cutoff, e, torch.zeros_like(e)).sum(-1)

    energy.terms = dict(D=float(D), alpha=float(alpha), r0=float(r0),
                        cutoff=float(cutoff), eshift=float(eshift))
    return energy


def harmonic_bond_energy(k, r0, pairs, cell=None):
    """Sum of (k/2)(r - r0)^2 over an explicit bond list; ``r0`` a scalar
    or one rest length per bond."""
    consts = _pair_consts(pairs, cell, r0=np.asarray(r0, float))

    def energy(x):
        c = consts.on(x)
        d = _pair_disp(x, c["i"], c["j"], c.get("cell"))
        r = torch.sqrt((d ** 2).sum(-1))
        return (0.5 * k * (r - c["r0"]) ** 2).sum(-1)

    return energy


def sum_energies(*fns: Callable) -> Callable:
    def energy(x):
        return sum(f(x) for f in fns)
    return energy


class PairDriver(DriverShell):
    """Force driver for a pair-potential system.

    ``kind``: "lj" (params epsilon, sigma) or "morse" (params D, alpha,
    r0). ``cutoff`` defaults to 2.5 sigma / r0 + 2.5/alpha. The force is
    the autograd of the energy on either device.
    """

    def __init__(self, axyz, kind: str = "lj", params: Optional[dict] = None,
                 cutoff: Optional[float] = None, cell=None, skin: float = 0.3,
                 dtype=torch.float64, device=None):
        p = dict(params or {})
        x0 = np.array([a[1:] for a in axyz], dtype=float)
        if kind == "lj":
            eps = p.get("epsilon", 1.0)
            sig = p.get("sigma", 1.0)
            rc = cutoff if cutoff is not None else 2.5 * sig
            pairs = neighbor_pairs(x0, rc, skin=skin, cell=cell)
            efn = lennard_jones_energy(eps, sig, rc, pairs, cell=cell,
                                       shift=True)
        elif kind == "morse":
            D, alpha, r0 = p.get("D", 1.0), p.get("alpha", 1.0), \
                p.get("r0", 1.0)
            rc = cutoff if cutoff is not None else r0 + 2.5 / alpha
            pairs = neighbor_pairs(x0, rc, skin=skin, cell=cell)
            efn = morse_energy(D, alpha, r0, rc, pairs, cell=cell,
                               shift=True)
        else:
            raise ValueError(f"unknown pair kind {kind!r}")
        self.pairs = pairs
        self._attach(efn, axyz, dtype, device)
