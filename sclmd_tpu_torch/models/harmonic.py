"""Harmonic force driver (counterpart of ``sclmd_tpu.models.harmonic``):
F(q) = -D q in mass-weighted natural units, batched over leading axes."""

from __future__ import annotations

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch import units as U


class HarmonicDriver:
    """Pure-harmonic force engine.

    ``dyn``: (nph, nph) dynamical matrix in eV^2; ``axyz``: optional
    list of [element, x, y, z] rows (angstrom); ``device`` defaults to
    the CUDA card."""

    def __init__(self, dyn, axyz=None, md2ang=U.MD2ANG,
                 dtype=torch.float32, device=None):
        device = resolve_device(device)
        d = np.asarray(dyn, np.float64)
        self.dyn = torch.as_tensor(0.5 * (d + d.T), dtype=dtype,
                                   device=device)
        self.nph = self.dyn.shape[0]
        self.md2ang = md2ang
        self.axyz = axyz
        if axyz is not None:
            self.els = [a[0] for a in axyz]
            self.xyz = np.array([a[1:] for a in axyz], dtype=float).flatten()
            mass = np.array([U.AtomicMassTable[e] for e in self.els])
            self.conv = md2ang * np.repeat(1.0 / np.sqrt(mass), 3)
        else:
            self.els, self.xyz = None, None
            self.conv = np.ones(self.nph)
        self.initforce()

    def initforce(self):
        self.f0 = torch.zeros_like(self.dyn[0])

    def force(self, q: torch.Tensor) -> torch.Tensor:
        return -(q @ self.dyn.T)

    # the batched path the md runner picks (AddPotential)
    force_torch = force
    absforce = force

    def energy(self, q: torch.Tensor) -> torch.Tensor:
        return 0.5 * ((q @ self.dyn.T) * q).sum(-1)

    def dynmat(self, q=None) -> torch.Tensor:
        return self.dyn

    def quit(self):
        pass


def chain_dynmat(n: int, k: float = 0.1, kend: float | None = None,
                 dtype=torch.float64) -> torch.Tensor:
    """Dynamical matrix of a 1D nearest-neighbour chain (n sites, spring
    k in eV^2, end springs ``kend``); phonon band w in [0, 2 sqrt(k)]."""
    kend = k if kend is None else kend
    d = np.zeros((n, n))
    for i in range(n - 1):
        d[i, i] += k
        d[i + 1, i + 1] += k
        d[i, i + 1] -= k
        d[i + 1, i] -= k
    d[0, 0] += kend
    d[n - 1, n - 1] += kend
    return torch.as_tensor(d, dtype=dtype)
