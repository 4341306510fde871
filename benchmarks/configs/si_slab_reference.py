"""Plain PyTorch reference of si_slab: the slab of ``si_slab.json`` as a
``reference.gle.System``, with its Stillinger-Weber energy written out
here from the paper (PRB 31, 5262, 1985) and its force by autograd.

The energy, over positions x (S, na, 3) in angstrom, on the static
periodic neighbour table of the reference geometry (a row for each atom:
the atoms within a sigma + skin by minimum image, nearest first, at most
``slots``; each entry keeps the image it was found at):

    E = 1/2 sum_i sum_{j in T(i)} phi2(r_ij)
        + 1/2 sum_i sum_{j != k in T(i)} phi3(r_ij, r_ik, theta_jik)
    phi2 = eps A (B (r/sigma)^-p - (r/sigma)^-q) e^{sigma / (r - a sigma)}
    phi3 = eps lam e^{gam sigma / (r_ij - a sigma)}
           e^{gam sigma / (r_ik - a sigma)} (cos theta_jik - cos0)^2

with both exponentials zero from r = a sigma on (cos0 = -1/3). The
force in the mass-weighted coordinates is conv f(x0 + conv q) - f0,
conv = MD2ANG / sqrt(mass), f0 the force at q = 0.

Each bath has a memory of one tap (ml 1), so it is Markovian: its
friction is sclmd's ``phbath`` kernel at t = 0, K(0) = (2/pi) wl[-1]
mean_w Gamma(w) over the bath's nw points w = wmax i / nw (wmax = 2
debye), with Gamma interpolated by sclmd's ``flinterp`` (``gle.interp``)
from the table; its noise spectrum is dt nmd equ(w) Gamma(w).

The slab starts at rest and has no dynamical matrix. ``AtRest`` is a
``gle.System`` that skips the eigendecomposition of ``dyn``: every mode
frequency is 0, so ``gle.thermal_start`` gives every mode a zero
amplitude, and its mode matrix is one zero seen through zero strides
(no (nph, nph) array is kept; the start's product still makes one,
once a replay, to multiply the zero phases).
"""

from dataclasses import dataclass

import numpy as np
import torch

from benchmarks.configs.si_slab import friction_table, geometry, partition
from benchmarks.reference import gle
from benchmarks.reference.units import MD2ANG


class SWModel:
    def __init__(self, x0, cell, sw, slots, skin):
        na = len(x0)
        self.p = sw
        rc = sw["a"] * sw["sigma"]
        # row i: the atoms within reach of atom i, nearest first, padded
        # to ``slots`` (``live`` marks the entries)
        nbr = np.zeros((na, slots), np.int64)
        live = np.zeros((na, slots), bool)
        shift = np.zeros((na, slots, 3))
        for i in range(na):
            d = x0 - x0[i]
            img = d - cell * np.round(d / cell)
            r = np.linalg.norm(img, axis=1)
            r[i] = np.inf
            near = np.argsort(r, kind="stable")[:slots]
            near = near[r[near] < rc + skin]
            n = len(near)
            nbr[i, :n], live[i, :n] = near, True
            shift[i, :n] = img[near] - d[near]
        self.nbr, self.live, self.shift = nbr, live, shift
        r0 = np.linalg.norm(x0[nbr] - x0[:, None] + shift, axis=-1)
        k = (live & (r0 < rc)).sum(1)
        # what one evaluation of one trajectory has to compute
        self.counts = dict(atoms=na, entries=int(live.sum()),
                           pairs=int(k.sum()),
                           triples=int((k * (k - 1)).sum()))
        self._t = {}

    def _tensors(self, device, dtype):
        key = (device, dtype)
        if key not in self._t:
            w = self.live.shape[1]
            self._t[key] = dict(
                nbr=torch.as_tensor(self.nbr, device=device),
                live=torch.as_tensor(self.live, device=device),
                pair=torch.as_tensor(
                    self.live[:, :, None] & self.live[:, None, :]
                    & ~np.eye(w, dtype=bool), device=device),
                shift=torch.as_tensor(self.shift, dtype=dtype,
                                      device=device))
        return self._t[key]

    def energy(self, x):
        t, p = self._tensors(x.device, x.dtype), self.p
        eps, sig, rc = p["eps"], p["sigma"], p["a"] * p["sigma"]
        d = x[:, t["nbr"]] - x[:, :, None] + t["shift"]      # (S, na, W, 3)
        r2 = (d * d).sum(-1)
        # a padding entry lies beyond the cutoff
        r = torch.sqrt(torch.where(t["live"], r2,
                                   torch.full_like(r2, 4 * rc * rc)))
        inside = r < rc
        den = torch.where(inside, r - rc, -torch.ones_like(r))

        def decay(g):
            return torch.where(inside, torch.exp(g * sig / den),
                               torch.zeros_like(r))

        s = r / sig
        phi2 = eps * p["A"] * (p["B"] * s ** -p["p"] - s ** -p["q"]) \
            * decay(1.0)
        h = decay(p["gam"])
        u = d / r[..., None]
        cos = torch.einsum("saic,sajc->saij", u, u)
        phi3 = eps * p["lam"] * h[..., :, None] * h[..., None, :] \
            * (cos - p["costheta0"]) ** 2
        phi3 = torch.where(t["pair"], phi3, torch.zeros_like(phi3))
        return 0.5 * phi2.sum((-2, -1)) + 0.5 * phi3.sum((-3, -2, -1))


def wideband_bath(cids, T, cfg, nmd):
    """sclmd's ``phbath`` at ml 1 with the table Gamma(w) = g(w) I: the
    friction K(0) I and the noise spectrum dt nmd equ(w) g(w) I."""
    wb, dt = cfg["wideband_baths"], cfg["dt"]
    gwl, scale = friction_table(cfg)
    wmax = 2.0 * wb["debye"]
    wl = wmax * np.arange(wb["nw"]) / wb["nw"]
    k0 = 2.0 * gle.interp(wl, gwl, scale).sum() / wb["nw"] * wl[-1] / np.pi
    eye = np.identity(len(cids))
    w = 2 * np.pi / dt / nmd * np.arange(nmd // 2 + 1)
    s = dt * nmd * gle.equ_spectrum(w, wmax, T) * gle.interp(w, gwl, scale)
    return gle.Bath(np.asarray(cids), float(T), eye, s, efric=k0 * eye)


@dataclass
class AtRest(gle.System):
    """A ``gle.System`` whose trajectories start at q = p = 0: no
    eigendecomposition, zero mode frequencies and a zero mode matrix
    of zero strides (the module docstring)."""

    def __post_init__(self):
        self.hw = np.zeros(self.nph)
        self.modes = np.lib.stride_tricks.as_strided(
            np.zeros(1), (self.nph, self.nph), (0, 0))
        self.dyn_clamped = None
        self.mask = np.ones(self.nph)
        self.mask[np.asarray(self.fixed, int)] = 0.0


def system(cfg, nmd=None):
    axyz, cell = geometry(cfg)
    left, right = partition(cfg)
    x0 = np.array([a[1:] for a in axyz], float)
    nb = cfg["neighbours"]
    model = SWModel(x0, cell, cfg["sw"], nb["slots"], nb["skin"])
    na = len(axyz)
    conv = np.full(3 * na, MD2ANG / np.sqrt(cfg["mass"]))
    cache = {}

    def force(q, prec):
        key = (q.device, prec.dtype)
        if key not in cache:
            xyz = torch.as_tensor(x0.ravel(), dtype=prec.dtype,
                                  device=q.device)
            cv = torch.as_tensor(conv, dtype=prec.dtype, device=q.device)
            cache[key] = (xyz, cv, 0.0)
            cache[key] = (xyz, cv, absforce(torch.zeros(
                (1, 3 * na), dtype=prec.dtype, device=q.device), key))
        return absforce(q, key) - cache[key][2]

    def absforce(q, key):
        xyz, cv, _ = cache[key]
        with torch.enable_grad():
            x = (xyz + cv * q.detach()).reshape(q.shape[0], na, 3)
            x.requires_grad_(True)
            g, = torch.autograd.grad(model.energy(x).sum(), x)
        return -cv * g.reshape(q.shape)

    T, dl = cfg["T"], cfg["delta"]
    nmd = nmd or cfg["nmd"]
    baths = [wideband_bath(c, tt, cfg, nmd)
             for c, tt in ((left, T * (1 + dl / 2)),
                           (right, T * (1 - dl / 2)))]
    s = AtRest(nph=3 * na, dt=cfg["dt"], nmd=nmd, T=T, dyn=None,
               baths=baths, force=force)
    s.potential = dict(kind="sw", counts=model.counts)
    return s
