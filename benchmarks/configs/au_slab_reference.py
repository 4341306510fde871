"""Plain PyTorch reference of au_slab: the slab of ``au_slab.json`` as a
``reference.gle.System``, with its Sutton-Chen energy written out here
from the paper (Philos. Mag. Lett. 61, 139, 1990) and its force by
autograd.

The energy, over positions x (S, na, 3) in angstrom, on the static
periodic neighbour table of the reference geometry (a row for each atom:
the atoms within the cutoff plus the skin by minimum image, nearest
first; each entry keeps the image it was found at):

    E = 1/2 sum_i sum_{j in T(i)} eps (a / r_ij)^n sw(r_ij)
        + sum_i -eps c sqrt(rho_i),
    rho_i = sum_{j in T(i)} (a / r_ij)^m sw(r_ij)

with the published gold set (eps, a, n, m, c). Departures from the
paper, each the configuration's (``assumed``): the sums stop at the
cutoff rc = 1.7 a, and both terms are switched off smoothly before it,
sw(r) = 1 - 6 u^5 + 15 u^4 - 10 u^3 with u = (r - rc + w) / w clipped to
[0, 1] (w the switch width), where the paper sums every lattice shell;
and the table is built once, so an atom that enters the cutoff from
beyond the skin is not seen (none does at the run's amplitudes). The
force in the mass-weighted coordinates is conv f(x0 + conv q) - f0,
conv = MD2ANG / sqrt(mass), f0 the force at q = 0. The energy holds no
matrix product, so TF32 never rounds it: the check runs it in float64,
the control in float32.

The baths (``wideband_bath``) and the start at rest (``AtRest``) are the
silicon slab's reference's (``si_slab_reference``): Markovian wideband
``phbath``s on the end layers and no dynamical matrix.
"""

import numpy as np
import torch

from benchmarks.configs.au_slab import geometry, partition
from benchmarks.configs.si_slab_reference import AtRest, wideband_bath
from benchmarks.reference.units import MD2ANG


class SuttonChenModel:
    def __init__(self, x0, cell, sc, skin):
        na = len(x0)
        self.p = sc
        rc = sc["rcut"]
        rows = []
        for i in range(na):
            d = x0 - x0[i]
            img = d - cell * np.round(d / cell)
            r = np.linalg.norm(img, axis=1)
            r[i] = np.inf
            near = np.argsort(r, kind="stable")
            near = near[r[near] < rc + skin]
            rows.append((near, img[near] - d[near]))
        # row i: the atoms within reach of atom i, padded to the widest
        # row (``live`` marks the entries)
        width = max(len(n) for n, _ in rows)
        nbr = np.zeros((na, width), np.int64)
        live = np.zeros((na, width), bool)
        shift = np.zeros((na, width, 3))
        for i, (near, sh) in enumerate(rows):
            n = len(near)
            nbr[i, :n], live[i, :n], shift[i, :n] = near, True, sh
        self.nbr, self.live, self.shift = nbr, live, shift
        r0 = np.linalg.norm(x0[nbr] - x0[:, None] + shift, axis=-1)
        # what one evaluation of one trajectory has to compute
        self.counts = dict(atoms=na, entries=int(live.sum()),
                           inside=int((live & (r0 < rc)).sum()))
        self._t = {}

    def _tensors(self, device, dtype):
        key = (device, dtype)
        if key not in self._t:
            self._t[key] = dict(
                nbr=torch.as_tensor(self.nbr, device=device),
                live=torch.as_tensor(self.live, device=device),
                shift=torch.as_tensor(self.shift, dtype=dtype,
                                      device=device))
        return self._t[key]

    def energy(self, x):
        t, p = self._tensors(x.device, x.dtype), self.p
        rc, w = p["rcut"], p["switch_width"]
        d = x[:, t["nbr"]] - x[:, :, None] + t["shift"]      # (S, na, W, 3)
        r2 = (d * d).sum(-1)
        # a padding entry lies beyond the cutoff
        r = torch.sqrt(torch.where(t["live"], r2,
                                   torch.full_like(r2, 4 * rc * rc)))
        u = ((r - (rc - w)) / w).clamp(0.0, 1.0)
        sw = 1.0 - 6.0 * u ** 5 + 15.0 * u ** 4 - 10.0 * u ** 3
        sw = torch.where(r < rc, sw, torch.zeros_like(sw))
        ar = p["a"] / r
        pair = 0.5 * p["eps"] * (sw * ar ** p["n"]).sum((-2, -1))
        rho = (sw * ar ** p["m"]).sum(-1)                    # (S, na)
        embed = -p["eps"] * p["c"] * torch.sqrt(rho).sum(-1)
        return pair + embed


def system(cfg, nmd=None):
    axyz, cell = geometry(cfg)
    left, right = partition(cfg)
    x0 = np.array([a[1:] for a in axyz], float)
    model = SuttonChenModel(x0, cell, cfg["sutton_chen"],
                            cfg["neighbours"]["skin"])
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
    s.potential = dict(kind="eam", counts=model.counts)
    return s
