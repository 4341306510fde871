"""Hydrogen-terminated carbon junctions: Tersoff backbone + C-H bonds
(counterpart of ``sclmd_tpu.models.hydrocarbon``).

The carbon sublattice carries the published Tersoff set
(``models.tersoff``). H atoms are explicit terminators:

- one Morse bond H - nearest C (D = 4.3 eV, r0 = 1.09 Ang, alpha =
  1.885 /Ang, the ~3000 cm^-1 aromatic C-H stretch),
- harmonic auxiliary springs H - adjacent C (the carbon neighbours of the
  anchor) at their initial lengths, stiffness ``k_bend``, which puts the
  in-plane C-H bends in the observed 800-1300 cm^-1 band,
- an out-of-plane wag term k_oop/2 (u . n)^2 per H (u the C->H vector, n
  the unit normal of the anchor's two adjacent carbons).

On the card ``CHDriver.force_torch`` is kernel K5
(``kernels.ch_force``): the analytic gradient of this energy in one
launch per evaluation. Its plain twin is the autograd of ``ch_energy``,
which also serves every CPU run, ``dynmat`` and the relaxers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch.models.driver import Consts, DriverShell
from sclmd_tpu_torch.utils import profiling

# textbook C-H spectroscopic constants (see the module docstring)
CH_MORSE = dict(D=4.3, r0=1.09, alpha=1.885, cutoff=1.9)
CH_BEND_K = 4.0          # eV/Ang^2 auxiliary-spring stiffness
CH_OOP_K = 2.5           # eV/Ang^2 out-of-plane wag stiffness
# below this squared norm of e1 x e2 the wag term's plane normal counts
# as undefined and the term gives zero energy and force
OOP_N2_MIN = 1e-12


def ch_energy(axyz, cell: Optional[np.ndarray] = None,
              max_nnei: Optional[int] = None, cutoff_skin: float = 0.4,
              morse: Optional[dict] = None, k_bend: float = CH_BEND_K,
              k_oop: float = CH_OOP_K,
              tersoff_params: Optional[dict] = None):
    """Energy-function factory for a C/H system: returns ``energy(x)``
    over the full (..., na, 3) cartesian array (eV), plus the (h_index,
    anchor_c) bond list. ``energy.terms`` lists every term of the sum
    (the carbon table, the bonds, the springs with their rest lengths,
    the wag quadruples and all parameters) as host numpy, for kernel
    K5's operands."""
    from sclmd_tpu_torch.models.nnp import build_neighbors
    from sclmd_tpu_torch.models.pair import (harmonic_bond_energy,
                                             morse_energy)
    from sclmd_tpu_torch.models.tersoff import (TERSOFF_PARAMS,
                                                tersoff_energy)

    m = dict(CH_MORSE) if morse is None else dict(morse)
    els = [a[0] for a in axyz]
    bad = sorted(set(els) - {"C", "H"})
    if bad:
        raise NotImplementedError(
            f"ch_energy handles C/H only, got {bad}")
    x0 = np.array([a[1:] for a in axyz], dtype=float)
    c_ids = np.array([i for i, e in enumerate(els) if e == "C"], dtype=int)
    h_ids = np.array([i for i, e in enumerate(els) if e == "H"], dtype=int)

    # carbon backbone: Tersoff over the C sublattice
    tp = (tersoff_params or TERSOFF_PARAMS)["C"]
    nbr_c, mask_c = build_neighbors(x0[c_ids], tp["R"] + tp["D"], max_nnei,
                                    cell=cell, skin=cutoff_skin)
    e_c = tersoff_energy("C", nbr_c, mask_c, cell=cell,
                         params=None if tersoff_params is None else tp)

    def disp(a, b):
        d = x0[b] - x0[a]
        if cell is not None:
            d = d - np.round(d / np.asarray(cell)) * np.asarray(cell)
        return d

    # each H bonds to its nearest C; auxiliary springs to that C's
    # neighbours
    bonds = []       # (h, c_anchor)
    aux = []         # (h, c_adjacent, rest_length)
    oop = []         # (h, c_anchor, c_adj1, c_adj2)
    for h in h_ids:
        d = np.array([np.linalg.norm(disp(h, c)) for c in c_ids])
        anchor = int(c_ids[np.argmin(d)])
        if d.min() > m["cutoff"]:
            raise ValueError(f"H atom {h} has no C within "
                             f"{m['cutoff']} Ang")
        bonds.append((h, anchor))
        loc = np.nonzero(c_ids == anchor)[0][0]
        adj = []
        for jn in np.nonzero(mask_c[loc])[0]:
            cadj = int(c_ids[nbr_c[loc, jn]])
            rl = np.linalg.norm(disp(h, cadj))
            if rl < 2.6:
                aux.append((h, cadj, rl))
                adj.append(cadj)
        if len(adj) >= 2:
            # anchors whose adjacents are (nearly) collinear have no
            # plane normal (sp chains): no wag term there
            e1 = disp(anchor, adj[0])
            e2 = disp(anchor, adj[1])
            sin2 = np.linalg.norm(np.cross(e1, e2)) / (
                np.linalg.norm(e1) * np.linalg.norm(e2))
            if sin2 > 0.1:
                oop.append((h, anchor, adj[0], adj[1]))
    bonds = np.asarray(bonds, dtype=int).reshape(-1, 2)
    aux_np = np.asarray([(a, b) for a, b, _ in aux], dtype=int).reshape(-1, 2)
    rl_np = np.asarray([r for _, _, r in aux], dtype=float)
    oop_np = np.asarray(oop, dtype=int).reshape(-1, 4)

    e_ch = morse_energy(m["D"], m["alpha"], m["r0"], m["cutoff"] + 1.0,
                        (bonds[:, 0], bonds[:, 1]), cell=cell) \
        if len(bonds) else None
    e_bend = harmonic_bond_energy(k_bend, rl_np,
                                  (aux_np[:, 0], aux_np[:, 1]), cell=cell) \
        if len(aux_np) else None

    if len(oop_np):
        arrays = {f"o{k}": oop_np[:, k] for k in range(4)}
        if cell is not None:
            arrays["cell"] = np.asarray(cell, float)
        oconsts = Consts(**arrays)

        def e_oop(x):
            k = oconsts.on(x)
            cell_o = k.get("cell")

            def vec(a, b):
                d = x[..., k[a], :] - x[..., k[b], :]
                return d if cell_o is None else \
                    d - torch.round(d / cell_o) * cell_o

            u = vec("o0", "o1")                     # C1 -> H
            nvec = torch.linalg.cross(vec("o2", "o1"), vec("o3", "o1"))
            # a bond passing through exact collinearity during MD must
            # not divide by 0, and the gradient of a norm at the zero
            # vector is 0/0: the guard sits inside the square root's
            # argument
            n2 = (nvec * nvec).sum(-1, keepdim=True)
            ok = n2 > OOP_N2_MIN
            nhat = torch.where(
                ok, nvec / torch.sqrt(torch.where(ok, n2,
                                                  torch.ones_like(n2))),
                torch.zeros_like(nvec))
            return 0.5 * k_oop * ((u * nhat).sum(-1) ** 2).sum(-1)
    else:
        e_oop = None

    csel = Consts(c=c_ids)

    def energy(x):
        e = e_c(x[..., csel.on(x)["c"], :])
        if e_ch is not None:
            e = e + e_ch(x)
        if e_bend is not None:
            e = e + e_bend(x)
        if e_oop is not None:
            e = e + e_oop(x)
        return e

    energy.terms = dict(
        c_ids=c_ids, nbr_c=np.asarray(nbr_c), mask_c=np.asarray(mask_c),
        tersoff=dict(tp), morse=dict(m), bonds=bonds, aux=aux_np,
        aux_r0=rl_np, k_bend=float(k_bend), oop=oop_np, k_oop=float(k_oop),
        oop_n2_min=OOP_N2_MIN,
        cell=None if cell is None else np.asarray(cell, float))
    return energy, bonds


def terminate_with_h(axyz, cell=None, bond: float = CH_MORSE["r0"],
                     cc_cut: float = 1.8, target_coord: int = 3):
    """Passivate under-coordinated carbon edges with hydrogen.

    For every C with fewer than ``target_coord`` carbon neighbours
    (within ``cc_cut`` Ang), add one H at distance ``bond`` along the
    outward bisector of the existing bonds (in the local sheet plane).
    Returns a new axyz list with the H rows appended."""
    els = [a[0] for a in axyz]
    x0 = np.array([a[1:] for a in axyz], dtype=float)
    c_ids = [i for i, e in enumerate(els) if e == "C"]
    xc = x0[c_ids]

    def mic(d):
        if cell is None:
            return d
        c = np.asarray(cell)
        return d - np.round(d / c) * c

    out = [list(a) for a in axyz]
    for i in c_ids:
        d = mic(xc - x0[i])
        r = np.linalg.norm(d, axis=1)
        nbrs = np.nonzero((r > 1e-6) & (r < cc_cut))[0]
        if len(nbrs) >= target_coord or len(nbrs) == 0:
            continue
        u = -(d[nbrs] / r[nbrs, None]).sum(0)
        norm = np.linalg.norm(u)
        if norm < 1e-6:
            continue        # bonds balance (e.g. the middle of a chain)
        out.append(["H"] + list(x0[i] + bond * u / norm))
    return out


class CHDriver(DriverShell):
    """Force driver for hydrogen-terminated carbon junctions.

    ``force_torch`` on CUDA tensors launches kernel K5 (float32, with or
    without a periodic cell, any width of the carbon table, up to 65535
    atoms: the kernel keeps its constants and working memory in shared
    memory up to about 450 atoms of a ribbon and reads them from global
    memory beyond), whose f0 is the kernel's own force at q = 0; on CPU
    tensors it is the autograd twin. A float64 many-body run is CPU-only:
    a float64 CUDA tensor raises."""

    # the card's force_torch launches K5 and allocates its output through
    # the caching allocator, with no host sync: md.run_segment may replay
    # it inside a CUDA graph (md.graph_plan)
    capturable = True

    def __init__(self, axyz, cell=None, max_nnei=None, cutoff_skin=0.4,
                 dtype=torch.float64, morse=None, k_bend=CH_BEND_K,
                 k_oop=CH_OOP_K, tersoff_params=None, device=None):
        from sclmd_tpu_torch.kernels.ch_force import CHForce
        with profiling.span("setup/driver"):
            efn, bonds = ch_energy(axyz, cell=cell, max_nnei=max_nnei,
                                   cutoff_skin=cutoff_skin, morse=morse,
                                   k_bend=k_bend, k_oop=k_oop,
                                   tersoff_params=tersoff_params)
            self.ch_bonds = bonds
            self._attach(efn, axyz, dtype, device)
            self._use_kernel(CHForce(efn.terms, self._drv))
