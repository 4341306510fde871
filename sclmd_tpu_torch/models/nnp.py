"""DeepMD-style neural-network potential (counterpart of
``sclmd_tpu.models.nnp``): static padded neighbour tables, the C2-smooth
switch, the smooth-edition descriptor with its fitting network
(``DeepPotSE``) and its force driver (``deepmddriver``).

DeepPot-SE (Zhang et al., NeurIPS 2018; DeePMD-kit, Comput. Phys.
Commun. 228, 178 (2018)) in the JAX package's form. For each atom i and
each entry j of its row of the table (nn entries, padding masked):

    s_ij = sw(r_ij) / r_ij        sw: the C2 quintic from rcut_smth to rcut
    R_ij = s_ij (1, x_ij / r_ij, y_ij / r_ij, z_ij / r_ij)
    e_ij = N_emb[type j](s_ij)    1 -> embed_sizes, tanh between, last linear
    G_i  = (1 / nn) sum_j e_ij (x) R_ij           (nemb, 4)
    D_i  = G_i G_i[:naxis]^T, flattened          (nemb naxis,)
    E_i  = N_fit[type i](D_i)     ndesc -> fit_sizes -> 1, tanh between
    E    = sum_i E_i,   F = -dE/dx

The embedding's last layer is linear, so it moves past the sum over
entries exactly: G_i^T = sum_t ((R_t^T h2) W3_t + (R_t^T 1) b3_t^T) / nn,
with h2 the embedding's last hidden activation and R_t the rows of the
entries of type t; no nemb-wide tensor exists per entry. That form, and D,
is ``kernels.dp_descriptor`` (K13: a hand kernel on the card in float32, its
plain twin in float64 and on the CPU, ``dynmat``'s Hessian included).

Departures from DeePMD-kit's ``se_e2_a``, the JAX package's: no ResNet
skips, no davg/dstd normalisation of the environment, no per-type energy
bias, and the descriptor divided by the table's width. The energy takes
positions (..., na, 3) and returns one energy per leading index. Its
float32 products run in full float32: the package pins TF32 off at
import (``sclmd_tpu_torch.pin_precision``) and nothing here turns it on.

The table is built once from the reference geometry with a skin and is
never rebuilt during a run: atoms of a junction vibrate around fixed
sites. Training (the JAX package's ``loss``/``fit``), ``DeepPotPB`` and
``prepare_nnp_data`` are not ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.kernels import dp_descriptor as K13
from sclmd_tpu_torch.models.driver import Consts, DriverShell, TorchDriver
from sclmd_tpu_torch.utils import profiling

# network evaluations of deepmddriver's force (each a forward pass and its
# input-gradient backward): a graph replay adds the evaluations it holds
launches = 0
profiling.register("launches.DP", __name__, "launches")


def build_neighbors(xyz, cutoff: float, max_nnei: Optional[int],
                    cell: Optional[np.ndarray] = None, skin: float = 0.5,
                    backend: str = "auto"):
    """Padded neighbour table (na, max_nnei) and its mask, from the
    reference geometry: per atom the neighbours within ``cutoff + skin``,
    nearest first. Padding entries point at atom 0 with mask False.

    ``max_nnei=None`` sizes the table to the observed occupancy, rounded
    up to a multiple of 4 (the three-body cost of the many-body
    potentials grows as the square of the width). ``backend``: "numpy" or
    "auto" (both the O(na^2) numpy builder); "native" (the C++ cell
    lists) is not ported and raises.
    """
    if backend == "native":
        raise NotImplementedError(
            "build_neighbors: the native cell-list backend is not ported "
            "(ROADMAP queue 1 item 5); use backend=\"numpy\"")
    if backend not in ("auto", "numpy"):
        raise ValueError(f"build_neighbors: unknown backend {backend!r}")
    x = np.asarray(xyz, dtype=float).reshape(-1, 3)
    na = len(x)
    if max_nnei is None:
        # build with a generous cap, grow it while saturated, then shrink
        # the table to what is occupied
        cap = 64
        while True:
            nbr, mask = build_neighbors(x, cutoff, cap, cell=cell, skin=skin,
                                        backend=backend)
            occ = int(mask.sum(1).max()) if mask.any() else 1
            if occ < cap or cap >= 1024:
                break
            cap *= 2
        nn = max(4, -(-occ // 4) * 4)
        return nbr[:, :nn], mask[:, :nn]
    d = x[None, :, :] - x[:, None, :]
    if cell is not None:
        d -= np.round(d / np.asarray(cell)) * np.asarray(cell)
    r = np.sqrt((d ** 2).sum(-1))
    np.fill_diagonal(r, np.inf)
    nbr = np.full((na, max_nnei), -1, dtype=np.int64)
    for i in range(na):
        js = np.nonzero(r[i] < cutoff + skin)[0]
        js = js[np.argsort(r[i][js])][:max_nnei]
        nbr[i, : len(js)] = js
    mask = nbr >= 0
    return np.where(mask, nbr, 0), mask


def smooth_switch(r: torch.Tensor, r_on: float, r_cut: float) -> torch.Tensor:
    """C2-smooth switching function: 1 below r_on, 0 above r_cut."""
    u = ((r - r_on) / (r_cut - r_on)).clamp(0.0, 1.0)
    return 1.0 - 6 * u ** 5 + 15 * u ** 4 - 10 * u ** 3


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
def init_params(seed: int, ntypes: int, embed_sizes, fit_sizes,
                naxis: int) -> dict:
    """Seeded weights in the JAX package's layout, as float64 numpy:
    ``{"embed": [net of neighbour type t], "fit": [net of centre type
    t]}``, a net a list of (w (fan_in, fan_out), b (fan_out,)). Every w
    is a standard normal draw over sqrt(fan_in) and every b is zero (the
    JAX package's initialisation), drawn in that order (the embedding
    nets, then the fitting nets; layer by layer) from numpy's default
    generator seeded with ``seed`` (taken modulo 2^63)."""
    rng = np.random.default_rng(int(seed) & (2 ** 63 - 1))
    ndesc = embed_sizes[-1] * naxis

    def net(sizes):
        return [(rng.standard_normal((sizes[i], sizes[i + 1]))
                 / np.sqrt(sizes[i]), np.zeros(sizes[i + 1]))
                for i in range(len(sizes) - 1)]

    embed = [net((1,) + tuple(embed_sizes)) for _ in range(ntypes)]
    fit = [net((ndesc,) + tuple(fit_sizes) + (1,)) for _ in range(ntypes)]
    return {"embed": embed, "fit": fit}


def _map(fn, params: dict) -> dict:
    return {k: [[(fn(w), fn(b)) for w, b in net] for net in params[k]]
            for k in ("embed", "fit")}


def _flat(params: dict) -> list:
    """The JAX package's ``tree_flatten`` order: the keys sorted, each
    net's layers in order, w before b."""
    return [a for k in ("embed", "fit") for net in params[k]
            for wb in net for a in wb]


def reverse_slots(nbr, mask) -> Optional[np.ndarray]:
    """The reverse of each live entry of a table: rev[i, s] = t where
    nbr[nbr[i, s], t] = i, t live. None where some live entry has no live
    reverse or a row holds an atom twice (a table truncated below its
    occupancy); ``build_neighbors``' auto-sized tables are full."""
    nbr, mask = np.asarray(nbr, np.int64), np.asarray(mask, bool)
    na = len(nbr)
    i, s = np.nonzero(mask)
    j = nbr[i, s]
    pair = i * na + j
    if len(np.unique(pair)) != len(pair):
        return None
    order = np.argsort(pair)
    pos = np.minimum(np.searchsorted(pair[order], j * na + i),
                     max(len(pair) - 1, 0))
    found = order[pos]
    if not np.array_equal(pair[found], j * na + i):
        return None
    rev = np.zeros_like(nbr)
    rev[i, s] = s[found]
    return rev


class _Displacements(torch.autograd.Function):
    """d[..., i, s, :] = x[..., nbr[i, s], :] - x[..., i, :], by minimum
    image in a periodic cell, on a table with reverse slots
    (``reverse_slots``). Its gradient takes each atom's share from its
    neighbours' rows through the reverse slots, a gather; autograd's own
    scatters into x, sorting every index and summing each atom's entries
    one after another (on the card the largest kernel of an evaluation of
    the silicon slab). A padding entry's gradient is zero. The forward-mode
    and vmap rules serve the Hessian (``torch.func``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, nbr, rev, mask, cell):
        d = x[..., nbr, :] - x[..., :, None, :]
        if cell is not None:
            d = d - torch.round(d / cell) * cell
        return d

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, nbr, rev, mask, _ = inputs
        ctx.save_for_backward(nbr, rev, mask)
        ctx.save_for_forward(nbr)

    @staticmethod
    def backward(ctx, g):
        nbr, rev, mask = ctx.saved_tensors
        gx = torch.where(mask[..., None], g[..., nbr, rev, :] - g, 0.0)
        return gx.sum(-2), None, None, None, None

    @staticmethod
    def jvp(ctx, xt, *_):
        nbr, = ctx.saved_tensors
        return xt[..., nbr, :] - xt[..., :, None, :]


def _mlp(net, x, hidden: bool = False):
    """The net's layers with a tanh after each but the last; after the last
    too where ``hidden`` (the layers are a net's hidden ones)."""
    for i, (w, b) in enumerate(net):
        if w.shape[0] == 1:
            # a one-wide input: the product is an outer product
            x = torch.addcmul(b, x, w[0])
        else:
            x = torch.nn.functional.linear(x, w.t(), b)
        if hidden or i < len(net) - 1:
            x = torch.tanh(x)
    return x


class DeepPotSE:
    """Smooth-edition descriptor and fitting network (the JAX package's
    signature, with ``dtype`` a torch dtype and ``device``, default the
    CUDA card).

    ``types``: (na,) atom type ids from 0; ``ntypes``: the number of
    types; ``rcut``, ``rcut_smth``: the switch's ends (angstrom);
    ``neighbors``, ``nmask``: the static table of ``build_neighbors``;
    ``embed_sizes``, ``fit_sizes``: the hidden widths; ``naxis``: the
    embedding columns kept in the descriptor's second factor; ``seed``:
    the weights of ``init_params``. ``params`` holds the weights as
    tensors on ``device`` in ``dtype``, with no gradient; ``set_params``
    and ``load`` take the JAX package's layout.
    """

    def __init__(self, types, ntypes, rcut, rcut_smth, neighbors, nmask,
                 embed_sizes=(16, 32), fit_sizes=(32, 32), naxis=4,
                 cell=None, dtype=torch.float32, seed=0, device=None):
        self.types = np.asarray(types, dtype=np.int64)
        self.ntypes = int(ntypes)
        self.rcut = float(rcut)
        self.rcut_smth = float(rcut_smth)
        self.nbr = np.asarray(neighbors, dtype=np.int64)
        self.nmask = np.asarray(nmask, dtype=bool)
        self.naxis = int(naxis)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cell = None if cell is None else np.asarray(cell, float)
        self.embed_sizes = tuple(int(n) for n in embed_sizes)
        self.fit_sizes = tuple(int(n) for n in fit_sizes)
        if self.naxis > self.embed_sizes[-1]:
            raise ValueError(f"DeepPotSE: naxis {self.naxis} exceeds the "
                             f"embedding width {self.embed_sizes[-1]}")
        arrays = dict(nbr=self.nbr, mask=self.nmask)
        rev = reverse_slots(self.nbr, self.nmask)
        if rev is not None:
            arrays["rev"] = rev
        if self.ntypes > 1:
            arrays["ntype"] = self.types[self.nbr].astype(np.int32)
            arrays["ctype"] = self.types
        if self.cell is not None:
            arrays["cell"] = self.cell
        self._consts = Consts(**arrays)
        self._moved = {}
        self.set_params(init_params(seed, self.ntypes, self.embed_sizes,
                                    self.fit_sizes, self.naxis))

    def set_params(self, params: dict) -> dict:
        """Take weights in the JAX package's layout (numpy or JAX arrays,
        or tensors) as this model's ``params``."""
        self.params = _map(lambda a: torch.as_tensor(
            np.array(a) if not torch.is_tensor(a) else a,
            dtype=self.dtype, device=self.device), params)
        self._moved = {}
        return self.params

    def _on(self, params: dict, x: torch.Tensor) -> dict:
        """``params`` on the device and in the dtype of ``x`` (a copy made
        once, outside any torch.func transform, as ``Consts.on``)."""
        w = params["embed"][0][0][0]
        if w.device == x.device and w.dtype == x.dtype:
            return params
        key = (x.device, x.dtype)
        got = self._moved.get(key)
        if got is None or got[0] is not params:
            with torch._C._DisableFuncTorch():
                got = (params, _map(lambda t: t.to(x.device, x.dtype),
                                    params))
            self._moved[key] = got
        return got[1]

    # -- energy ------------------------------------------------------------
    def energy(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Total potential energy (eV) of positions x (..., na, 3), one a
        leading index."""
        k = self._consts.on(x)
        p = self._on(params, x)
        mask = k["mask"]
        if "rev" in k:
            d = _Displacements.apply(x, k["nbr"], k["rev"], mask,
                                     k.get("cell"))
        else:
            d = x[..., k["nbr"], :] - x[..., :, None, :]
            if "cell" in k:
                d = d - torch.round(d / k["cell"]) * k["cell"]
        # d: (..., na, nn, 3)
        r2 = (d * d).sum(-1)
        r = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
        sw = smooth_switch(r, self.rcut_smth, self.rcut)
        s = torch.where(mask, sw / r, torch.zeros_like(r))
        R = torch.cat([s[..., None], s[..., None] * (d / r[..., None])],
                      dim=-1)                               # (..., na, nn, 4)
        # the embedding's hidden layers on each entry by its neighbour's
        # type; its last layer, which is linear, after the sum over entries
        # (K13 on the card in float32; float64 takes the twin on either
        # device). A padding entry has R = 0, so it adds exact zeros to G
        embed = p["embed"]
        h2 = None
        for tp in range(self.ntypes):
            e = _mlp(embed[tp][:-1], s[..., None], hidden=True)
            h2 = e if h2 is None else \
                torch.where((k["ntype"] == tp)[..., None], e, h2)
        desc = K13.descriptor if x.dtype == torch.float32 else \
            K13.descriptor_plain
        D = desc(h2, R, [net[-1][0] for net in embed],
                 [net[-1][1] for net in embed], k.get("ntype"),
                 self.naxis)                               # (..., na, ndesc)
        e_at = None
        for tp in range(self.ntypes):
            e = _mlp(p["fit"][tp], D)[..., 0]
            e_at = e if e_at is None else \
                torch.where(k["ctype"] == tp, e, e_at)
        return e_at.sum(-1)

    def energy_fn(self, params: Optional[dict] = None):
        p = self.params if params is None else params
        return lambda x: self.energy(p, x)

    def forces(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            g, = torch.autograd.grad(self.energy(params, x).sum(), x)
        return -g

    # -- persistence -------------------------------------------------------
    def save(self, path):
        """The JAX package's file: ``n`` and ``p{i}`` in its flattened
        order, so either package reads the other's."""
        flat = _flat(self.params)
        np.savez(path, n=len(flat), **{f"p{i}": a.detach().cpu().numpy()
                                       for i, a in enumerate(flat)})

    def load(self, path) -> dict:
        with np.load(path) as data:
            flat = iter([data[f"p{i}"] for i in range(int(data["n"]))])
        return self.set_params(_map(lambda _: next(flat), self.params))


class deepmddriver(DriverShell):
    """Force driver of a ``DeepPotSE`` (the JAX package's signature, with
    ``device``, default the model's, and ``baseline``).

    The force is the autograd of the model's energy (a forward pass and
    its input-gradient backward; the weights take no gradient), relative
    to its force at q = 0. ``baseline``: another driver of the same atoms
    whose force, relative to its own f0, is added to the network's (the
    overlay DeePMD-kit runs as DP+ZBL or through LAMMPS'
    ``hybrid/overlay``); energies and Hessians are the sums of both.

    The network's force makes its tensors from the caching allocator with
    no host sync, so the driver is ``capturable`` (``md.graph_plan``
    replays its step as a CUDA graph) where its baseline is, or has none.
    """

    def __init__(self, model, axyz, md2ang=U.MD2ANG, dtype=torch.float32,
                 device=None, baseline=None):
        self.model = model
        self.baseline = baseline
        self._md2ang = md2ang
        self._dtype = dtype
        self._device = model.device if device is None else device
        self._axyz = axyz
        with profiling.span("setup/driver"):
            self.refresh()

    @property
    def capturable(self) -> bool:
        return self.baseline is None or bool(
            getattr(self.baseline, "capturable", False))

    def refresh(self):
        """Rebind the driver to the model's current ``params`` (after
        ``set_params`` or ``load``) and take the forces at q = 0 again."""
        net_fn = self.model.energy_fn()
        self._net = TorchDriver(net_fn, self._axyz, md2ang=self._md2ang,
                                dtype=self._dtype, device=self._device)
        energy_fn, base = net_fn, self.baseline
        if base is not None:
            if base.number != self._net.number or not np.allclose(
                    base.conv, self._net.conv, rtol=1e-12, atol=0):
                raise ValueError("deepmddriver: the baseline driver holds "
                                 "other atoms than the model")
            base_fn = base.energy_fn

            def energy_fn(x):
                return net_fn(x) + base_fn(x)

        self._attach(energy_fn, self._axyz, self._dtype, self._device,
                     md2ang=self._md2ang)
        self.f0 = self._net.f0 if base is None else \
            self._net.f0 + torch.as_tensor(base.f0, dtype=self._net.dtype,
                                           device=self._net.device)

    def dpstart(self, path):
        """Load persisted model parameters and rebind the force path (the
        upstream's DeepPot(.pb) launch)."""
        self.model.load(path)
        self.refresh()

    def initforce(self):
        self.refresh()

    def force_torch(self, q: torch.Tensor) -> torch.Tensor:
        global launches
        launches += 1
        f = self._net.force_torch(q)
        if self.baseline is not None:
            f += self.baseline.force_torch(q)
        return f

    def force(self, q):
        return self.force_torch(self._drv._tensor(q))

    def absforce(self, q):
        return self.force(q) + self.f0

    def energy_force_torch(self, q):
        return self.energy_torch(q).detach(), self.force_torch(q)
