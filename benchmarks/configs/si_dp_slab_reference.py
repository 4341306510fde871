"""Plain PyTorch reference of si_dp_slab: the silicon slab of
``si_dp_slab.json`` as a ``reference.gle.System``, with a DeepPot-SE
network written out here from the paper (Zhang et al., NeurIPS 2018) in
the form the configuration states, overlaid on the Stillinger-Weber
energy of ``si_slab_reference``, and the force of their sum by autograd.

The network, over positions x (S, na, 3) in angstrom, on its own static
periodic table of the reference geometry (a row for each atom: the atoms
within rcut + skin by minimum image, nearest first, each entry keeping
the image it was found at; nn, the table's width, is the largest row
rounded up to a multiple of 4):

    s_ij = sw(r_ij) / r_ij,  sw = 1 - 6 u^5 + 15 u^4 - 10 u^3,
           u = (r - rcut_smth) / (rcut - rcut_smth) clipped to [0, 1]
    R_ij = s_ij (1, d_ij / r_ij)                     d_ij = x_j - x_i
    e_ij = N_emb(s_ij)       1 -> 25 -> 50 -> 100, tanh after each layer
                             but the last
    G_i  = (1 / nn) sum_j e_ij (x) R_ij              (100, 4)
    D_i  = G_i G_i[:16]^T, flattened row by row      (1,600)
    E_i  = N_fit(D_i)        1,600 -> 240 -> 240 -> 240 -> 1, tanh after
                             each layer but the last
    E    = sum_i E_i + E_SW

with a layer x -> x w + b. The departures from DeePMD-kit's
``se_e2_a`` are the configuration's (``assumed``). The force in the
mass-weighted coordinates is conv f(x0 + conv q) - f0, conv = MD2ANG /
sqrt(mass), f0 the force at q = 0, computed for blocks of ``BLOCK``
trajectories at a time so that the network's activations fit.

The weights (``weights``) are an input the harness makes from the run's
seed and hands to the program, in the JAX package's layout: each w a
standard normal draw over sqrt(fan_in), each b zero, drawn from numpy's
default generator seeded with the seed (modulo 2^63), the embedding net
then the fitting net, layer by layer; then the output layer's w scaled
so that the network's force has ``force_share`` of the SW force's RMS
on the probe (``probe_cells`` of the lattice, each coordinate displaced
by a normal draw of ``probe_rms`` angstrom from numpy's generator
seeded 0; the output is linear in that layer), and every number rounded
to float32, the configuration's precision. A random net's own force is
1e-6 to 1e-5 of the SW force, too small for the check to see. The
builder records the run's seed under ``deeppot.weights_seed`` before
this module reads the configuration; a configuration without one (the
control, which builds no runner) takes seed 0.

Precision: every matrix product of the network goes through ``_mm``,
which in ``"tf32"`` rounds both operands of each product of the forward
pass and of its gradient to TF32 and accumulates in float32, as a tensor
core does. TF32 is switched off for torch's own products here.
"""

import numpy as np
import torch

from benchmarks.configs.si_slab import geometry, partition
from benchmarks.configs.si_slab_reference import AtRest, SWModel, \
    wideband_bath
from benchmarks.reference import gle
from benchmarks.reference.units import MD2ANG

# trajectories a force evaluation takes at once
BLOCK = 4
TF32 = gle.Prec("tf32")


class _TF32Product(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, in the forward pass and
    in each product of its gradient."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return TF32.round(a) @ TF32.round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = TF32.round(g)
        ga = g @ TF32.round(b).transpose(-1, -2) \
            if ctx.needs_input_grad[0] else None
        gb = TF32.round(a).transpose(-1, -2) @ g \
            if ctx.needs_input_grad[1] else None
        return ga, gb


def _mm(a, b, prec):
    return _TF32Product.apply(a, b) if prec.name == "tf32" else a @ b


def _mlp(net, x, prec):
    for i, (w, b) in enumerate(net):
        x = x * w[0] + b if w.shape[0] == 1 else _mm(x, w, prec) + b
        if i < len(net) - 1:
            x = torch.tanh(x)
    return x


def _sizes(dp):
    emb = (1,) + tuple(dp["neuron"])
    fit = (dp["neuron"][-1] * dp["axis_neuron"],) \
        + tuple(dp["fitting_neuron"]) + (1,)
    return emb, fit


def draws(seed: int, dp) -> list:
    """[embedding net, fitting net], each a list of (w, b) float64 arrays:
    the seeded draw of the module docstring, before any scaling."""
    rng = np.random.default_rng(int(seed) & (2 ** 63 - 1))
    return [[(rng.standard_normal((n[i], n[i + 1])) / np.sqrt(n[i]),
              np.zeros(n[i + 1])) for i in range(len(n) - 1)]
            for n in _sizes(dp)]


class DeepPotModel:
    def __init__(self, x0, cell, dp):
        na = len(x0)
        self.dp = dp
        reach = dp["rcut"] + dp["skin"]
        rows = []
        for i in range(na):
            d = x0 - x0[i]
            img = d - cell * np.round(d / cell)
            r = np.linalg.norm(img, axis=1)
            r[i] = np.inf
            near = np.argsort(r, kind="stable")
            near = near[r[near] < reach]
            rows.append((near, img[near] - d[near]))
        width = max(4, -(-max(len(n) for n, _ in rows) // 4) * 4)
        nbr = np.zeros((na, width), np.int64)
        live = np.zeros((na, width), bool)
        shift = np.zeros((na, width, 3))
        for i, (near, sh) in enumerate(rows):
            n = len(near)
            nbr[i, :n], live[i, :n], shift[i, :n] = near, True, sh
        self.nbr, self.live, self.shift = nbr, live, shift
        r0 = np.linalg.norm(x0[nbr] - x0[:, None] + shift, axis=-1)
        emb, fit = _sizes(dp)
        # what one evaluation of one trajectory has to compute: the
        # entries inside the cutoff and the atoms, through these layers
        self.counts = dict(atoms=na, slots=width,
                           inside=int((live & (r0 < dp["rcut"])).sum()),
                           embed=list(emb), fit=list(fit),
                           axis=dp["axis_neuron"])
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

    def energy(self, x, net, prec):
        """(S,) network energies; ``net`` the weights as tensors in x's
        dtype."""
        t, dp = self._tensors(x.device, x.dtype), self.dp
        nbr, live = t["nbr"], t["live"]
        d = x[:, nbr] - x[:, :, None] + t["shift"]          # (S, na, W, 3)
        r2 = (d * d).sum(-1)
        # a padding entry has s = 0
        r = torch.sqrt(torch.where(live, r2, torch.ones_like(r2)))
        u = ((r - dp["rcut_smth"]) / (dp["rcut"] - dp["rcut_smth"])) \
            .clamp(0.0, 1.0)
        sw = 1.0 - 6.0 * u ** 5 + 15.0 * u ** 4 - 10.0 * u ** 3
        s = torch.where(live, sw / r, torch.zeros_like(r))
        R = torch.cat([s[..., None], s[..., None] * d / r[..., None]], -1)
        e = _mlp(net[0], s[..., None], prec)                 # (S, n, W, 100)
        G = _mm(e.transpose(-1, -2), R, prec) / self.nbr.shape[1]
        D = _mm(G, G[..., :dp["axis_neuron"], :].transpose(-1, -2), prec)
        return _mlp(net[1], D.flatten(-2), prec)[..., 0].sum(-1)


def probe_forces(cfg, nets):
    """RMS of the SW force and of the network's (``nets``, float64
    arrays) on the probe of the module docstring, float64 on the CPU."""
    dp = cfg["deeppot"]
    axyz, cell = geometry(dict(cfg, cells=dp["probe_cells"]))
    x0 = np.array([a[1:] for a in axyz], float)
    x = torch.as_tensor(x0 + dp["probe_rms"] * np.random.default_rng(
        0).standard_normal(x0.shape))[None].requires_grad_(True)
    nb = cfg["neighbours"]
    f64 = gle.Prec("float64")
    net = [[(torch.as_tensor(w), torch.as_tensor(b)) for w, b in n]
           for n in nets]
    out = []
    for e in (SWModel(x0, cell, cfg["sw"], nb["slots"], nb["skin"])
              .energy(x), DeepPotModel(x0, cell, dp).energy(x, net, f64)):
        g, = torch.autograd.grad(e.sum(), x)
        out.append(float(g.pow(2).mean().sqrt()))
    return out


def weights(cfg) -> list:
    """The run's weights (module docstring): [embedding net, fitting
    net] of float64 arrays holding float32 numbers."""
    dp = cfg["deeppot"]
    nets = draws(dp.get("weights_seed", 0), dp)
    sw, net = probe_forces(cfg, nets)
    w, b = nets[1][-1]
    nets[1][-1] = (w * (dp["force_share"] * sw / net), b)
    return [[(w.astype(np.float32).astype(np.float64),
              b.astype(np.float32).astype(np.float64)) for w, b in n]
            for n in nets]


def system(cfg, nmd=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    axyz, cell = geometry(cfg)
    left, right = partition(cfg)
    x0 = np.array([a[1:] for a in axyz], float)
    nb = cfg["neighbours"]
    sw = SWModel(x0, cell, cfg["sw"], nb["slots"], nb["skin"])
    dpm = DeepPotModel(x0, cell, cfg["deeppot"])
    nets = weights(cfg)
    na = len(axyz)
    conv = np.full(3 * na, MD2ANG / np.sqrt(cfg["mass"]))
    cache = {}

    def force(q, prec):
        key = (q.device, prec.dtype)
        if key not in cache:
            xyz = torch.as_tensor(x0.ravel(), dtype=prec.dtype,
                                  device=q.device)
            cv = torch.as_tensor(conv, dtype=prec.dtype, device=q.device)
            net = [[(torch.as_tensor(w, dtype=prec.dtype, device=q.device),
                     torch.as_tensor(b, dtype=prec.dtype, device=q.device))
                    for w, b in n] for n in nets]
            cache[key] = (xyz, cv, net, 0.0)
            cache[key] = (xyz, cv, net, absforce(torch.zeros(
                (1, 3 * na), dtype=prec.dtype, device=q.device), key, prec))
        return absforce(q, key, prec) - cache[key][3]

    def absforce(q, key, prec):
        xyz, cv, net, _ = cache[key]
        out = []
        for q1 in q.split(BLOCK):
            with torch.enable_grad():
                x = (xyz + cv * q1.detach()).reshape(q1.shape[0], na, 3)
                x.requires_grad_(True)
                e = sw.energy(x) + dpm.energy(x, net, prec)
                g, = torch.autograd.grad(e.sum(), x)
            out.append(-cv * g.reshape(q1.shape))
        return torch.cat(out)

    T, dl = cfg["T"], cfg["delta"]
    nmd = nmd or cfg["nmd"]
    baths = [wideband_bath(c, tt, cfg, nmd)
             for c, tt in ((left, T * (1 + dl / 2)),
                           (right, T * (1 - dl / 2)))]
    s = AtRest(nph=3 * na, dt=cfg["dt"], nmd=nmd, T=T, dyn=None,
               baths=baths, force=force)
    # the work files read K9's terms under "sw" and the network's under
    # "dp"
    s.potential = dict(kind="sw", counts=sw.counts, dp=dpm.counts)
    return s
