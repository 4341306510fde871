"""K5: the many-body C/H force (``models.hydrocarbon.CHDriver``), batched
over trajectories.

    f(q) = conv * F(xyz + conv q) - f0,    F = -dE/dx of ``ch_energy``

``CHForce`` launches the hand-written kernel (csrc/ch_force.cu: the
analytic gradient, one launch per evaluation) on CUDA tensors and runs
the plain twin, ``torch.autograd`` of the ported energy function, on CPU
tensors.

Every term of the energy depends on the positions through difference
vectors x_b - x_a only. ``pack_operands`` lists them as *slots*: one per
entry of the carbon neighbour table (tail: the centre, head: the
neighbour), one per Morse bond and per auxiliary spring (tail: the H),
three per wag term (anchor -> H, anchor -> each adjacent carbon). The
kernel writes dE/d(x_b - x_a) into each slot; the force on an atom is
the sum over the slots it is the tail of minus the sum over the slots it
is the head of, which ``pack_operands`` lists per atom in a fixed order
(so the kernel needs no float atomics and repeats bitwise).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sclmd_tpu_torch.kernels import build

launches = 0          # ch_force kernel launches (not twin calls)

MAX_NN = 16           # CH_MAX_NN in csrc/ch_force.cu: widest table row
# CH_MAX_THREADS: the kernel is compiled for two CTAs of this size to an
# SM (at most 102 registers a thread). Compiled for one CTA of 512, a
# thread took 117 registers and the 1024 CTAs of the flagship's largest
# chunk ran one to an SM: 95.6 us an evaluation against 53.8 us in this
# form, 14.5 against 14.3 us at 128 trajectories (tools/plain_bench.py
# --workload flagship_mb, both builds in turns on one H100, 700 W)
MAX_THREADS = 320
SMEM_LIMIT = 227 * 1024   # dynamic shared memory a CTA may ask for (H100)
# rough float32 operations of one work item, for the roofline bound of
# ``work_counts``: a table entry's geometry (difference, norm, cutoff), a
# pair inside the cutoff (two exponentials, the bond order), an angular
# term (both passes), a bond or spring, a wag term, a slot added to an atom
OPS = dict(entry=30, pair=60, triple=110, bond=30, wag=90, gather=6)


def reset_count():
    global launches
    launches = 0


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def pack_operands(terms: dict, xyz, conv) -> dict:
    """The kernel's constant operands as host numpy, from
    ``ch_energy(...).terms`` and the driver's ``xyz``/``conv``.

    Raises on a periodic cell (left to the twin) and on a table wider
    than ``MAX_NN``. Keys: ``catom`` (nc), ``nbr`` (nc, nn) atom indices
    with -1 for no neighbour and nn padded to a multiple of 4; ``pair_ab``
    (npair, 2) with the ``nbond`` Morse bonds first, ``pair_r0`` (npair);
    ``oop`` (noop, 4); ``slot_ab`` (nslots, 2) tail and head atom of every
    slot (-1, -1 for a padded table entry) and ``d0`` (nslots, 3) its
    reference vector (float64 difference, rounded once); ``csr_ptr`` (na +
    1) and ``csr`` with entries ``slot << 1 | head`` in slot order; the
    scalar parameters under ``scalars``."""
    if terms.get("cell") is not None:
        raise NotImplementedError(
            "ch_force: the kernel handles open boundaries only; a periodic "
            "cell runs through the autograd twin (CPU tensors)")
    x0 = np.asarray(xyz, np.float64).reshape(-1, 3)
    na = len(x0)
    c_ids = np.asarray(terms["c_ids"], np.int64)
    nbr_c = np.asarray(terms["nbr_c"], np.int64)
    mask_c = np.asarray(terms["mask_c"], bool)
    nc, nn0 = nbr_c.shape if nbr_c.size else (len(c_ids), 4)
    nn = max(4, _up4(nn0))
    if nn > MAX_NN:
        raise ValueError(f"ch_force: neighbour table of width {nn0} exceeds "
                         f"the kernel's {MAX_NN}")
    nbr = np.full((nc, nn), -1, np.int64)
    nbr[:, :nn0] = np.where(mask_c, c_ids[nbr_c], -1)

    bonds = np.asarray(terms["bonds"], np.int64).reshape(-1, 2)
    aux = np.asarray(terms["aux"], np.int64).reshape(-1, 2)
    oop = np.asarray(terms["oop"], np.int64).reshape(-1, 4)
    pair_ab = np.concatenate([bonds, aux], axis=0)
    pair_r0 = np.concatenate([np.zeros(len(bonds)),
                              np.asarray(terms["aux_r0"], np.float64)])

    tail = np.repeat(c_ids, nn)
    head = nbr.reshape(-1)
    slot_ab = [np.stack([np.where(head >= 0, tail, -1), head], axis=1),
               pair_ab]
    if len(oop):
        slot_ab.append(np.stack(
            [np.repeat(oop[:, 1], 3), oop[:, [0, 2, 3]].reshape(-1)],
            axis=1))
    slot_ab = np.concatenate(slot_ab, axis=0)
    live = slot_ab[:, 0] >= 0
    d0 = np.zeros((len(slot_ab), 3))
    d0[live] = x0[slot_ab[live, 1]] - x0[slot_ab[live, 0]]

    # per atom, the slots that touch it, in slot order
    per_atom = [[] for _ in range(na)]
    for s, (ta, hb) in enumerate(slot_ab):
        if ta >= 0:
            per_atom[ta].append(2 * s)
            per_atom[hb].append(2 * s + 1)
    csr_ptr = np.concatenate([[0], np.cumsum([len(p) for p in per_atom])])
    csr = np.asarray([e for p in per_atom for e in p], np.int64)

    tp, mo = terms["tersoff"], terms["morse"]
    scalars = dict(
        A=tp["A"], B=tp["B"], lam1=tp["lam1"], lam2=tp["lam2"],
        lam3=tp["lam3"], beta=tp["beta"], n=tp["n"], c2=tp["c"] ** 2,
        d2=tp["d"] ** 2, h=tp["h"], gamma=tp["gamma"], m=tp["m"], R=tp["R"],
        D=tp["D"], mD=mo["D"], malpha=mo["alpha"], mr0=mo["r0"],
        # the bond list's Morse term is cut at cutoff + 1 and not shifted
        mcut=mo["cutoff"] + 1.0, meshift=0.0,
        kbend=terms["k_bend"], koop=terms["k_oop"],
        n2min=terms["oop_n2_min"])
    return dict(na=na, nc=nc, nn=nn, nbond=len(bonds), npair=len(pair_ab),
                noop=len(oop), nslots=len(slot_ab), catom=c_ids, nbr=nbr,
                pair_ab=pair_ab, pair_r0=pair_r0, oop=oop, slot_ab=slot_ab,
                d0=d0, csr_ptr=csr_ptr, csr=csr, conv=np.asarray(conv, float),
                scalars=scalars)


def launch_plan(pack: dict) -> dict:
    """Threads per CTA (one CTA per trajectory: a thread per work item,
    and per atom in the closing sum, up to ``MAX_THREADS``) and the CTA's
    dynamic shared memory: the displacements, the slots, one partial
    energy per warp."""
    items = pack["nc"] + pack["npair"] + pack["noop"]
    threads = min(MAX_THREADS, max(32, -(-max(items, pack["na"]) // 32) * 32))
    smem = 4 * (_up4(3 * pack["na"]) + 3 * pack["nslots"]
                + MAX_THREADS // 32)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ch_force: {pack['na']} atoms and {pack['nslots']} "
                         f"slots need {smem} bytes of shared memory, above "
                         f"the card's {SMEM_LIMIT}")
    return dict(items=items, threads=threads, smem_bytes=smem)


def work_counts(pack: dict) -> dict:
    """What one trajectory's evaluation needs at the reference geometry:
    the table entries, the pairs inside the Tersoff cutoff R + D, the
    angular terms among them, and a float32 operation count from ``OPS``
    (the kernel skips everything outside the cutoff, so the bound counts
    what this geometry needs, not the padded table)."""
    nc, nn = pack["nc"], pack["nn"]
    s = pack["scalars"]
    r = np.linalg.norm(pack["d0"][:nc * nn].reshape(nc, nn, 3), axis=-1)
    inside = (pack["nbr"] >= 0) & (r < s["R"] + s["D"])
    k = inside.sum(1)
    entries = int((pack["nbr"] >= 0).sum())
    pairs, triples = int(k.sum()), int((k * (k - 1)).sum())
    ops = (OPS["entry"] * entries + OPS["pair"] * pairs
           + OPS["triple"] * triples + OPS["bond"] * pack["npair"]
           + OPS["wag"] * pack["noop"] + OPS["gather"] * len(pack["csr"]))
    return dict(entries=entries, pairs=pairs, triples=triples, ops=ops,
                bytes=4 * 2 * 3 * pack["na"])


class _ChArgs(ctypes.Structure):
    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "q", "f", "e", "conv", "f0", "d0", "catom", "nbr", "pair_ab",
            "pair_r0", "oop", "csr_ptr", "csr")]
        + [(k, ctypes.c_int) for k in (
            "ntraj", "na", "nc", "nn", "nbond", "npair", "noop", "nslots",
            "threads", "smem_bytes")]
        + [(k, ctypes.c_float) for k in (
            "A", "B", "lam1", "lam2", "lam3", "beta", "n", "c2", "d2", "h",
            "gamma", "m", "R", "D", "mD", "malpha", "mr0", "mcut",
            "meshift", "kbend", "koop", "n2min")])


class CHForceCuda:
    """K5 on one device: the packed constants live on the card; each call
    passes q and gets the force (and the energy on request) in buffers of
    its own. ``f0`` is the kernel's own force at q = 0, so that the force
    at the reference geometry is exactly zero."""

    def __init__(self, pack: dict, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError("ch_force: the kernel takes CUDA tensors")
        self.pack, self.device = pack, device
        self.plan = launch_plan(pack)
        self.lib = build.load()
        if self.lib.ch_force_max_nn() != MAX_NN or \
                self.lib.ch_force_max_threads() != MAX_THREADS:
            raise RuntimeError("ch_force: limits differ from the kernel's")
        self.nph = 3 * pack["na"]

        def dev(x, dtype):
            # (an empty list still needs an address to pass)
            x = np.ascontiguousarray(x).reshape(-1)
            return torch.as_tensor(x if len(x) else np.zeros(1), dtype=dtype,
                                   device=device)

        self._t = {k: dev(pack[k], torch.float32)
                   for k in ("conv", "d0", "pair_r0")}
        self._t.update({k: dev(pack[k], torch.int32)
                        for k in ("catom", "nbr", "pair_ab", "oop", "csr_ptr",
                                  "csr")})
        a = _ChArgs()
        for k, t in self._t.items():
            setattr(a, k, t.data_ptr())
        for k in ("na", "nc", "nn", "nbond", "npair", "noop", "nslots"):
            setattr(a, k, pack[k])
        a.threads, a.smem_bytes = self.plan["threads"], \
            self.plan["smem_bytes"]
        for k, v in pack["scalars"].items():
            setattr(a, k, float(v))
        self.args = a
        self.f0 = torch.zeros(self.nph, dtype=torch.float32, device=device)
        a.f0 = self.f0.data_ptr()
        self.f0 = self(torch.zeros((1, self.nph), dtype=torch.float32,
                                   device=device))[0].clone()
        a.f0 = self.f0.data_ptr()

    def __call__(self, q: torch.Tensor, energy: bool = False):
        global launches
        if q.device != self.device or q.dtype != torch.float32:
            raise TypeError("ch_force: q must be a float32 tensor on "
                            f"{self.device} (got {q.dtype} on {q.device})")
        if q.shape[-1] != self.nph or q.ndim not in (1, 2):
            raise ValueError(f"ch_force: q must be (traj, {self.nph}) or "
                             f"({self.nph},), got {tuple(q.shape)}")
        q2 = q.reshape(-1, self.nph).contiguous()
        f = torch.empty_like(q2)
        e = torch.empty(q2.shape[0], dtype=torch.float32,
                        device=self.device) if energy else None
        a = self.args
        a.q, a.f, a.ntraj = q2.data_ptr(), f.data_ptr(), q2.shape[0]
        a.e = e.data_ptr() if energy else None
        rc = self.lib.ch_force_f32(ctypes.byref(a),
                                   build.current_stream(self.device))
        build.check(rc, "ch_force")
        launches += 1
        f = f.reshape(q.shape)
        return (e.reshape(q.shape[:-1]), f) if energy else f


class CHForce:
    """``q -> conv * F(xyz + conv q) - f0`` of a C/H driver: kernel K5 for
    a CUDA tensor, the autograd twin for a CPU tensor.

    ``terms``: ``ch_energy(...).terms``; ``driver``: the ``TorchDriver``
    holding the energy function (the twin). For a driver on the card in
    float32 the kernel is built and its f0 taken at construction; a
    periodic cell or another dtype raises at the first CUDA call."""

    def __init__(self, terms: dict, driver):
        self.terms, self.driver = terms, driver
        self.cuda = None
        if driver.device.type == "cuda" and driver.dtype == torch.float32 \
                and terms.get("cell") is None:
            self.cuda = CHForceCuda(
                pack_operands(terms, driver.xyz, driver.conv), driver.device)

    def plain(self, q: torch.Tensor, energy: bool = False):
        """The twin: autograd of the energy function, batched."""
        f = self.driver.force_torch(q)
        return (self.driver.energy_torch(q).detach(), f) if energy else f

    def __call__(self, q: torch.Tensor, energy: bool = False):
        if q.device.type == "cpu":
            return self.plain(q, energy)
        if self.cuda is None:
            # raises with the reason (a cell, the table's width), or builds
            self.cuda = CHForceCuda(
                pack_operands(self.terms, self.driver.xyz, self.driver.conv),
                self.driver.device)
        return self.cuda(q, energy)


def analytic_force_numpy(pack: dict, q, f0=None):
    """The kernel's formulas in float64 numpy, term by term and slot by
    slot as csrc/ch_force.cu computes them: (energy (traj,), force (traj,
    nph)) for q (traj, nph). The CPU tests hold it against the autograd
    twin, which checks the analytic gradient and ``pack_operands`` where
    no card is at hand; nothing else calls it."""
    s = pack["scalars"]
    q = np.asarray(q, np.float64).reshape(-1, 3 * pack["na"])
    nc, nn = pack["nc"], pack["nn"]
    cd = s["c2"] / s["d2"]
    w = 0.5 * np.pi / s["D"]
    es, fs = [], []
    for qt in q:
        u = (pack["conv"] * qt).reshape(-1, 3)
        ab = pack["slot_ab"]
        d = pack["d0"] + np.where(ab[:, :1] >= 0, u[ab[:, 1]] - u[ab[:, 0]],
                                  0.0)
        grad = np.zeros_like(d)
        energy = 0.0
        for i in range(nc):
            sl = slice(i * nn, (i + 1) * nn)
            live = pack["nbr"][i] >= 0
            r = np.where(live, np.linalg.norm(d[sl], axis=1), 1.0)
            hat = np.where(live[:, None], d[sl] / r[:, None], 0.0)
            mid = live & (r >= s["R"] - s["D"]) & (r <= s["R"] + s["D"])
            fc = np.where(live & (r < s["R"] - s["D"]), 1.0, np.where(
                mid, 0.5 - 0.5 * np.sin(w * (r - s["R"])), 0.0))
            dfc = np.where(mid, -0.5 * w * np.cos(w * (r - s["R"])), 0.0)
            g_row = np.zeros((nn, 3))
            for j in range(nn):
                if fc[j] == 0.0:
                    continue
                ks = [k for k in range(nn) if k != j and
                      not (fc[k] == 0.0 and dfc[k] == 0.0)]

                def angular(k):
                    cs = hat[j] @ hat[k]
                    hc = s["h"] - cs
                    den = s["d2"] + hc * hc
                    g = s["gamma"] * (1.0 + cd * hc * hc / den)
                    dg = -2.0 * s["gamma"] * s["c2"] * hc / den ** 2
                    ex, dex = 1.0, 0.0
                    if s["lam3"] != 0.0:
                        y = s["lam3"] * (r[j] - r[k])
                        ex = np.exp(y ** s["m"])
                        dex = ex * s["m"] * y ** (s["m"] - 1.0) * s["lam3"]
                    return cs, g, dg, ex, dex

                zeta = sum(fc[k] * angular(k)[1] * angular(k)[3] for k in ks)
                bz = s["beta"] * zeta
                b, dbdz = 1.0, 0.0
                if bz > 0:
                    bzn = bz ** s["n"]
                    b = (1.0 + bzn) ** (-0.5 / s["n"])
                    dbdz = -0.5 * b * bzn / ((1.0 + bzn) * zeta)
                fR = s["A"] * np.exp(-s["lam1"] * r[j])
                fA = -s["B"] * np.exp(-s["lam2"] * r[j])
                energy += 0.5 * fc[j] * (fR + b * fA)
                gj = 0.5 * (dfc[j] * (fR + b * fA) + fc[j] * (
                    -s["lam1"] * fR - s["lam2"] * b * fA)) * hat[j]
                az = 0.5 * fc[j] * fA * dbdz
                for k in ks:
                    cs, g, dg, ex, dex = angular(k)
                    ang = az * fc[k] * ex * dg
                    g_row[k] += az * (dfc[k] * g * ex - fc[k] * g * dex) \
                        * hat[k] + ang / r[k] * (hat[j] - cs * hat[k])
                    gj = gj + az * fc[k] * g * dex * hat[j] \
                        + ang / r[j] * (hat[k] - cs * hat[j])
                g_row[j] += gj
            grad[sl] = g_row
        base = nc * nn
        for p in range(pack["npair"]):
            dv = d[base + p]
            r = np.linalg.norm(dv)
            e = dedr = 0.0
            if p < pack["nbond"]:
                if r < s["mcut"]:
                    ex = np.exp(-s["malpha"] * (r - s["mr0"]))
                    e = s["mD"] * (ex * ex - 2 * ex) - s["meshift"]
                    dedr = 2 * s["malpha"] * s["mD"] * ex * (1 - ex)
            else:
                dr = r - pack["pair_r0"][p]
                e, dedr = 0.5 * s["kbend"] * dr * dr, s["kbend"] * dr
            energy += e
            grad[base + p] = dedr / r * dv
        base += pack["npair"]
        for o in range(pack["noop"]):
            uu, e1, e2 = d[base + 3 * o: base + 3 * o + 3]
            nv = np.cross(e1, e2)
            n2 = nv @ nv
            if n2 > s["n2min"]:
                nh = nv / np.sqrt(n2)
                sc = uu @ nh
                energy += 0.5 * s["koop"] * sc * sc
                wv = s["koop"] * sc * (uu - sc * nh) / np.sqrt(n2)
                grad[base + 3 * o] = s["koop"] * sc * nh
                grad[base + 3 * o + 1] = np.cross(e2, wv)
                grad[base + 3 * o + 2] = np.cross(wv, e1)
        f = np.zeros((pack["na"], 3))
        for at in range(pack["na"]):
            for ent in pack["csr"][pack["csr_ptr"][at]:
                                   pack["csr_ptr"][at + 1]]:
                f[at] += (-1.0 if ent & 1 else 1.0) * grad[ent >> 1]
        es.append(energy)
        fs.append(pack["conv"] * f.reshape(-1))
    f = np.stack(fs)
    return np.asarray(es), f if f0 is None else f - np.asarray(f0)
