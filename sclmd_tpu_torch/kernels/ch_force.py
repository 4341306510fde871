"""K5 and K8: the many-body force of a carbon system, batched over
trajectories. K5 is the C/H junction's (``models.hydrocarbon.CHDriver``),
K8 a single-element Tersoff system's (``models.tersoff.TersoffDriver``);
one kernel serves both, through two packs of its operands.

    f(q) = conv * F(xyz + conv q) - f0,    F = -dE/dx of the energy

``CHForce`` launches the hand-written kernel (csrc/ch_force.cu: the
analytic gradient, one launch per evaluation) on CUDA tensors and runs
the plain twin, ``torch.autograd`` of the ported energy function, on CPU
tensors.

Every term of the energy depends on the positions through difference
vectors x_b - x_a only. ``pack_operands`` (C/H) and ``pack_tersoff``
(Tersoff) list them as *slots*: one per live entry of the Tersoff
neighbour table, compacted into a CSR by centre (tail: the centre, head:
the neighbour), one per Morse bond and per auxiliary spring (tail: the
H), three per wag term (anchor -> H, anchor -> each adjacent carbon).
The kernel writes dE/d(x_b - x_a) into each slot; the force on an atom is
the sum over the slots it is the tail of minus the sum over the slots it
is the head of, which the pack lists per atom in a fixed order (so the
kernel needs no float atomics and repeats bitwise). A periodic cell is
taken as the reference takes it: the minimum image of every slot vector
on each periodic axis.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sclmd_tpu_torch.kernels import build
from sclmd_tpu_torch.kernels.slots import (KernelForce, _cell, _mic,
                                           row_partners)

launches = 0          # kernel launches through a C/H pack (K5)
launches_tersoff = 0  # kernel launches through a Tersoff pack (K8)

# CH_MAX_THREADS and CH_MAX_GROUPS in csrc/ch_force.cu: a CTA holds tpc
# trajectory groups of tt threads, tt * tpc <= 1024, one CTA to an SM
MAX_THREADS = 1024
MAX_GROUPS = 15
SMEM_LIMIT = 227 * 1024   # dynamic shared memory a CTA may ask for (H100)
H100_SMS = 132            # streaming multiprocessors of an H100 SXM
# threads per trajectory group: one per work item (up to 1024) while the
# trajectories are no more than the SMs (one group to an SM: each phase is
# one round, and its latency is the time), 256 beyond (several groups to
# an SM share its issue slots)
TT_FEW, TT_MANY = 1024, 256
# rough float32 operations of one work item, for the roofline bound of
# ``work_counts``: a table entry's geometry (difference, norm, cutoff), a
# pair inside the cutoff (two exponentials, the bond order), an angular
# term (both passes), a bond or spring, a wag term, a slot added to an atom
OPS = dict(entry=30, pair=60, triple=110, bond=30, wag=90, gather=6)


def reset_count():
    global launches, launches_tersoff
    launches = launches_tersoff = 0


def _up(n: int, k: int) -> int:
    return -(-n // k) * k


def _pack(kind, x0, catom, nbr, cell, pair_ab, pair_r0, nbond, oop,
          scalars, conv) -> dict:
    """The common pack: ``nbr`` (nc, width) holds the atom index of each
    centre's neighbours, -1 for none."""
    na = len(x0)
    if na > 0xFFFF:
        raise ValueError(f"ch_force: {na} atoms; the kernel indexes at "
                         "most 65535")
    nc = len(catom)
    live = nbr >= 0
    ent_row = np.nonzero(live)[0]
    ent_ab = np.stack([np.asarray(catom, np.int64)[ent_row], nbr[live]],
                      axis=1).reshape(-1, 2)
    row_ptr = np.concatenate([[0], np.cumsum(live.sum(1))]).astype(np.int64)
    slot_ab = [ent_ab, pair_ab]
    if len(oop):
        slot_ab.append(np.stack(
            [np.repeat(oop[:, 1], 3), oop[:, [0, 2, 3]].reshape(-1)],
            axis=1))
    slot_ab = np.concatenate(slot_ab, axis=0).astype(np.int64)
    d0 = _mic(x0[slot_ab[:, 1]] - x0[slot_ab[:, 0]], cell)

    # per atom, the slots that touch it (slot << 1 | 1 at the head), in
    # slot order
    s = np.arange(len(slot_ab))
    atoms = np.concatenate([slot_ab[:, 0], slot_ab[:, 1]])
    ents = np.concatenate([2 * s, 2 * s + 1])
    order = np.lexsort((ents, atoms))
    csr = ents[order]
    csr_ptr = np.concatenate([[0], np.cumsum(np.bincount(atoms,
                                                         minlength=na))])
    # the order in which the threads take the entries in the bond-order
    # and gradient phases: inside the cutoff at the reference geometry
    # first, longer rows first, so that a warp's entries do alike work
    inside = np.linalg.norm(d0[:len(ent_ab)], axis=-1) < \
        scalars["R"] + scalars["D"]
    k = np.bincount(ent_row[inside], minlength=nc)
    order = np.lexsort((np.arange(len(ent_ab)), -k[ent_row], ~inside))
    return dict(kind=kind, na=na, nc=nc, ne=len(ent_ab), nbond=int(nbond),
                npair=len(pair_ab), noop=len(oop), nslots=len(slot_ab),
                catom=np.asarray(catom, np.int64), ent_ab=ent_ab,
                ent_row=ent_row, row_ptr=row_ptr, order=order,
                pair_ab=pair_ab,
                pair_r0=np.asarray(pair_r0, np.float64), oop=oop,
                slot_ab=slot_ab, d0=d0, csr_ptr=csr_ptr, csr=csr,
                cell=cell, conv=np.asarray(conv, float), scalars=scalars)


def _tersoff_scalars(tp) -> dict:
    return dict(A=tp["A"], B=tp["B"], lam1=tp["lam1"], lam2=tp["lam2"],
                lam3=tp["lam3"], beta=tp["beta"], n=tp["n"],
                c2=tp["c"] ** 2, d2=tp["d"] ** 2, h=tp["h"],
                gamma=tp["gamma"], m=tp["m"], R=tp["R"], D=tp["D"])


def pack_operands(terms: dict, xyz, conv) -> dict:
    """K5's constant operands as host numpy, from ``ch_energy(...).terms``
    and the driver's ``xyz``/``conv``.

    Keys: ``catom`` (nc) the carbon centres; the table's live entries
    ``ent_ab`` (ne, 2) tail and head atom, row by row in the table's
    order, ``ent_row`` (ne) and ``row_ptr`` (nc + 1) the rows; ``pair_ab``
    (npair, 2) with the ``nbond`` Morse bonds first, ``pair_r0`` (npair);
    ``oop`` (noop, 4); ``slot_ab`` (nslots, 2) tail and head atom of every
    slot and ``d0`` (nslots, 3) its reference vector (the float64
    difference, minimum image in a cell, rounded once on the card);
    ``csr_ptr`` (na + 1) and ``csr`` with entries ``slot << 1 | head`` in
    slot order; ``cell`` (3,), zero on an open axis; the scalar
    parameters under ``scalars``."""
    x0 = np.asarray(xyz, np.float64).reshape(-1, 3)
    c_ids = np.asarray(terms["c_ids"], np.int64)
    nbr_c = np.asarray(terms["nbr_c"], np.int64).reshape(len(c_ids), -1)
    mask_c = np.asarray(terms["mask_c"], bool).reshape(nbr_c.shape)
    nbr = np.where(mask_c, c_ids[nbr_c] if nbr_c.size else nbr_c, -1)
    bonds = np.asarray(terms["bonds"], np.int64).reshape(-1, 2)
    aux = np.asarray(terms["aux"], np.int64).reshape(-1, 2)
    oop = np.asarray(terms["oop"], np.int64).reshape(-1, 4)
    mo = terms["morse"]
    scalars = dict(
        _tersoff_scalars(terms["tersoff"]),
        mD=mo["D"], malpha=mo["alpha"], mr0=mo["r0"],
        # the bond list's Morse term is cut at cutoff + 1 and not shifted
        mcut=mo["cutoff"] + 1.0, meshift=0.0,
        kbend=terms["k_bend"], koop=terms["k_oop"],
        n2min=terms["oop_n2_min"])
    return _pack("ch", x0, c_ids, nbr, _cell(terms),
                 np.concatenate([bonds, aux], axis=0),
                 np.concatenate([np.zeros(len(bonds)),
                                 np.asarray(terms["aux_r0"], np.float64)]),
                 len(bonds), oop, scalars, conv)


def pack_tersoff(terms: dict, xyz, conv) -> dict:
    """K8's operands: the same kernel on a single-element Tersoff system
    (``tersoff_energy(...).terms``), every atom a centre, no bonds,
    springs or wag terms. A multi-element table (mixed pair parameters)
    raises: it keeps the autograd route."""
    if "elements" in terms:
        raise NotImplementedError(
            "ch_force: a multi-element Tersoff table (mixed pair "
            "parameters) is not packed; it runs through autograd "
            "(ROADMAP queue 2, K8b)")
    x0 = np.asarray(xyz, np.float64).reshape(-1, 3)
    nbr = np.asarray(terms["nbr"], np.int64).reshape(len(x0), -1)
    mask = np.asarray(terms["mask"], bool).reshape(nbr.shape)
    scalars = dict(_tersoff_scalars(terms["params"]), mD=0.0, malpha=0.0,
                   mr0=0.0, mcut=0.0, meshift=0.0, kbend=0.0, koop=0.0,
                   n2min=0.0)
    return _pack("tersoff", x0, np.arange(len(x0)), np.where(mask, nbr, -1),
                 _cell(terms), np.zeros((0, 2), np.int64), np.zeros(0), 0,
                 np.zeros((0, 4), np.int64), scalars, conv)


# the constant block's arrays, in order (csrc/ch_force.cu stages it whole)
BLOCK = ("ent_ab", "ent_row", "row_ptr", "order", "d0", "pair_ab",
         "pair_r0", "oop", "csr_ptr", "csr", "conv", "f0")


def const_block(pack: dict, f0=None):
    """(words, offsets): the kernel's constant block as int32 words,
    padded to a multiple of 4, and the word offset of each array of
    ``BLOCK``. Atom pairs are packed as ``a | b << 16``, floats by their
    float32 bits; ``f0`` (the kernel's own force at rest) is zero until
    the wrapper has taken it."""
    def two(ab):
        ab = np.asarray(ab, np.uint32).reshape(-1, 2)
        return (ab[:, 0] | (ab[:, 1] << 16)).view(np.int32)

    def f32(x):
        return np.asarray(x, np.float32).reshape(-1).view(np.int32)

    parts = dict(ent_ab=two(pack["ent_ab"]),
                 ent_row=pack["ent_row"].astype(np.int32),
                 row_ptr=pack["row_ptr"].astype(np.int32),
                 order=pack["order"].astype(np.int32),
                 d0=f32(pack["d0"]), pair_ab=two(pack["pair_ab"]),
                 pair_r0=f32(pack["pair_r0"]),
                 oop=two(np.asarray(pack["oop"]).reshape(-1, 2)),
                 csr_ptr=pack["csr_ptr"].astype(np.int32),
                 csr=pack["csr"].astype(np.int32), conv=f32(pack["conv"]),
                 f0=f32(np.zeros(3 * pack["na"]) if f0 is None else f0))
    offsets, n = {}, 0
    for k in BLOCK:
        offsets[k] = n
        n += len(parts[k])
    words = np.zeros(_up(max(n, 4), 4), np.int32)
    for k in BLOCK:
        words[offsets[k]:offsets[k] + len(parts[k])] = parts[k]
    return words, offsets


# where a launch keeps its constant block and its groups' working regions:
# (constants in shared memory, working regions in shared memory)
PLACES = {"shared": (True, True), "work": (False, True),
          "global": (False, False)}


def launch_plan(pack: dict, ntraj: int = 1, sms: int = H100_SMS,
                threads=None, tpc=None, place=None) -> dict:
    """Threads per trajectory group (``threads``: a multiple of 32, no
    more than the work items and atoms need), groups per CTA (``tpc``:
    as many as the card has trajectories per SM, as shared memory and
    1024 threads allow), CTAs (one to an SM at most, persistent over the
    trajectories) and the memory: the constant block, then per group u
    (later a_ij and the radial coefficients), the entries' geometry
    (float4), the slots' gradients and one partial energy per warp.

    ``place`` (a key of ``PLACES``) says what shared memory holds: by
    default everything where the block and one group fit, else the
    working regions (the kernel reads the constants from global memory),
    else nothing (the working regions live in a buffer of ``work_words``
    floats). A forced ``place`` that does not fit raises."""
    na, ne, ns = pack["na"], pack["ne"], pack["nslots"]
    items = max(ne + pack["npair"] + pack["noop"], na)
    if threads is None:
        threads = TT_FEW if ntraj <= sms else TT_MANY
    tt = max(32, min(_up(int(threads), 32), _up(items, 32)))
    cwords = len(const_block(pack)[0])
    g_off = _up(max(3 * na, 2 * ne), 4)
    s_off = g_off + 4 * ne
    red_off = s_off + _up(3 * ns, 4)
    traj_words = red_off + _up(tt // 32, 4)
    cap = SMEM_LIMIT // 4
    if place is None:
        place = ("shared" if cwords + traj_words <= cap else
                 "work" if traj_words <= cap else "global")
    csm, wsm = PLACES[place]
    fit = (cap - cwords * csm) // traj_words if wsm else MAX_GROUPS
    if fit < 1:
        raise ValueError(
            f"ch_force: {na} atoms, {ne} table entries and {ns} slots need "
            f"{4 * (cwords * csm + traj_words * wsm)} bytes of shared "
            f"memory ({place}), above the card's {SMEM_LIMIT}")
    most = min(fit, MAX_THREADS // tt, MAX_GROUPS)
    if tpc is None:
        tpc = min(most, -(-ntraj // sms))
    if not 1 <= tpc <= most:
        raise ValueError(f"ch_force: {tpc} groups per CTA; at most {most} "
                         f"fit with {tt} threads each")
    grid = min(sms, -(-ntraj // tpc))
    return dict(items=items, threads=tt, tpc=tpc, grid=grid, cwords=cwords,
                g_off=g_off, s_off=s_off, red_off=red_off,
                traj_words=traj_words, place=place, csm=int(csm),
                wsm=int(wsm),
                work_words=0 if wsm else grid * tpc * traj_words,
                smem_bytes=4 * (cwords * csm + tpc * traj_words * wsm))


def work_counts(pack: dict) -> dict:
    """What one trajectory's evaluation needs at the reference geometry:
    the table entries, the pairs inside the Tersoff cutoff R + D, the
    angular terms among them, and a float32 operation count from ``OPS``
    (the kernel skips everything outside the cutoff, so the bound counts
    what this geometry needs, not every pair of a row)."""
    s, ne = pack["scalars"], pack["ne"]
    r = np.linalg.norm(pack["d0"][:ne], axis=-1)
    inside = r < s["R"] + s["D"]
    k = np.bincount(pack["ent_row"][inside], minlength=pack["nc"])
    pairs, triples = int(k.sum()), int((k * (k - 1)).sum())
    ops = (OPS["entry"] * ne + OPS["pair"] * pairs
           + OPS["triple"] * triples + OPS["bond"] * pack["npair"]
           + OPS["wag"] * pack["noop"] + OPS["gather"] * len(pack["csr"]))
    return dict(entries=ne, pairs=pairs, triples=triples, ops=ops,
                bytes=4 * 2 * 3 * pack["na"])


class _ChArgs(ctypes.Structure):
    _fields_ = (
        [(k, ctypes.c_void_p) for k in ("q", "f", "e", "conv", "cblock",
                                        "trace", "work")]
        + [(k, ctypes.c_int) for k in (
            "o_ent_ab", "o_ent_row", "o_row_ptr", "o_order", "o_d0",
            "o_pair_ab", "o_pair_r0", "o_oop", "o_csr_ptr", "o_csr",
            "o_conv", "o_f0", "g_off", "s_off",
            "red_off", "traj_words", "cwords", "ntraj", "na", "nc", "ne",
            "nbond", "npair", "noop", "nslots", "tt", "tpc", "grid",
            "smem_bytes", "csm", "wsm")]
        + [(k, ctypes.c_float) for k in (
            "cx", "cy", "cz", "A", "B", "lam1", "lam2", "lam3", "beta", "n",
            "c2", "d2", "h", "gamma", "m", "R", "D", "mD", "malpha", "mr0",
            "mcut", "meshift", "kbend", "koop", "n2min")])


class CHForceCuda:
    """K5 or K8 on one device: the packed constants live on the card; each
    call passes q and gets the force (and the energy on request) in
    buffers of its own. ``f0`` is the kernel's own force at q = 0, so that
    the force at the reference geometry is exactly zero."""

    def __init__(self, pack: dict, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError("ch_force: the kernel takes CUDA tensors")
        self.pack, self.device = pack, device
        self.tersoff = pack["kind"] == "tersoff"
        self.sms = torch.cuda.get_device_properties(
            device).multi_processor_count
        self._shape = {}
        self._plans, self._argc = {}, {}
        self.plan(1)          # raises here if the system is too large
        self.lib = build.load()
        if self.lib.ch_force_max_threads() != MAX_THREADS or \
                self.lib.ch_force_max_groups() != MAX_GROUPS:
            raise RuntimeError("ch_force: limits differ from the kernel's")
        self.nph = 3 * pack["na"]
        words, offsets = const_block(pack)
        self._t = dict(
            cblock=torch.as_tensor(words, device=device),
            conv=torch.as_tensor(pack["conv"], dtype=torch.float32,
                                 device=device))
        a = _ChArgs()
        a.cblock, a.conv = self._t["cblock"].data_ptr(), \
            self._t["conv"].data_ptr()
        for k, v in offsets.items():
            setattr(a, "o_" + k, v)
        for k in ("na", "nc", "ne", "nbond", "npair", "noop", "nslots"):
            setattr(a, k, pack[k])
        a.cx, a.cy, a.cz = (float(c) for c in pack["cell"])
        for k, v in pack["scalars"].items():
            setattr(a, k, float(v))
        self.args = a
        # the block's f0 is zero for this first call
        self.f0 = self(torch.zeros((1, self.nph), dtype=torch.float32,
                                   device=device))[0].clone()
        o = offsets["f0"]
        self._t["cblock"][o:o + self.nph].copy_(self.f0.view(torch.int32))

    def plan(self, ntraj: int) -> dict:
        if ntraj not in self._plans:
            self._plans[ntraj] = launch_plan(self.pack, ntraj, self.sms,
                                             **self._shape)
        return self._plans[ntraj]

    def _reshape(self, **shape):
        """Launch later calls with ``launch_plan``'s ``threads``, ``tpc``
        or ``place`` forced. For sweeps and tests only: every launch shape
        gives the same bits."""
        self._shape = shape
        self._plans, self._argc = {}, {}
        return self

    def _args(self, ntraj: int) -> _ChArgs:
        """The launch's argument struct for ``ntraj`` trajectories, made
        once per batch size (a call then sets only its buffers)."""
        a = self._argc.get(ntraj)
        if a is None:
            p = self.plan(ntraj)
            a = _ChArgs.from_buffer_copy(self.args)
            a.ntraj, a.tt = ntraj, p["threads"]
            for k in ("tpc", "grid", "smem_bytes", "cwords", "g_off",
                      "s_off", "red_off", "traj_words", "csm", "wsm"):
                setattr(a, k, p[k])
            if p["work_words"]:
                # the working regions in global memory, kept with the args
                a._work = torch.empty(p["work_words"], dtype=torch.float32,
                                      device=self.device)
                a.work = a._work.data_ptr()
            self._argc[ntraj] = a
        return a

    def phase_cycles(self, q: torch.Tensor) -> dict:
        """One launch with the kernel's phase stamps on: the SM cycles of
        each phase of every group's first trajectory (constants staged
        beside the first load of u, then phases A, B, C and the gather
        D), medians over the groups."""
        n = q.reshape(-1, self.nph).shape[0]
        p, a = self.plan(n), self._args(n)
        rows = p["grid"] * p["tpc"]
        buf = torch.zeros((rows, self.lib.ch_force_trace_len()),
                          dtype=torch.int64, device=self.device)
        a.trace = buf.data_ptr()
        try:
            self(q)
        finally:
            a.trace = None
        used = buf[:min(rows, n)]
        med = used.diff(dim=1).double().median(dim=0).values.cpu()
        return dict(zip(("stage", "A", "B", "C", "D"), med.tolist()))

    def __call__(self, q: torch.Tensor, energy: bool = False):
        global launches, launches_tersoff
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
        a = self._args(q2.shape[0])
        a.q, a.f = q2.data_ptr(), f.data_ptr()
        a.e = e.data_ptr() if energy else None
        rc = self.lib.ch_force_f32(ctypes.byref(a),
                                   build.current_stream(self.device))
        build.check(rc, "ch_force")
        if self.tersoff:
            launches_tersoff += 1
        else:
            launches += 1
        f = f.reshape(q.shape)
        return (e.reshape(q.shape[:-1]), f) if energy else f


class CHForce(KernelForce):
    """``q -> conv * F(xyz + conv q) - f0`` of a C/H or Tersoff driver
    (``kernels.slots.KernelForce``): ``pack`` is ``pack_operands`` (C/H,
    the default) or ``pack_tersoff``."""

    cuda_cls = CHForceCuda

    def __init__(self, terms: dict, driver, pack=None):
        self.pack_fn = pack or pack_operands
        super().__init__(terms, driver)

    def pack(self) -> dict:
        return self.pack_fn(self.terms, self.driver.xyz, self.driver.conv)


def _cutoff_np(r, R, D):
    w = 0.5 * np.pi / D
    mid = (r >= R - D) & (r <= R + D)
    fc = np.where(r < R - D, 1.0,
                  np.where(mid, 0.5 - 0.5 * np.sin(w * (r - R)), 0.0))
    dfc = np.where(mid, -0.5 * w * np.cos(w * (r - R)), 0.0)
    return fc, dfc


def analytic_force_numpy(pack: dict, q, f0=None):
    """The kernel's formulas in float64 numpy, phase by phase as
    csrc/ch_force.cu computes them (geometry of the entries, bonds,
    springs and wag terms; bond order per entry; gradient per entry over
    its row; the slots added onto the atoms): (energy (traj,), force
    (traj, nph)) for q (traj, nph). The CPU tests hold it against the
    autograd twin and the JAX package, which checks the analytic gradient
    and the packs where no card is at hand; nothing else calls it."""
    s = pack["scalars"]
    na, ne = pack["na"], pack["ne"]
    q = np.asarray(q, np.float64).reshape(-1, 3 * na)
    nt = len(q)
    cd = s["c2"] / s["d2"]
    u = (pack["conv"] * q).reshape(nt, na, 3)
    ab = pack["slot_ab"]
    d = _mic(pack["d0"] + u[:, ab[:, 1]] - u[:, ab[:, 0]], pack["cell"])

    # (A) geometry of the entries
    r = np.linalg.norm(d[:, :ne], axis=-1)                    # (nt, ne)
    h = d[:, :ne] / r[..., None]
    fc, dfc = _cutoff_np(r, s["R"], s["D"])
    P = row_partners(pack["row_ptr"])
    pm = P >= 0
    Pc = np.where(pm, P, 0)
    ht, rt = h[:, Pc], r[:, Pc]                               # (nt, ne, L)
    fct = np.where(pm, fc[:, Pc], 0.0)
    cs = np.einsum("tea,tela->tel", h, ht)
    hc = s["h"] - cs
    den = s["d2"] + hc * hc
    gg = s["gamma"] * (1.0 + cd * hc * hc / den)
    dg = -2.0 * s["gamma"] * s["c2"] * hc / den ** 2

    def expo(y):
        if s["lam3"] == 0.0:
            return np.ones_like(y), np.zeros_like(y)
        z = s["lam3"] * y
        ex = np.exp(z ** s["m"])
        return ex, ex * s["m"] * z ** (s["m"] - 1.0) * s["lam3"]

    ex_j, dex_j = expo(r[..., None] - rt)      # this entry as j, t as k
    ex_k, dex_k = expo(rt - r[..., None])      # this entry as k, t as j

    # (B) bond order of each entry
    live = fc != 0.0
    zeta = np.where(pm & (fct != 0.0), fct * gg * ex_j, 0.0).sum(-1)
    bz = s["beta"] * zeta
    pos = bz > 0
    bzn = np.where(pos, bz, 1.0) ** s["n"]
    b = np.where(pos, (1.0 + bzn) ** (-0.5 / s["n"]), 1.0)
    dbdz = np.where(pos, -0.5 * b * bzn / ((1.0 + bzn)
                                           * np.where(pos, zeta, 1.0)), 0.0)
    fR = s["A"] * np.exp(-s["lam1"] * r)
    fA = -s["B"] * np.exp(-s["lam2"] * r)
    energy = np.where(live, 0.5 * fc * (fR + b * fA), 0.0).sum(-1)
    rad = np.where(live, 0.5 * (dfc * (fR + b * fA) + fc * (
        -s["lam1"] * fR - s["lam2"] * b * fA)), 0.0)
    az = np.where(live, 0.5 * fc * fA * dbdz, 0.0)

    # (C) gradient of each entry's slot over its row
    at = np.where(pm, az[:, Pc], 0.0)
    a_s = az[..., None]
    jrole = pm & (a_s != 0.0) & (fct != 0.0)
    krole = pm & (at != 0.0) & ((fc != 0.0) | (dfc != 0.0))[..., None]
    invs = (1.0 / r)[..., None]
    radj = a_s * fct * gg * dex_j
    angj = a_s * fct * ex_j * dg * invs
    radk = at * (dfc[..., None] * gg * ex_k - fc[..., None] * gg * dex_k)
    angk = at * fc[..., None] * ex_k * dg * invs
    coef_h = rad + np.where(jrole, radj, 0.0).sum(-1) + \
        np.where(krole, radk, 0.0).sum(-1)
    coef_p = np.where(jrole, angj, 0.0) + np.where(krole, angk, 0.0)
    p_dir = ht - cs[..., None] * h[:, :, None, :]
    grad = np.zeros_like(d)
    grad[:, :ne] = coef_h[..., None] * h + np.einsum("tel,tela->tea", coef_p,
                                                     p_dir)

    # bonds and springs
    npair, nbond = pack["npair"], pack["nbond"]
    dv = d[:, ne:ne + npair]
    rp_ = np.linalg.norm(dv, axis=-1)
    bond = np.arange(npair) < nbond
    ex = np.exp(-s["malpha"] * (rp_ - s["mr0"]))
    on = bond & (rp_ < s["mcut"])
    dr = rp_ - pack["pair_r0"]
    e_p = np.where(bond, np.where(on, s["mD"] * (ex * ex - 2 * ex)
                                  - s["meshift"], 0.0),
                   0.5 * s["kbend"] * dr * dr)
    dedr = np.where(bond, np.where(on, 2 * s["malpha"] * s["mD"] * ex
                                   * (1 - ex), 0.0), s["kbend"] * dr)
    energy = energy + e_p.sum(-1)
    grad[:, ne:ne + npair] = (dedr / rp_)[..., None] * dv

    # wag terms
    w = d[:, ne + npair:].reshape(nt, -1, 3, 3)
    uu, e1, e2 = w[:, :, 0], w[:, :, 1], w[:, :, 2]
    nv = np.cross(e1, e2)
    n2 = (nv * nv).sum(-1)
    ok = n2 > s["n2min"]
    nn = np.sqrt(np.where(ok, n2, 1.0))[..., None]
    nh = nv / nn
    sc = (uu * nh).sum(-1)
    energy = energy + np.where(ok, 0.5 * s["koop"] * sc * sc, 0.0).sum(-1)
    wv = s["koop"] * sc[..., None] * (uu - sc[..., None] * nh) / nn
    gw = np.stack([s["koop"] * sc[..., None] * nh, np.cross(e2, wv),
                   np.cross(wv, e1)], axis=2)
    grad[:, ne + npair:] = np.where(ok[..., None, None], gw, 0.0).reshape(
        nt, -1, 3)

    # the tail of a slot is pushed along its gradient, the head against it
    f = np.zeros((nt, na, 3))
    np.add.at(f, (slice(None), ab[:, 0]), grad)
    np.add.at(f, (slice(None), ab[:, 1]), -grad)
    f = pack["conv"] * f.reshape(nt, -1)
    return energy, f if f0 is None else f - np.asarray(f0)
