"""The common host half of K9 (``kernels.sw_force``) and K10
(``kernels.eam_force``): the slot table of a per-centre many-body force,
the launch plan and the launch of its kernel; and the wrapper of every
force kernel (K5, K8, K9, K10), which takes the kernel on CUDA tensors
and the plain twin on CPU tensors.

    f(q) = conv * F(xyz + conv q) - f0,    F = -dE/dx of the energy

A *slot* is one live entry (i, j) of the padded neighbour table (the
centre i is its tail, the neighbour j its head), listed row by row. The
kernel (csrc/slot_force.cuh) runs a trajectory on each lane of a warp and
a centre on each warp: from the centre's own row it writes dE/d(x_j -
x_i) of every slot some lane of the group takes, so the force is the
gradient of the twin's energy whether the table is symmetric or not; it
adds the centre's share (the slots it is the tail of) in registers, and a
gather subtracts from each atom the slots it is the head of, in the fixed
order of ``head``. No float atomics: two calls agree bitwise, and a
trajectory's force has the same bits in any batch.
``gather_lanes_numpy`` is that layout and order in float64 numpy.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

import numpy as np
import torch

from sclmd_tpu_torch.kernels import build

# a slot's geometry (difference, norm, minimum image) and an atom's share
# of the gather, in float32 operations, for the bounds of ``work_counts``
OPS_ENTRY, OPS_GATHER = 25, 7

# csrc/slot_force.cuh: trajectories of a warp, centres (warps) of a
# centre-pass block at most, and the shared memory a block may take
LANES, MAX_WARPS, SMEM_MAX = 32, 4, 232448
# the shared memory a staged centre-pass block aims at: four or more
# blocks an SM
SMEM_AIM = 48 * 1024

Plan = namedtuple("Plan", "wpb smem wide")


def _mic(d, cell):
    """Minimum image of difference vectors d (..., 3) on the axes where
    ``cell`` is positive (numpy's round is half to even, as jnp.round)."""
    per = cell > 0
    if per.any():
        d = d.copy()
        d[..., per] -= cell[per] * np.round(d[..., per] / cell[per])
    return d


def _cell(terms) -> np.ndarray:
    cell = terms.get("cell")
    return np.zeros(3) if cell is None else \
        np.asarray(cell, np.float64).reshape(3)


def pack_table(xyz, nbr, mask, cell, conv) -> dict:
    """The slot table as host numpy: ``row_ptr`` (na + 1) and ``slot_j``
    (ns) the rows and the neighbour of each slot, ``slot_i`` its centre,
    ``d0`` (ns, 3) its reference vector x0_j - x0_i (float64, minimum
    image in a cell), ``rec`` (ns, 4) int32 the kernel's record of a slot
    (the float32 bits of d0, then j), ``head_ptr`` (na + 1) and ``head``
    the slots each atom is the head of, in slot order, ``width`` the
    widest row, ``cell`` (3,) zero on an open axis, ``conv`` (nph)."""
    x0 = np.asarray(xyz, np.float64).reshape(-1, 3)
    na = len(x0)
    nbr = np.asarray(nbr, np.int64).reshape(na, -1)
    live = np.asarray(mask, bool).reshape(nbr.shape)
    slot_i = np.nonzero(live)[0]
    slot_j = nbr[live]
    ns = len(slot_i)
    if ns >= 2 ** 31:
        raise ValueError(f"slot table: {ns} slots; at most 2^31 - 1 fit")
    cell = _cell({"cell": cell})
    d0 = _mic(x0[slot_j] - x0[slot_i], cell)
    counts = live.sum(1)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    rec = np.empty((ns, 4), np.int32)
    rec[:, :3] = d0.astype(np.float32).view(np.int32)
    rec[:, 3] = slot_j
    head = np.argsort(slot_j, kind="stable")
    head_ptr = np.concatenate([[0], np.cumsum(np.bincount(slot_j,
                                                          minlength=na))])
    return dict(na=na, ns=ns, row_ptr=row_ptr, slot_i=slot_i,
                slot_j=slot_j, d0=d0, rec=rec, head_ptr=head_ptr, head=head,
                width=int(counts.max(initial=0)), cell=cell,
                conv=np.asarray(conv, np.float64))


def slot_vectors(pack: dict, q) -> np.ndarray:
    """(traj, ns, 3) difference vectors d0 + u_j - u_i of q (traj, nph) in
    float64, minimum image in a cell: the kernel's geometry."""
    q = np.asarray(q, np.float64).reshape(-1, 3 * pack["na"])
    u = (pack["conv"] * q).reshape(len(q), pack["na"], 3)
    return _mic(pack["d0"] + u[:, pack["slot_j"]] - u[:, pack["slot_i"]],
                pack["cell"])


def row_partners(row_ptr) -> np.ndarray:
    """(n, L): for each entry of a CSR table with rows ``row_ptr`` the
    other entries of its row, in row order, -1 past the row's end (the
    numpy formulas' angular terms)."""
    n = int(row_ptr[-1])
    width = max(1, int(np.diff(row_ptr).max(initial=1)) - 1)
    out = np.full((n, width), -1, np.int64)
    for i in range(len(row_ptr) - 1):
        row = np.arange(row_ptr[i], row_ptr[i + 1])
        for e in row:
            others = row[row != e]
            out[e, :len(others)] = others
    return out


def gather_numpy(pack: dict, grad, f0=None) -> np.ndarray:
    """The gather in float64: forces (traj, nph) from the slots' gradients
    (traj, ns, 3), the tail pushed along each gradient, the head
    against it."""
    f = np.zeros((grad.shape[0], pack["na"], 3))
    np.add.at(f, (slice(None), pack["slot_i"]), grad)
    np.add.at(f, (slice(None), pack["slot_j"]), -grad)
    f = pack["conv"] * f.reshape(len(f), -1)
    return f if f0 is None else f - np.asarray(f0)


def lanes(ntraj: int) -> int:
    """The kernel's trajectory stride tp: ntraj rounded up to a whole
    number of warps."""
    return -(-ntraj // LANES) * LANES


def gather_lanes_numpy(pack: dict, grad, inside, f0=None,
                       d=None) -> np.ndarray:
    """The kernel's route from the slots' gradients (traj, ns, 3) to the
    forces (traj, nph), in float64, in its own layout and order: lane t
    of group t // 32; ``live`` (ntg, ns) marks the slots some lane of
    the group takes (``inside`` (traj, ns); a group's pad lanes take
    none); the centre pass stores each live slot as whole rows of g (ns,
    3, tp) at (3 k + c) tp + t, +0 for a lane that does not take it, and
    adds the slots a lane takes into its centre's share (ftail, (3 na,
    tp)) in row order; the gather starts from an atom's share and
    subtracts the live slots of its ``head`` list in order. Given the
    slots' vectors ``d`` (traj, ns, 3), where each gradient is a scalar
    c times its vector (K10), g holds c at k tp + t and the gather takes
    c d, skipping c = 0. Nothing else of g is used (the rest is NaN
    here)."""
    grad = np.asarray(grad, np.float64)
    inside = np.asarray(inside, bool)
    nt, ns, na = grad.shape[0], pack["ns"], pack["na"]
    tp = lanes(nt)
    lane = np.arange(nt)
    grp = lane // LANES
    slot = np.arange(ns)
    live = np.zeros(tp // LANES * ns, bool)
    np.logical_or.at(live, (grp[:, None] * ns + slot).ravel(),
                     inside.ravel())
    stored = live[grp[:, None] * ns + slot]                  # (nt, ns)
    if d is None:
        g = np.full(ns * 3 * tp, np.nan)
        for c in range(3):
            at = (3 * slot + c) * tp + lane[:, None]
            g[at[stored]] = np.where(inside, grad[..., c], 0.0)[stored]
    else:
        g = np.full(ns * tp, np.nan)
        coef = (grad * d).sum(-1) / np.maximum((d * d).sum(-1), 1e-300)
        at = slot * tp + lane[:, None]
        g[at[stored]] = np.where(inside, coef, 0.0)[stored]
    ftail = np.zeros(3 * na * tp)
    for c in range(3):
        for k in range(ns):                                  # row order
            take = lane[inside[:, k]]
            ftail[(3 * pack["slot_i"][k] + c) * tp + take] += \
                grad[inside[:, k], k, c]
    f = np.empty((nt, 3 * na))
    for a in range(na):
        acc = [ftail[(3 * a + c) * tp + lane] for c in range(3)]
        for k in pack["head"][pack["head_ptr"][a]:pack["head_ptr"][a + 1]]:
            take = lane[live[grp * ns + k]]
            if d is None:
                for c in range(3):
                    acc[c][take] -= g[(3 * k + c) * tp + take]
                continue
            cf = g[k * tp + take]
            take, cf = take[cf != 0.0], cf[cf != 0.0]
            for c in range(3):
                acc[c][take] -= cf * d[take, k, c]
        for c in range(3):
            f[:, 3 * a + c] = pack["conv"][3 * a + c] * acc[c]
    return f if f0 is None else f - np.asarray(f0)


def table_bytes(pack: dict) -> int:
    """Bytes of the table the kernel reads: per slot its record and its
    head entry (the slot and its tail); per atom its row and list
    pointers, conv and f0."""
    return 4 * (6 * pack["ns"] + 8 * pack["na"])


def launch_plan(per_warp: int) -> Plan:
    """The centre pass's launch where a warp takes ``per_warp`` bytes of
    shared memory (its row's records at the table's widest, and what the
    kernel keeps per lane): the most centres (warps) a block, 4, 2 or 1,
    whose shared memory stays within SMEM_AIM; one where it does not;
    and where even one warp's share is over what a block may take, the
    wide route (``wide``: rows read from global memory, a lane's kept
    entries in a global scratch), which gives the same bits."""
    for wpb in (4, 2, 1):
        if wpb * per_warp <= SMEM_AIM:
            return Plan(wpb, wpb * per_warp, False)
    if per_warp <= SMEM_MAX:
        return Plan(1, per_warp, False)
    return Plan(MAX_WARPS, 0, True)


class _SlotArgs(ctypes.Structure):
    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "q", "f", "e", "u", "g", "ftail", "ecen", "live", "scr",
            "row_ptr", "rec", "head_ptr", "head", "conv", "f0")]
        + [(k, ctypes.c_int) for k in (
            "ntraj", "na", "ns", "tp", "wpb", "width", "wide", "scalar")]
        + [(k, ctypes.c_float) for k in ("cx", "cy", "cz")])


class SlotForceCuda:
    """A slot-table kernel on one device: the table lives on the card;
    each call passes q and gets the force (and the energy on request) in
    tensors of its own. ``f0`` is the kernel's own force at q = 0, so
    that the force at the reference geometry is exactly zero. The
    scratch (u, g, the centres' shares and energies, the live marks) is
    kept per trajectory stride (``lanes``) and reused: calls on one
    stream run in order; calls on two streams must be ordered by the
    caller. ``plan`` (``launch_plan``) may be replaced to force another
    launch shape; every shape gives the same bits.

    A subclass names its C entry (``entry``), its argument struct
    (``args_type``, whose first field ``s`` is the slot table), the
    floats it keeps per lane and slot on the wide route (``keep``),
    whether a slot's gradient is a scalar times its vector (``scalar``:
    g holds the scalar), fills its own fields in ``_fill`` and gives a
    warp's shared memory for a pack in ``smem_per_warp``; ``_count``
    adds one to its launch counter. A route that needs no slot array and
    no gather sets ``slot_scratch`` False (g, ftail and live are then
    left out); ``more_scratch`` gives scratch of its own, set on the
    argument struct's fields of the same names."""

    name = "slot_force"
    entry = None
    args_type = None
    keep = 0
    scalar = False
    slot_scratch = True

    def __init__(self, pack: dict, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"{self.name}: the kernel takes CUDA tensors")
        self.pack, self.device = pack, device
        na = pack["na"]
        if na > 0x3FFFFFFF // 3:
            raise ValueError(f"{self.name}: {na} atoms is too many")
        self.nph = 3 * na
        self.lib = build.load()

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=device)

        head = np.stack([pack["head"], pack["slot_i"][pack["head"]]], 1)
        self._t = dict(row_ptr=i32(pack["row_ptr"]), rec=i32(pack["rec"]),
                       head_ptr=i32(pack["head_ptr"]), head=i32(head),
                       conv=torch.as_tensor(
                           np.asarray(pack["conv"], np.float32),
                           device=device))
        a = self.args_type()
        for k, v in self._t.items():
            setattr(a.s, k, v.data_ptr())
        a.s.na, a.s.ns, a.s.width = na, pack["ns"], pack["width"]
        a.s.scalar = int(self.scalar)
        a.s.cx, a.s.cy, a.s.cz = (float(c) for c in pack["cell"])
        self._fill(a)
        self.args = a
        self.plan = launch_plan(self.smem_per_warp(pack))
        self._scratch = {}
        # the first call has no f0 to subtract: its force is f0
        self.f0 = self(torch.zeros((1, self.nph), dtype=torch.float32,
                                   device=device))[0].clone()
        self.args.s.f0 = self.f0.data_ptr()

    def _fill(self, a):
        raise NotImplementedError

    @staticmethod
    def smem_per_warp(pack: dict) -> int:
        raise NotImplementedError

    def _count(self):
        raise NotImplementedError

    def more_scratch(self, tp: int, buf) -> dict:
        return {}

    def scratch(self, tp: int, wide: bool) -> dict:
        """The scratch of a batch of stride ``tp`` (made at its first
        call, kept)."""
        key = (tp, bool(wide))
        if key not in self._scratch:
            ns, na = self.pack["ns"], self.pack["na"]
            per = int(self.slot_scratch)

            def buf(n, dtype=torch.float32):
                return torch.empty(max(n, 1), dtype=dtype,
                                   device=self.device)

            self._scratch[key] = dict(
                u=buf(self.nph * tp),
                g=buf(per * (1 if self.scalar else 3) * ns * tp),
                ftail=buf(per * self.nph * tp), ecen=buf(na * tp),
                live=buf(per * tp // LANES * ns, torch.uint8),
                scr=buf(self.keep * ns * tp) if wide and self.keep else None,
                **self.more_scratch(tp, buf))
        return self._scratch[key]

    def __call__(self, q: torch.Tensor, energy: bool = False):
        if q.device != self.device or q.dtype != torch.float32:
            raise TypeError(f"{self.name}: q must be a float32 tensor on "
                            f"{self.device} (got {q.dtype} on {q.device})")
        if q.shape[-1] != self.nph or q.ndim not in (1, 2):
            raise ValueError(f"{self.name}: q must be (traj, {self.nph}) or "
                             f"({self.nph},), got {tuple(q.shape)}")
        q2 = q.reshape(-1, self.nph).contiguous()
        n = q2.shape[0]
        tp = lanes(n)
        plan = self.plan
        sc = self.scratch(tp, plan.wide)
        f = torch.empty_like(q2)
        e = torch.empty(n, dtype=torch.float32, device=self.device) \
            if energy else None
        a = self.args
        a.s.q, a.s.f = q2.data_ptr(), f.data_ptr()
        a.s.e = e.data_ptr() if energy else None
        for k, v in sc.items():
            setattr(a.s if hasattr(a.s, k) else a, k,
                    None if v is None else v.data_ptr())
        a.s.ntraj, a.s.tp = n, tp
        a.s.wpb, a.s.wide = plan.wpb, int(plan.wide)
        rc = getattr(self.lib, self.entry)(ctypes.byref(a),
                                           build.current_stream(self.device))
        build.check(rc, self.name)
        self._count()
        f = f.reshape(q.shape)
        return (e.reshape(q.shape[:-1]), f) if energy else f


class KernelForce:
    """``q -> conv * F(xyz + conv q) - f0`` of a driver: the kernel for a
    CUDA tensor, the autograd twin for a CPU tensor.

    ``terms``: the energy function's ``terms``; ``driver``: the
    ``TorchDriver`` holding the energy function (the twin). A subclass
    gives ``pack()`` (the kernel's operands) and its CUDA class
    ``cuda_cls`` (built from the pack and the device). For a driver on
    the card in float32 the kernel is built and its f0 taken at
    construction; another dtype raises at the first CUDA call."""

    cuda_cls = None

    def __init__(self, terms: dict, driver):
        self.terms, self.driver = terms, driver
        self.cuda = None
        if driver.device.type == "cuda" and driver.dtype == torch.float32:
            self.cuda = self._build()

    def pack(self) -> dict:
        raise NotImplementedError

    def _build(self):
        return self.cuda_cls(self.pack(), self.driver.device)

    def plain(self, q: torch.Tensor, energy: bool = False):
        """The twin: autograd of the energy function, batched."""
        f = self.driver.force_torch(q)
        return (self.driver.energy_torch(q).detach(), f) if energy else f

    def __call__(self, q: torch.Tensor, energy: bool = False):
        if q.device.type == "cpu":
            return self.plain(q, energy)
        if self.cuda is None:
            # builds, and the kernel's wrapper then raises on the dtype
            self.cuda = self._build()
        return self.cuda(q, energy)
