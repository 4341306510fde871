"""The common host half of K9 (``kernels.sw_force``) and K10
(``kernels.eam_force``): the slot table of a per-centre many-body force
and the launch of its kernel; and the wrapper of every force kernel (K5,
K8, K9, K10), which takes the kernel on CUDA tensors and the plain twin
on CPU tensors.

    f(q) = conv * F(xyz + conv q) - f0,    F = -dE/dx of the energy

A *slot* is one live entry (i, j) of the padded neighbour table (the
centre i is its tail, the neighbour j its head), listed row by row. The
kernel writes dE/d(x_j - x_i) of every slot from the centre's own row
(csrc/slot_force.cuh), so the force is the gradient of the twin's energy
whether the table is symmetric or not; an atom's force is the sum over
the slots it is the tail of minus the sum over those it is the head of,
listed here per atom in a fixed order (no float atomics: two calls agree
bitwise).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sclmd_tpu_torch.kernels import build

# a slot's geometry (difference, norm, minimum image) and an atom's share
# of the gather, in float32 operations, for the bounds of ``work_counts``
OPS_ENTRY, OPS_GATHER = 25, 7


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
    image in a cell), ``csr_ptr`` (na + 1) and ``csr`` each atom's slots
    as ``slot << 1 | head`` in slot order, ``cell`` (3,) zero on an open
    axis, ``conv`` (nph)."""
    x0 = np.asarray(xyz, np.float64).reshape(-1, 3)
    na = len(x0)
    nbr = np.asarray(nbr, np.int64).reshape(na, -1)
    live = np.asarray(mask, bool).reshape(nbr.shape)
    slot_i = np.nonzero(live)[0]
    slot_j = nbr[live]
    ns = len(slot_i)
    if 2 * ns + 1 >= 2 ** 31:
        raise ValueError(f"slot table: {ns} slots; at most 2^30 fit")
    cell = _cell({"cell": cell})
    d0 = _mic(x0[slot_j] - x0[slot_i], cell)
    row_ptr = np.concatenate([[0], np.cumsum(live.sum(1))])
    s = np.arange(ns)
    atoms = np.concatenate([slot_i, slot_j])
    ents = np.concatenate([2 * s, 2 * s + 1])
    order = np.lexsort((ents, atoms))
    csr_ptr = np.concatenate([[0], np.cumsum(np.bincount(atoms,
                                                         minlength=na))])
    return dict(na=na, ns=ns, row_ptr=row_ptr, slot_i=slot_i,
                slot_j=slot_j, d0=d0, csr_ptr=csr_ptr, csr=ents[order],
                cell=cell, conv=np.asarray(conv, np.float64))


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


def table_bytes(pack: dict) -> int:
    """Bytes of the table the kernel reads: per slot its neighbour, d0 and
    two gather entries; per atom its row and list pointers, conv and
    f0."""
    return 4 * (6 * pack["ns"] + 8 * pack["na"])


class _SlotArgs(ctypes.Structure):
    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "q", "f", "e", "g", "ecen", "row_ptr", "slot_j", "d0",
            "csr_ptr", "csr", "conv", "f0")]
        + [(k, ctypes.c_int) for k in ("ntraj", "na", "ns")]
        + [(k, ctypes.c_float) for k in ("cx", "cy", "cz")])


class SlotForceCuda:
    """A slot-table kernel on one device: the table lives on the card;
    each call passes q and gets the force (and the energy on request) in
    buffers of its own. ``f0`` is the kernel's own force at q = 0, so that
    the force at the reference geometry is exactly zero.

    A subclass names its C entry (``entry``), its argument struct
    (``args_type``, whose first field ``s`` is the slot table) and fills
    its own fields in ``_fill``; ``_count`` adds one to its launch
    counter."""

    name = "slot_force"
    entry = None
    args_type = None

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

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32).reshape(-1),
                                   device=device)

        self._t = dict(row_ptr=i32(pack["row_ptr"]),
                       slot_j=i32(pack["slot_j"]), d0=f32(pack["d0"]),
                       csr_ptr=i32(pack["csr_ptr"]), csr=i32(pack["csr"]),
                       conv=f32(pack["conv"]))
        a = self.args_type()
        for k, v in self._t.items():
            setattr(a.s, k, v.data_ptr())
        a.s.na, a.s.ns = na, pack["ns"]
        a.s.cx, a.s.cy, a.s.cz = (float(c) for c in pack["cell"])
        self._fill(a)
        self.args = a
        # the first call has no f0 to subtract: its force is f0
        self.f0 = self(torch.zeros((1, self.nph), dtype=torch.float32,
                                   device=device))[0].clone()
        self.args.s.f0 = self.f0.data_ptr()

    def _fill(self, a):
        raise NotImplementedError

    def _count(self):
        raise NotImplementedError

    def __call__(self, q: torch.Tensor, energy: bool = False):
        if q.device != self.device or q.dtype != torch.float32:
            raise TypeError(f"{self.name}: q must be a float32 tensor on "
                            f"{self.device} (got {q.dtype} on {q.device})")
        if q.shape[-1] != self.nph or q.ndim not in (1, 2):
            raise ValueError(f"{self.name}: q must be (traj, {self.nph}) or "
                             f"({self.nph},), got {tuple(q.shape)}")
        q2 = q.reshape(-1, self.nph).contiguous()
        n = q2.shape[0]
        f = torch.empty_like(q2)
        e = torch.empty(n, dtype=torch.float32, device=self.device) \
            if energy else None
        g = torch.empty((n, self.pack["ns"], 3), dtype=torch.float32,
                        device=self.device)
        ecen = torch.empty((n, self.pack["na"]), dtype=torch.float32,
                           device=self.device)
        a = self.args
        a.s.q, a.s.f = q2.data_ptr(), f.data_ptr()
        a.s.e = e.data_ptr() if energy else None
        a.s.g, a.s.ecen = g.data_ptr(), ecen.data_ptr()
        a.s.ntraj = n
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
