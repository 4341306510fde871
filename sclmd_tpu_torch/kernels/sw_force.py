"""K9: the Stillinger-Weber force of a single-element system
(``models.sw.SWDriver``), batched over trajectories.

    f(q) = conv * F(xyz + conv q) - f0,    F = -dE/dx of ``sw_energy``

``SWForce`` launches the hand-written kernel (csrc/sw_force.cu: the
analytic gradient over the slot table of ``kernels.slots``; a trajectory
on each lane, a centre on each warp, each slot's geometry once) on CUDA
tensors and runs the plain twin, ``torch.autograd`` of the ported energy
function, on CPU tensors. ``slot_gradients_numpy`` and
``analytic_force_numpy`` are the kernel's arithmetic in float64 numpy,
for the CPU tests.
"""

from __future__ import annotations

import ctypes

import numpy as np

from sclmd_tpu_torch.kernels import slots

launches = 0   # evaluations through the kernel (three launches each)

# float32 operations of a pair term inside the cutoff (two exponentials,
# the powers, the radial derivative) and of an ordered angular term
OPS_PAIR, OPS_TRIPLE = 45, 30


def reset_count():
    global launches
    launches = 0


def _int_power(e) -> int:
    """The power e as the kernel's integer: its value where it is a whole
    number 0-16 (multiplies), else -1 (powf of the float)."""
    return int(e) if float(e) == int(e) and 0 <= int(e) <= 16 else -1


def pack_operands(terms: dict, xyz, conv) -> dict:
    """K9's operands: the slot table of ``sw_energy(...).terms`` and the
    parameters; the powers p and q as floats (pf, qf) and as the kernel's
    integers (p, q: -1 where the kernel takes powf)."""
    p = terms["params"]
    pack = slots.pack_table(xyz, terms["nbr"], terms["mask"],
                            terms.get("cell"), conv)
    pack["params"] = dict(
        A=p["A"], B=p["B"], eps=p["eps"], sig=p["sigma"],
        rc=p["a"] * p["sigma"], lam=p["lam"], gam=p["gam"],
        cos0=p["costheta0"], p=_int_power(p["p"]), q=_int_power(p["q"]),
        pf=float(p["p"]), qf=float(p["q"]))
    return pack


def work_counts(pack: dict) -> dict:
    """What one trajectory's evaluation needs at the reference geometry:
    every slot's geometry, the pairs inside the cutoff, the ordered
    angular terms among them, the gather, and their float32 operations;
    the bytes of q and f per trajectory, and of the table once."""
    rc = pack["params"]["rc"]
    inside = np.linalg.norm(pack["d0"], axis=-1) < rc
    k = np.bincount(pack["slot_i"][inside], minlength=pack["na"])
    pairs, triples = int(k.sum()), int((k * (k - 1)).sum())
    ops = (slots.OPS_ENTRY * pack["ns"] + OPS_PAIR * pairs
           + OPS_TRIPLE * triples + slots.OPS_GATHER * 2 * pack["ns"])
    return dict(slots=pack["ns"], pairs=pairs, triples=triples, ops=ops,
                bytes=4 * 2 * 3 * pack["na"],
                table_bytes=slots.table_bytes(pack))


def slot_gradients_numpy(pack: dict, q):
    """The kernel's formulas in float64 numpy (per slot: the two-body
    term and the angular terms against the row's other entries): (energy
    (traj,), dE/dd of every slot (traj, ns, 3), the slots inside the
    cutoff (traj, ns)) for q (traj, nph)."""
    p = pack["params"]
    d = slots.slot_vectors(pack, q)                          # (nt, ns, 3)
    r = np.linalg.norm(d, axis=-1)
    inside = r < p["rc"]
    den = np.where(inside, r - p["rc"], -1.0)
    rs = np.where(inside, r, 1.0)
    rhat = d / rs[..., None]
    sr = p["sig"] / rs
    sp, sq = sr ** p["pf"], sr ** p["qf"]
    t1 = np.where(inside, np.exp(p["sig"] / den), 0.0)
    poly = p["B"] * sp - sq
    c2, c3 = p["A"] * p["eps"], p["lam"] * p["eps"]
    gs = p["gam"] * p["sig"]
    e_slot = 0.5 * c2 * poly * t1
    dr = 0.5 * c2 * t1 * (-(p["B"] * p["pf"] * sp - p["qf"] * sq) / rs
                          - poly * p["sig"] / den ** 2)
    h = np.where(inside, np.exp(gs / den), 0.0)
    hp = -h * gs / den ** 2

    part = slots.row_partners(pack["row_ptr"])              # (ns, L)
    pm = part >= 0
    pc = np.where(pm, part, 0)
    hk = np.where(pm, h[:, pc], 0.0)                         # (nt, ns, L)
    kh = rhat[:, pc]                                         # (nt, ns, L, 3)
    c = np.einsum("tsa,tsla->tsl", rhat, kh)
    dc = c - p["cos0"]
    hj = h[..., None]
    e_slot = e_slot + (0.5 * c3 * dc * dc * hj * hk).sum(-1)
    wk = 2.0 * c3 * dc * hj * hk / rs[..., None]
    dr = dr + (-wk * c + c3 * dc * dc * hk * hp[..., None]).sum(-1)
    grad = dr[..., None] * rhat + np.einsum("tsl,tsla->tsa", wk, kh)
    grad = np.where(inside[..., None], grad, 0.0)
    e_slot = np.where(inside, e_slot, 0.0)
    return e_slot.sum(-1), grad, inside


def analytic_force_numpy(pack: dict, q, f0=None):
    """(energy (traj,), force (traj, nph)) for q (traj, nph): the slots'
    gradients gathered onto the atoms. The CPU tests hold it against the
    autograd twin and the JAX package; nothing else calls it."""
    e, grad, _ = slot_gradients_numpy(pack, q)
    return e, slots.gather_numpy(pack, grad, f0)


class _SwArgs(ctypes.Structure):
    _fields_ = ([("s", slots._SlotArgs)]
                + [(k, ctypes.c_float) for k in (
                    "A", "B", "eps", "sig", "rc", "lam", "gam", "cos0")]
                + [(k, ctypes.c_int) for k in ("p", "q")]
                + [(k, ctypes.c_float) for k in ("pf", "qf")])


class SWForceCuda(slots.SlotForceCuda):
    """K9 on one device (``kernels.slots.SlotForceCuda``)."""

    name = "sw_force"
    entry = "sw_force_f32"
    args_type = _SwArgs
    # per lane and kept entry: the unit vector, h and r; on the wide route
    # the mask words and the entries' slots too
    keep = 7

    def _fill(self, a):
        for k, v in self.pack["params"].items():
            setattr(a, k, v)

    @classmethod
    def smem_per_warp(cls, pack: dict) -> int:
        """Its row's records, 32 lanes' kept entries and the entries'
        slots at the table's widest, and the lanes' mask words."""
        w = pack["width"]
        return w * (16 + 4 * (cls.keep - 2) * slots.LANES + 4) \
            + -(-w // 32) * 4 * slots.LANES

    def _count(self):
        global launches
        launches += 1


class SWForce(slots.KernelForce):
    """K9 or its twin for an ``SWDriver`` (``kernels.slots.KernelForce``)."""

    cuda_cls = SWForceCuda

    def pack(self) -> dict:
        return pack_operands(self.terms, self.driver.xyz, self.driver.conv)
