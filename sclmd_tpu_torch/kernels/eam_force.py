"""K10: the embedded-atom-method force of a metal (``models.eam.EAMDriver``),
analytic Sutton-Chen or tabulated setfl splines, batched over
trajectories.

    f(q) = conv * F(xyz + conv q) - f0,    F = -dE/dx of the EAM energy

``EAMForce`` launches the hand-written kernel (csrc/eam_force.cu: two
modes, the analytic gradient over the slot table of ``kernels.slots``; a
trajectory on each lane, a centre on each warp) on CUDA tensors and runs
the plain twin, ``torch.autograd`` of the ported energy function, on CPU
tensors. The spline coefficients are the twin's own, made once on the
host in float64 and rounded once to float32.

Two routes, chosen once from the table (``pack_operands``). On a
symmetric table (``symmetric_table``: j in row i exactly when i is in row
j, with the opposite reference vector) a density pass writes each
centre's F'(rho_i) and a force pass takes each atom's force from its own
row and its neighbours' F'(rho_j): no slot array, no gather. Any other
table (a truncated one) takes the general route: a centre pass writes
every slot's gradient from the centre's own row, and a gather subtracts
each slot from its head. ``slot_gradients_numpy`` with
``analytic_force_numpy`` (general) and ``symmetric_force_numpy`` are the
kernel's arithmetic in float64 numpy, for the CPU tests.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sclmd_tpu_torch.kernels import slots
from sclmd_tpu_torch.utils import profiling

launches = 0       # evaluations through the kernel (three launches each)
launches_sym = 0   # of them, on the symmetric route

# float32 operations of an entry inside the cutoff, counted once: its
# density term (the switch and the powers, or a spline lookup), and what
# its pair term and gradient add to it; and of a centre's embedding term
OPS_RHO, OPS_GRAD, OPS_EMBED = 25, 25, 20


def reset_count():
    global launches, launches_sym
    launches = launches_sym = 0


profiling.register("launches.K10", __name__, "launches")
profiling.register("launches.K10_sym", __name__, "launches_sym")


def _int_power(e) -> int:
    """The power e as the kernel's integer: its value where it is a whole
    number 0-32 (multiplies), else -1 (powf of the float)."""
    return int(e) if float(e) == int(e) and 0 <= int(e) <= 32 else -1


def symmetric_table(pack: dict) -> bool:
    """Whether the slot table is symmetric: every slot (i, j, d0) has a
    slot (j, i, -d0), counted alike, with d0 equal as float64 numbers (a
    zero's sign aside; the float64 difference and the minimum image are
    both exact under negation, so a full table passes) and, tabulated,
    the same pair row. A table truncated below its occupancy does not."""
    def keys(i, j, d0):
        k = np.empty((len(i), 6), np.int64)
        k[:, 0], k[:, 1] = i, j
        k[:, 2:5] = (np.asarray(d0, np.float64) + 0.0).view(np.int64)
        k[:, 5] = pack["slot_pair"] if pack["mode"] == 1 else 0
        return k[np.lexsort(k.T[::-1])]

    return np.array_equal(keys(pack["slot_i"], pack["slot_j"], pack["d0"]),
                          keys(pack["slot_j"], pack["slot_i"], -pack["d0"]))


def pack_operands(terms: dict, xyz, conv) -> dict:
    """K10's operands from ``sutton_chen_energy(...).terms`` or
    ``eam_tabulated_energy(...).terms``: the slot table, the mode, and
    the parameters (analytic) or the spline coefficients, the atoms'
    types and each slot's neighbour type and pair row (tabulated); the
    route, ``sym`` (``symmetric_table``)."""
    pack = slots.pack_table(xyz, terms["nbr"], terms["mask"],
                            terms.get("cell"), conv)
    if terms["kind"] == "analytic":
        p = terms["params"]
        pack.update(mode=0, rc=terms["rcut"], r_on=terms["r_on"],
                    eps=p["eps"], a=p["a"], c=p["c"],
                    n=_int_power(p["n"]), m=_int_power(p["m"]),
                    nf=float(p["n"]), mf=float(p["m"]))
    else:
        live = np.asarray(terms["mask"], bool)
        types = np.asarray(terms["types"], np.int64)
        pack.update(mode=1, rc=terms["rcut"], dr=terms["dr"],
                    drho=terms["drho"], types=types,
                    slot_t=types[pack["slot_j"]],
                    slot_pair=np.asarray(terms["pair_index"])[live],
                    F_c=terms["F_c"], rho_c=terms["rho_c"],
                    rphi_c=terms["rphi_c"])
    pack["sym"] = symmetric_table(pack)
    return pack


def work_counts(pack: dict) -> dict:
    """What one trajectory's evaluation needs at the reference geometry,
    each piece once (the kernel's second walk over a row recomputes the
    geometry, the switch and the powers; the count does not): every
    slot's geometry, the density, pair and gradient terms of the entries
    inside the cutoff, the embedding terms, the gather, and their float32
    operations; the bytes of q and f per trajectory, and of the table
    (with the spline coefficients) once."""
    inside = int((np.linalg.norm(pack["d0"], axis=-1) < pack["rc"]).sum())
    ops = (slots.OPS_ENTRY * pack["ns"] + (OPS_RHO + OPS_GRAD) * inside
           + OPS_EMBED * pack["na"] + slots.OPS_GATHER * 2 * pack["ns"])
    tbytes = slots.table_bytes(pack)
    if pack["mode"] == 1:
        tbytes += 4 * sum(pack[k].size for k in ("F_c", "rho_c", "rphi_c"))
        tbytes += 4 * (pack["na"] + 2 * pack["ns"])
    return dict(slots=pack["ns"], inside=inside, ops=ops,
                bytes=4 * 2 * 3 * pack["na"], table_bytes=tbytes)


def _spline_np(coefs, h, x, sel):
    nseg = coefs.shape[1]
    idx = np.clip(np.trunc(x / h), 0, nseg - 1).astype(np.int64)
    t = x - idx * h
    cc = coefs[sel, idx]
    v = ((cc[..., 3] * t + cc[..., 2]) * t + cc[..., 1]) * t + cc[..., 0]
    d = (3.0 * cc[..., 3] * t + 2.0 * cc[..., 2]) * t + cc[..., 1]
    return v, d


def _switch_np(r, r_on, rc):
    w = rc - r_on
    u = np.clip((r - r_on) / w, 0.0, 1.0)
    sw = 1.0 - 6 * u ** 5 + 15 * u ** 4 - 10 * u ** 3
    mid = (u > 0.0) & (u < 1.0)
    dsw = np.where(mid, (-30 * u ** 4 + 60 * u ** 3 - 30 * u ** 2) / w, 0.0)
    return sw, dsw


def _slot_terms(pack: dict, q) -> dict:
    """The kernel's per-slot and per-centre terms in float64 for q (traj,
    nph): the slots' vectors ``d``, their norms ``rs`` (1 outside the
    cutoff) and ``inside``; each centre's F'(rho_i) ``fp``; per slot the
    pair term's derivative ``dphi`` (the whole pair's, phi = w rphi / r
    or w eps (a/r)^n) and the density derivatives rho'_{t_j} ``drho_j``
    and rho'_{t_i} ``drho_i``; the ``energy`` (traj,)."""
    d = slots.slot_vectors(pack, q)                          # (nt, ns, 3)
    nt = len(d)
    r = np.linalg.norm(d, axis=-1)
    inside = r < pack["rc"]
    rs = np.where(inside, r, 1.0)
    si = pack["slot_i"]

    def per_centre(x):
        out = np.zeros((nt, pack["na"]))
        np.add.at(out, (slice(None), si), np.where(inside, x, 0.0))
        return out

    if pack["mode"] == 0:
        sw, dsw = _switch_np(rs, pack["r_on"], pack["rc"])
        ar = pack["a"] / rs
        arn, arm = ar ** pack["nf"], ar ** pack["mf"]
        rho = per_centre(sw * arm)
        pos = rho > 0.0
        sq = np.sqrt(np.where(pos, rho, 1.0))
        emb = np.where(pos, -pack["eps"] * pack["c"] * sq, 0.0)
        fp = np.where(pos, -0.5 * pack["eps"] * pack["c"] / sq, 0.0)
        phi = pack["eps"] * sw * arn
        dphi = pack["eps"] * (dsw * arn - sw * pack["nf"] * arn / rs)
        drho_j = drho_i = dsw * arm - sw * pack["mf"] * arm / rs
    else:
        rh, drho_j = _spline_np(pack["rho_c"], pack["dr"], rs,
                                pack["slot_t"])
        _, drho_i = _spline_np(pack["rho_c"], pack["dr"], rs,
                               pack["types"][si])
        rho = per_centre(rh)
        emb, fp = _spline_np(pack["F_c"], pack["drho"], rho, pack["types"])
        rp, drp = _spline_np(pack["rphi_c"], pack["dr"], rs,
                             pack["slot_pair"])
        phi = rp / rs
        dphi = drp / rs - rp / rs ** 2
    energy = np.where(inside, 0.5 * phi, 0.0).sum(-1) + emb.sum(-1)
    return dict(d=d, rs=rs, inside=inside, fp=fp, dphi=dphi, drho_j=drho_j,
                drho_i=drho_i, energy=energy)


def slot_gradients_numpy(pack: dict, q):
    """The general route's formulas in float64 numpy (per centre rho_i
    and F'(rho_i) from its own row, per slot the pair and density
    derivatives): (energy (traj,), dE/dd of every slot (traj, ns, 3), the
    slots inside the cutoff (traj, ns)) for q (traj, nph)."""
    t = _slot_terms(pack, q)
    dedr = 0.5 * t["dphi"] + t["fp"][:, pack["slot_i"]] * t["drho_j"]
    grad = np.where(t["inside"], dedr / t["rs"], 0.0)[..., None] * t["d"]
    return t["energy"], grad, t["inside"]


def analytic_force_numpy(pack: dict, q, f0=None):
    """(energy (traj,), force (traj, nph)) for q (traj, nph) by the
    general route: the slots' gradients gathered onto the atoms. The CPU
    tests hold it against the autograd twin and the JAX package; nothing
    else calls it."""
    e, grad, _ = slot_gradients_numpy(pack, q)
    return e, slots.gather_numpy(pack, grad, f0)


def symmetric_force_numpy(pack: dict, q, f0=None):
    """(energy (traj,), force (traj, nph)) for q (traj, nph) by the
    symmetric route, in float64: each atom's force from its own row, each
    slot's coefficient [phi' + F'_i rho'_{t_j} + F'_j rho'_{t_i}] / r
    along its vector; the gradient of the energy only where
    ``symmetric_table(pack)``. For the CPU tests."""
    t = _slot_terms(pack, q)
    fp, si, sj = t["fp"], pack["slot_i"], pack["slot_j"]
    dedr = t["dphi"] + fp[:, si] * t["drho_j"] + fp[:, sj] * t["drho_i"]
    grad = np.where(t["inside"], dedr / t["rs"], 0.0)[..., None] * t["d"]
    f = np.zeros((grad.shape[0], pack["na"], 3))
    np.add.at(f, (slice(None), si), grad)
    f = pack["conv"] * f.reshape(len(f), -1)
    return t["energy"], f if f0 is None else f - np.asarray(f0)


class _EamArgs(ctypes.Structure):
    _fields_ = ([("s", slots._SlotArgs)]
                + [(k, ctypes.c_void_p) for k in (
                    "fc", "rhoc", "rphic", "type", "slot_tp")]
                + [(k, ctypes.c_int) for k in ("mode", "n", "m")]
                + [(k, ctypes.c_float) for k in ("nf", "mf")]
                + [(k, ctypes.c_int) for k in ("nseg_rho", "nseg_r")]
                + [(k, ctypes.c_float) for k in (
                    "eps", "a", "c", "rc", "r_on", "drho", "dr", "iw",
                    "idrho", "idr")]
                + [(k, ctypes.c_void_p) for k in ("fp", "done")]
                + [("sym", ctypes.c_int)])


class EAMForceCuda(slots.SlotForceCuda):
    """K10 on one device (``kernels.slots.SlotForceCuda``)."""

    name = "eam_force"
    entry = "eam_force_f32"
    args_type = _EamArgs
    scalar = True   # a slot's gradient is c d: g holds c

    @property
    def slot_scratch(self) -> bool:
        return not self.pack["sym"]

    def more_scratch(self, tp: int, buf) -> dict:
        """The symmetric route's F'(rho_i) (na, tp) and its counter of
        finished force-pass blocks, one a trajectory group, zero between
        calls."""
        if not self.pack["sym"]:
            return {}
        return dict(fp=buf(self.pack["na"] * tp),
                    done=torch.zeros(tp // slots.LANES, dtype=torch.int32,
                                     device=self.device))

    def _fill(self, a):
        p = self.pack
        a.sym = int(p["sym"])
        a.mode, a.rc = p["mode"], p["rc"]
        if p["mode"] == 0:
            for k in ("n", "m", "nf", "mf", "eps", "a", "c", "r_on"):
                setattr(a, k, p[k])
            a.iw = 1.0 / (p["rc"] - p["r_on"])
            return
        dev = self.device

        def put(name, x, dtype):
            self._t[name] = torch.as_tensor(np.ascontiguousarray(x),
                                            dtype=dtype, device=dev)
            setattr(a, name, self._t[name].data_ptr())

        put("fc", p["F_c"], torch.float32)
        put("rhoc", p["rho_c"], torch.float32)
        put("rphic", p["rphi_c"], torch.float32)
        put("type", p["types"], torch.int32)
        put("slot_tp", np.stack([p["slot_t"], p["slot_pair"]], 1),
            torch.int32)
        a.nseg_rho, a.nseg_r = p["F_c"].shape[1], p["rho_c"].shape[1]
        a.drho, a.dr = p["drho"], p["dr"]
        a.idrho, a.idr = 1.0 / p["drho"], 1.0 / p["dr"]

    @staticmethod
    def smem_per_warp(pack: dict) -> int:
        """Its row's records at the table's widest, and their type and
        pair words when tabulated."""
        return pack["width"] * (16 + (8 if pack["mode"] == 1 else 0))

    def _count(self):
        global launches, launches_sym
        launches += 1
        launches_sym += int(self.pack["sym"])


class EAMForce(slots.KernelForce):
    """K10 or its twin for an ``EAMDriver`` (``kernels.slots.KernelForce``)."""

    cuda_cls = EAMForceCuda

    def pack(self) -> dict:
        return pack_operands(self.terms, self.driver.xyz, self.driver.conv)
