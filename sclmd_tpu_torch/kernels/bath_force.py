"""K7: one bath-force evaluation of the plain GLE step, for every bath of
every trajectory, with the rest of the evaluation fused in (the body of
``md.run_segment``'s step, JAX ``md.py:349-380``).

Per bath, on its DOFs (``cids``), with this evaluation's noise row n:

* non-local phonon bath: ``n - dt (K0 v + K1 h + tail)``, h = old[0]
  (predictor) or the pre-step p (corrector), ``tail`` the K6 column;
* local phonon bath (ml == 1): ``n - K0 v``;
* electron bath: ``n - efric v``, plus ``bias ((exim - zeta1) q -
  zeta2 v)`` when ``bias_terms``.

The bath forces are scattered onto the potential force. The predictor
stage then writes the Verlet half-step (``pthalf``, ``qtt``), the heat
currents ``cur_b = f_b . p``, ``etot = p.p / 2`` and pushes p onto the
history ring; a corrector stage writes ``pthalf + dt/2 f``, and the last
one applies the constraint mask to it and to ``qtt``.

``BathForce`` launches the hand-written kernel (csrc/bath_force.cu) on
CUDA tensors and runs the plain twins (``pred_plain``, ``corr_plain``,
which apply the baths' own ``force_pred``/``force_corr``) on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from sclmd_tpu_torch.baths import EBath, PhBath
from sclmd_tpu_torch.kernels import build

launches = 0          # bath_force kernel launches (not twin calls)
# of those, launches of a tile of one or two trajectories whose system is
# too wide to stage its vectors (launch_plan's staged 0)
launches_wide = 0

MAX_BATHS = 4         # BF_MAX_BATHS in csrc/bath_force.cu
PRED, CORR, LAST = 0, 1, 2


def reset_count():
    global launches, launches_wide
    launches = launches_wide = 0


SRC_H, SRC_Q = 1, 2    # what a packed operand's later matrices act on


class ForceOperands(NamedTuple):
    """One bath's operands, built once per segment. The force is
    ``n - s (M [x; h; q] + tail)`` with the bath's matrices packed along
    the reduction axis, ``M = [Mv | Mh | -Mq / s]`` (whichever exist),
    stored transposed and padded: ``MT[k, a] = M[a, k]``, (K, ld) with
    ``ld`` = nc rounded up to 4 and zero columns past nc. ``srcs`` names
    what the matrices after the first act on (``SRC_H``, ``SRC_Q``)."""
    bath: object                     # EBath or PhBath (the twin's rules)
    MT: torch.Tensor                 # (K, ld), a view of the packed buffer
    srcs: tuple
    s: float
    cids: torch.Tensor               # (nc,) int32 on the device

    @property
    def has_h(self) -> bool:
        return SRC_H in self.srcs


def bath_matrices(b):
    """(Mv, Mh, Mq, s) of a bath's force rule ``n - s (Mv v + Mh h +
    tail) + Mq q``; None where a matrix is absent."""
    if isinstance(b, EBath):
        if b.bias_terms:
            return (b.efric + b.bias * b.zeta2, None,
                    b.bias * (b.exim - b.zeta1), 1.0)
        return b.efric, None, None, 1.0
    if not isinstance(b, PhBath):
        raise TypeError(f"bath_force: unknown bath type {type(b).__name__}")
    if b.ml == 1:
        return b.kernel[0], None, None, 1.0
    return b.kernel[0], b.kernel[1], None, float(b.dt)


def pack_operands(baths) -> list:
    """Every bath's packed operand, all in one contiguous buffer (each
    bath's rows start on a 16-byte boundary)."""
    parts = []
    for b in baths:
        Mv, Mh, Mq, s = bath_matrices(b)
        mats, srcs = [Mv], []
        if Mh is not None:
            mats.append(Mh)
            srcs.append(SRC_H)
        if Mq is not None:
            mats.append(-Mq / s)
            srcs.append(SRC_Q)
        parts.append((b, torch.cat(mats, dim=1).t(), tuple(srcs), s))
    if not parts:
        return []
    dev, dtype = parts[0][1].device, parts[0][1].dtype
    lds = [-(-b.nc // 4) * 4 for b, _, _, _ in parts]
    buf = torch.zeros(sum(MT.shape[0] * ld for (_, MT, _, _), ld in
                          zip(parts, lds)), dtype=dtype, device=dev)
    ops, off = [], 0
    for (b, MT, srcs, s), ld in zip(parts, lds):
        K = MT.shape[0]
        view = buf[off:off + K * ld].view(K, ld)
        view[:, :b.nc] = MT
        off += K * ld
        ops.append(ForceOperands(
            b, view, srcs, s,
            torch.as_tensor(b.cids, dtype=torch.int32, device=dev)))
    return ops


def pred_plain(p, q, pf, ring, head: int, push: Optional[int], ops, tails,
               row: int, dt: float, cur, etot, fbs=None):
    """Predictor twin: writes ``cur`` (traj, nb), ``etot`` (traj,), the
    ring row ``push`` (when given) and, when ``fbs`` is given, each
    bath's force into ``fbs[i]`` (traj, nc); returns (pthalf, qtt)."""
    f = pf.clone()
    for i, op in enumerate(ops):
        b = op.bath
        cols = b.cols
        old_c = ring[:, head, cols].unsqueeze(1) \
            if op.has_h else None
        fb = b.force_pred(b.noise[:, row], p[:, cols], q[:, cols], old_c,
                          tails[i])
        f[:, cols] += fb
        cur[:, i] = (fb * p[:, cols]).sum(-1)
        if fbs is not None:
            fbs[i].copy_(fb)
    etot.copy_(0.5 * (p * p).sum(-1))
    if push is not None:
        ring[:, push] = p
    return p + f * (dt / 2.0), q + p * dt + f * (dt * dt / 2.0)


def corr_plain(x, qtt, pf2, p, pthalf, ops, tails, row: int, dt: float,
               mask=None, f_out=None):
    """Corrector twin: ``pthalf + dt/2 f`` with the bath forces at
    velocity ``x``; with ``mask`` the last stage, returning
    (masked p, masked qtt), else (p, None). ``f_out`` receives f."""
    f = pf2.clone()
    for i, op in enumerate(ops):
        b = op.bath
        cols = b.cols
        f[:, cols] += b.force_corr(b.noise[:, row], x[:, cols],
                                   qtt[:, cols], p[:, cols], tails[i])
    if f_out is not None:
        f_out.copy_(f)
    pout = pthalf + (dt / 2.0) * f
    if mask is None:
        return pout, None
    return pout * mask, qtt * mask


class _BfBath(ctypes.Structure):
    _fields_ = [("noise", ctypes.c_void_p), ("MT", ctypes.c_void_p),
                ("tail", ctypes.c_void_p), ("cids", ctypes.c_void_p),
                ("fb", ctypes.c_void_p),
                ("nc", ctypes.c_int), ("ld", ctypes.c_int),
                ("K", ctypes.c_int),
                ("src1", ctypes.c_int), ("src2", ctypes.c_int),
                ("t0", ctypes.c_int), ("nt", ctypes.c_int),
                ("ncol", ctypes.c_int), ("nsl", ctypes.c_int),
                ("v_off", ctypes.c_int), ("p_off", ctypes.c_int),
                ("z_off", ctypes.c_int), ("tl_off", ctypes.c_int),
                ("c_off", ctypes.c_int),
                ("s", ctypes.c_float)]


class _BfArgs(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("pf", ctypes.c_void_p), ("h", ctypes.c_void_p),
                ("base", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("out_p", ctypes.c_void_p), ("out_q", ctypes.c_void_p),
                ("f_out", ctypes.c_void_p), ("cur", ctypes.c_void_p),
                ("etot", ctypes.c_void_p), ("push", ctypes.c_void_p),
                ("h_stride", ctypes.c_longlong),
                ("push_stride", ctypes.c_longlong),
                ("cur_stride", ctypes.c_longlong),
                ("etot_stride", ctypes.c_longlong),
                ("ntraj", ctypes.c_int), ("nph", ctypes.c_int),
                ("nb", ctypes.c_int), ("nmd", ctypes.c_int),
                ("row", ctypes.c_int), ("stage", ctypes.c_int),
                ("tt", ctypes.c_int),
                ("tail_col", ctypes.c_int),
                ("f_off", ctypes.c_int), ("xs_off", ctypes.c_int),
                ("hs_off", ctypes.c_int), ("qs_off", ctypes.c_int),
                ("bs_off", ctypes.c_int), ("ms_off", ctypes.c_int),
                ("ci_off", ctypes.c_int), ("smem_bytes", ctypes.c_int),
                ("disjoint", ctypes.c_int), ("staged", ctypes.c_int),
                ("need_h", ctypes.c_int), ("need_q", ctypes.c_int),
                ("dt", ctypes.c_float), ("hdt", ctypes.c_float),
                ("dt2h", ctypes.c_float),
                ("baths", _BfBath * MAX_BATHS)]


SMEM_LIMIT = 227 * 1024   # dynamic shared memory a CTA may ask for (H100)
THREADS = 512             # BF_THREADS in csrc/bath_force.cu
TILES = (1, 2, 4, 8)      # trajectories per CTA the kernel is built for


def tile_size(ntraj: int, nsm: int) -> int:
    """Trajectories per CTA on a card of ``nsm`` SMs: the largest tile
    of 8/4/2 that still gives about a CTA per SM (each CTA reads every
    bath matrix once for its tile, so larger tiles cut L2 traffic; fewer
    CTAs than SMs leave SMs idle), else one."""
    for tt in (8, 4, 2):
        if ntraj >= tt * (9 * nsm // 10):
            return tt
    return 1


def _up4(n: int) -> int:
    return -(-n // 4) * 4


CTA_KEYS = ("f_off", "xs_off", "hs_off", "qs_off", "bs_off", "ms_off",
            "ci_off", "smem_bytes")
BATH_KEYS = ("t0", "nt", "ncol", "nsl", "v_off", "p_off", "z_off", "tl_off",
             "c_off")


def launch_plan(shapes, nph: int, tt: int, nt: int = THREADS,
                staged=None) -> dict:
    """How a CTA of ``nt`` threads and ``tt`` trajectories is dealt out
    over baths of ``shapes`` = [(nc, K), ...] (K the packed reduction
    length), and where its shared memory holds what (offsets in floats,
    each a multiple of 4).

    Per bath: its threads ``[t0, t0 + nt)`` (shares in whole warps, by
    matrix size), ``ncol`` threads along the float4 columns and ``nsl``
    K slices; its gathered vectors ``v_off`` (tt, K), partial sums
    ``p_off`` (nsl, tt, ld), noise then force ``z_off`` (tt, nc), tail
    ``tl_off`` (tt, nc) and indices ``c_off`` (counted from ``ci_off``).
    CTA-wide the force ``f_off`` and, with one or two trajectories per
    CTA where they fit (``staged``), the staged x, h, q, base (tt, nph)
    and mask; a system too wide for them (the 10,368 DOFs of the
    silicon slab) reads x, h, q and base from global memory, as a tile
    of four or eight does (``staged`` forces either). ``smem_bytes`` is
    the whole."""
    if staged is None:
        plan = launch_plan(shapes, nph, tt, nt, staged=tt <= 2)
        if plan["staged"] and plan["smem_bytes"] > SMEM_LIMIT:
            plan = launch_plan(shapes, nph, tt, nt, staged=False)
        return plan
    nb = len(shapes)
    warps = nt // 32
    if nb > warps:
        raise ValueError("bath_force: more baths than warps")
    weights = [K * _up4(nc) for nc, K in shapes]
    share = [1] * nb
    for _ in range(warps - nb if nb else 0):
        i = max(range(nb), key=lambda j: weights[j] / share[j])
        share[i] += 1
    vec = _up4(tt * nph)
    plan = {"f_off": 0}
    off = vec
    for k in ("xs_off", "hs_off", "qs_off", "bs_off"):
        plan[k] = off if staged else 0
        off += vec if staged else 0
    plan["ms_off"] = off if staged else 0
    off += _up4(nph) if staged else 0
    baths, t0, c_off = [], 0, 0
    for (nc, K), w in zip(shapes, share):
        ld = _up4(nc)
        ntb = 32 * w
        ncol = min(ld // 4, ntb)
        nsl = max(1, min(ntb // ncol, K))
        b = {"t0": t0, "nt": ntb, "ncol": ncol, "nsl": nsl, "ld": ld,
             "v_off": off, "p_off": off + _up4(tt * K)}
        b["z_off"] = b["p_off"] + nsl * tt * ld
        off = b["z_off"] + _up4(tt * nc)
        b["tl_off"] = off
        off += _up4(tt * nc)
        b["c_off"] = c_off
        c_off += nc
        t0 += ntb
        baths.append(b)
    plan.update(baths=baths, ci_off=off, smem_bytes=4 * (off + _up4(c_off)),
                staged=int(staged))
    return plan


def _check_vec(t, ntraj, nph, name):
    if t.shape != (ntraj, nph) or t.dtype != torch.float32 or \
            not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"bath_force: {name} must be a contiguous float32 "
                         f"CUDA ({ntraj}, {nph}) tensor")


class BathForce:
    """K7 for one segment of ``ntraj`` trajectories: ``pred`` and
    ``corr`` run the kernel on CUDA tensors (operands and launch
    arguments set up once per stage) and the twins on CPU tensors.

    On the card the returned tensors are this object's own buffers, two
    sets per stage used in turn: what a stage returns stays intact
    until the second next call of that same stage (so through the other
    two stages of its step and the whole next step), and is overwritten
    after that. ``md.run_segment`` keeps nothing longer: p, pthalf and
    qtt live within a step, and the q it remembers as ``qprev`` is the
    last stage's output of the step before.

    ``tile`` overrides ``tile_size``'s trajectories per CTA."""

    def __init__(self, baths, ntraj: int, nph: int, nmd: int, dt: float,
                 device, tile=None):
        if len(baths) > MAX_BATHS:
            raise ValueError(f"bath_force: at most {MAX_BATHS} baths, got "
                             f"{len(baths)}")
        self.ops = pack_operands(baths)
        self.ntraj, self.nph, self.nmd, self.dt = ntraj, nph, nmd, dt
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if not self.cuda:
            return
        nsm = torch.cuda.get_device_properties(device).multi_processor_count
        tt = tile_size(ntraj, nsm) if tile is None else tile
        if tt not in TILES:
            raise ValueError(f"bath_force: no kernel for a tile of {tt}")
        shapes = [(op.bath.nc, op.MT.shape[0]) for op in self.ops]
        plan = launch_plan(shapes, nph, tt)
        if plan["smem_bytes"] > SMEM_LIMIT and tile is None:
            # too wide for this tile: one trajectory per CTA
            tt = 1
            plan = launch_plan(shapes, nph, tt)
        if plan["smem_bytes"] > SMEM_LIMIT:
            raise ValueError(
                f"bath_force: {plan['smem_bytes']} bytes of shared memory "
                f"needed, {SMEM_LIMIT} available")
        self.tile = tt
        allc = np.concatenate([np.asarray(op.bath.cids) for op in self.ops]
                              or [np.zeros(0, int)])
        self.stages = []
        for stage in (PRED, CORR, LAST):
            a = _BfArgs()
            a.ntraj, a.nph, a.nb, a.nmd = ntraj, nph, len(baths), nmd
            a.tt, a.stage = tt, stage
            a.tail_col = 0 if stage == PRED else 1
            a.dt, a.hdt, a.dt2h = dt, dt / 2.0, dt * dt / 2.0
            for k in CTA_KEYS + ("staged",):
                setattr(a, k, plan[k])
            a.disjoint = int(len(np.unique(allc)) == len(allc))
            a.need_h = int(any(op.has_h for op in self.ops))
            a.need_q = int(stage != CORR or
                           any(SRC_Q in op.srcs for op in self.ops))
            for i, (op, pb) in enumerate(zip(self.ops, plan["baths"])):
                b, nc = op.bath, op.bath.nc
                if np.min(b.cids) < 0 or np.max(b.cids) >= nph or \
                        len(np.unique(b.cids)) != nc:
                    raise ValueError("bath_force: bath DOF indices must be "
                                     "distinct and in range")
                for t in (op.MT, b.noise):
                    if t.device.type != "cuda" or t.dtype != torch.float32:
                        raise TypeError("bath_force: the kernel takes "
                                        "float32 CUDA operands")
                if b.noise.shape != (ntraj, nmd, nc) or \
                        not b.noise.is_contiguous():
                    raise ValueError(f"bath_force: bath {i} needs a "
                                     f"contiguous ({ntraj}, {nmd}, {nc}) "
                                     "noise batch")
                if op.MT.data_ptr() % 16:
                    raise ValueError("bath_force: packed operand is not "
                                     "16-byte aligned")
                srcs = op.srcs + (0, 0)
                a.baths[i] = _BfBath(
                    b.noise.data_ptr(), op.MT.data_ptr(), 0,
                    op.cids.data_ptr(), 0, nc, pb["ld"], op.MT.shape[0],
                    srcs[0], srcs[1], *(pb[k] for k in BATH_KEYS), op.s)
            self.stages.append(a)

        def pair():
            return torch.empty((2, ntraj, nph), dtype=torch.float32,
                               device=device)
        # outputs, two sets per stage used in turn: [stage][turn] ->
        # (out_p, out_q); the corrector has no out_q
        bufs = [pair(), pair(), pair(), pair(), pair()]
        self.outs = [[(bufs[0][k], bufs[1][k]) for k in (0, 1)],
                     [(bufs[2][k], None) for k in (0, 1)],
                     [(bufs[3][k], bufs[4][k]) for k in (0, 1)]]
        self.own = {out.data_ptr() for buf in bufs for out in buf}
        self.turn = [0, 0, 0]
        # per stage: the baths' argument structs (views into the stage's
        # own), and the tail and force tensors their pointers were last
        # set from, so that a step that passes the same ones sets nothing
        self.bath_args = [[a.baths[i] for i in range(a.nb)]
                          for a in self.stages]
        self.bound = [[[None, None] for _ in self.ops] for _ in self.stages]
        self.ring = None
        self.lib = build.load()
        if self.lib.bath_force_threads() != THREADS:
            raise RuntimeError("bath_force: THREADS differs from the "
                               "kernel's")

    def _vec(self, t, name):
        """Device address of a state vector; this object's own outputs
        need no check."""
        ptr = t.data_ptr()
        if ptr not in self.own:
            _check_vec(t, self.ntraj, self.nph, name)
        return ptr

    def _launch(self, stage, x, q, pf, h, h_stride, base, tails, row,
                mask=None, push=0, push_stride=0, cur=None, etot=None,
                f_out=None, fbs=None):
        global launches, launches_wide
        a = self.stages[stage]
        a.x, a.q, a.pf = self._vec(x, "x"), self._vec(q, "q"), \
            self._vec(pf, "pf")
        a.base = 0 if base is None else self._vec(base, "base")
        a.h, a.h_stride = h, h_stride
        a.mask = 0 if mask is None else mask.data_ptr()
        turn = self.turn[stage]
        self.turn[stage] = turn ^ 1
        out_p, out_q = self.outs[stage][turn]
        a.out_p = out_p.data_ptr()
        a.out_q = 0 if out_q is None else out_q.data_ptr()
        a.f_out = 0 if f_out is None else self._vec(f_out, "f_out")
        if stage == PRED:
            a.push, a.push_stride = push, push_stride
            a.cur, a.cur_stride = cur.data_ptr(), cur.stride(0)
            a.etot, a.etot_stride = etot.data_ptr(), etot.stride(0)
        a.row = row % self.nmd
        for i, (b, was) in enumerate(zip(self.bath_args[stage],
                                         self.bound[stage])):
            tail, fb = tails[i], None if fbs is None else fbs[i]
            if tail is not was[0]:
                b.tail = 0 if tail is None else tail.data_ptr()
                was[0] = tail
            if fb is not was[1]:
                b.fb = 0 if fb is None else fb.data_ptr()
                was[1] = fb
        rc = self.lib.bath_force_f32(ctypes.byref(a),
                                     build.current_stream(self.device))
        build.check(rc, "bath_force")
        launches += 1
        if a.tt <= 2 and not a.staged:
            launches_wide += 1
        return out_p, out_q

    def pred(self, p, q, pf, ring, head: int, push: Optional[int], tails,
             row: int, cur, etot, fbs=None):
        """Predictor: (pthalf, qtt); writes ``cur`` (traj, nb) and
        ``etot`` (traj,) (views with any row stride), pushes p onto ring
        row ``push``, and the per-bath forces into ``fbs`` if given."""
        if not self.cuda:
            return pred_plain(p, q, pf, ring, head, push, self.ops, tails,
                              row, self.dt, cur, etot, fbs)
        mlr = ring.shape[1]
        if ring is not self.ring:
            if ring.shape != (self.ntraj, mlr, self.nph) or \
                    not ring.is_contiguous() or ring.dtype != torch.float32:
                raise ValueError("bath_force: the ring must be a contiguous "
                                 "float32 (traj, mlr, nph) tensor")
            self.ring = ring
        if (cur.shape != (self.ntraj, len(self.ops)) or
                etot.shape != (self.ntraj,) or
                (len(self.ops) and cur.stride(1) != 1)):
            raise ValueError("bath_force: cur must be (traj, nb) with "
                             "unit stride along baths, etot (traj,)")
        row_bytes = 4 * self.nph        # ring rows head and push, by address
        return self._launch(
            PRED, p, q, pf, ring.data_ptr() + (head % mlr) * row_bytes,
            mlr * self.nph, None, tails, row,
            push=0 if push is None else
            ring.data_ptr() + (push % mlr) * row_bytes,
            push_stride=mlr * self.nph, cur=cur, etot=etot, fbs=fbs)

    def corr(self, x, qtt, pf2, p, pthalf, tails, row: int, mask=None,
             f_out=None):
        """Corrector: (pthalf + dt/2 f, None); with ``mask`` the last
        stage: (masked p, masked qtt). ``f_out`` receives f."""
        if not self.cuda:
            return corr_plain(x, qtt, pf2, p, pthalf, self.ops, tails, row,
                              self.dt, mask, f_out)
        return self._launch(LAST if mask is not None else CORR, x, qtt, pf2,
                            self._vec(p, "p"), self.nph, pthalf, tails, row,
                            mask=mask, f_out=f_out)
