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
currents ``cur_b = f_b . p``, ``etot = p.p / 2``, the step's p and q
into the per-step outputs ``ps`` and ``qs`` where asked, and pushes p
onto the history ring; a corrector stage writes ``pthalf + dt/2 f``, and
the last one applies the constraint mask to it and to ``qtt``. The
kernel reads the step it runs from the segment's step word on the card
(``kernels.step_graph``), so its launches replay in a CUDA graph.

``BathForce`` launches the hand-written kernel (csrc/bath_force.cu) on
CUDA tensors and runs the plain twins (``pred_plain``, ``corr_plain``,
which apply the baths' own ``force_pred``/``force_corr``) on CPU tensors.
A system too wide to stage its vectors at a tile of one or two
trajectories (``launch_plan``'s staged 0: the silicon slab) takes the
wide route instead where its baths are disjoint (``choose_route``): the
bath force as one product over all trajectories (``wide_plan``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from sclmd_tpu_torch.baths import EBath, PhBath
from sclmd_tpu_torch.kernels import build
from sclmd_tpu_torch.kernels.step_graph import StepWord
from sclmd_tpu_torch.utils import profiling

launches = 0          # bath_force kernel launches (not twin calls)
# of those, launches of a tile of one or two trajectories whose system is
# too wide to stage its vectors (launch_plan's staged 0): the wide route
launches_wide = 0

MAX_BATHS = 4         # BF_MAX_BATHS in csrc/bath_force.cu
PRED, CORR, LAST = 0, 1, 2


def reset_count():
    global launches, launches_wide
    launches = launches_wide = 0


profiling.register("launches.K7", __name__, "launches")
profiling.register("launches.K7_wide", __name__, "launches_wide")


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
                ("ps", ctypes.c_void_p), ("qs", ctypes.c_void_p),
                ("step", ctypes.c_void_p),
                ("h_stride", ctypes.c_longlong),
                ("push_stride", ctypes.c_longlong),
                ("cur_stride", ctypes.c_longlong),
                ("etot_stride", ctypes.c_longlong),
                ("ps_stride", ctypes.c_longlong),
                ("qs_stride", ctypes.c_longlong),
                ("cur_step", ctypes.c_longlong),
                ("etot_step", ctypes.c_longlong),
                ("ps_step", ctypes.c_longlong),
                ("qs_step", ctypes.c_longlong),
                ("ntraj", ctypes.c_int), ("nph", ctypes.c_int),
                ("nb", ctypes.c_int), ("nmd", ctypes.c_int),
                ("t0", ctypes.c_int), ("step_off", ctypes.c_int),
                ("mlr", ctypes.c_int), ("stage", ctypes.c_int),
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


class _BwArgs(ctypes.Structure):
    """The wide route's arguments (``BwArgs``): the tiled kernel's, whose
    launch-plan offsets it leaves unused, and its own."""
    _fields_ = [("a", _BfArgs),
                ("part", ctypes.c_void_p), ("tickets", ctypes.c_void_p),
                ("bath_dof", ctypes.c_void_p),
                ("nprod", ctypes.c_int), ("ntiles", ctypes.c_int),
                ("smem_bytes", ctypes.c_int),
                ("nrt", ctypes.c_int * MAX_BATHS),
                ("p0", ctypes.c_int * MAX_BATHS)]


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


# the wide route's shape (BW_* in csrc/bath_force.cu)
WIDE_THREADS = 320        # threads of every CTA
WIDE_CONSUMERS = 256      # of a product CTA's, those that compute
WIDE_ROWS = 16            # bath rows a product CTA owns
WIDE_TRAJ = 64            # trajectories a product CTA owns
WIDE_KC = 64              # reduction rows a stage of its ring holds
WIDE_STAGES = 4           # stages of the ring


def wide_plan(shapes, ntraj: int) -> dict:
    """The wide route's launch over baths of ``shapes`` = [(nc, K), ...]
    and ``ntraj`` trajectories: ``nprod`` product CTAs, bath by bath
    (bath i's ``nrt[i]`` row tiles of ``WIDE_ROWS`` rows times ``ntiles``
    trajectory tiles of ``WIDE_TRAJ``, from CTA ``p0[i]``, trajectory
    tile after trajectory tile), then ``ntraj`` update CTAs, one a
    trajectory; ``grid`` CTAs in all. Shared memory (floats): the ring
    of ``WIDE_STAGES`` stages (the operand's tile, then the gathered
    tile, rows padded by one), or in the epilogue the consumer warps'
    partial sums and the current terms, whichever is larger, then a
    bath's indices from ``ci_off``; ``smem_bytes`` the whole."""
    if not shapes:
        raise ValueError("bath_force: the wide route needs a bath")
    ntiles = -(-ntraj // WIDE_TRAJ)
    nrt = [-(-nc // WIDE_ROWS) for nc, _ in shapes]
    p0, nprod = [], 0
    for n in nrt:
        p0.append(nprod)
        nprod += n * ntiles
    ring = WIDE_STAGES * (WIDE_KC * WIDE_ROWS +
                          WIDE_TRAJ * (WIDE_KC + 1))
    epi = (WIDE_CONSUMERS // 32 + 1) * WIDE_TRAJ * (WIDE_ROWS + 1)
    ci_off = max(ring, epi)
    return {"nprod": nprod, "ntiles": ntiles, "nrt": nrt, "p0": p0,
            "grid": nprod + ntraj, "ci_off": ci_off,
            "smem_bytes": 4 * (ci_off + _up4(max(nc for nc, _ in shapes)))}


def wide_cta(plan: dict, ntraj: int, shapes, i: int):
    """What CTA ``i`` of a wide launch owns, decoded as the kernel
    decodes it: ("product", bath, rows, trajectories) with ranges of
    the bath's rows and of trajectories, or ("update", trajectory)."""
    if i >= plan["nprod"]:
        return ("update", i - plan["nprod"])
    b = max(j for j, p in enumerate(plan["p0"]) if i >= p)
    pl = i - plan["p0"][b]
    tile, rt = divmod(pl, plan["nrt"][b])
    a0, tr0 = rt * WIDE_ROWS, tile * WIDE_TRAJ
    return ("product", b, range(a0, min(a0 + WIDE_ROWS, shapes[b][0])),
            range(tr0, min(tr0 + WIDE_TRAJ, ntraj)))


def choose_route(shapes, nph: int, ntraj: int, nsm: int, tile=None,
                 disjoint: bool = True):
    """(tile, plan, wide) for a launch over baths of ``shapes`` on a card
    of ``nsm`` SMs: the tile ``tile_size`` gives (or ``tile``), one
    trajectory a CTA where that tile's plan does not fit, and
    ``launch_plan``'s plan for it. ``wide``: the system takes the wide
    route, where the plan cannot stage its vectors at a tile of one or
    two and its baths share no DOF; other systems keep the tiled
    kernel."""
    tt = tile_size(ntraj, nsm) if tile is None else tile
    if tt not in TILES:
        raise ValueError(f"bath_force: no kernel for a tile of {tt}")
    plan = launch_plan(shapes, nph, tt)
    if plan["smem_bytes"] > SMEM_LIMIT and tile is None:
        # too wide for this tile: one trajectory per CTA
        tt = 1
        plan = launch_plan(shapes, nph, tt)
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(
            f"bath_force: {plan['smem_bytes']} bytes of shared memory "
            f"needed, {SMEM_LIMIT} available")
    wide = bool(shapes) and disjoint and tt <= 2 and not plan["staged"]
    return tt, plan, wide


def _check_vec(t, ntraj, nph, name):
    if t.shape != (ntraj, nph) or t.dtype != torch.float32 or \
            not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"bath_force: {name} must be a contiguous float32 "
                         f"CUDA ({ntraj}, {nph}) tensor")


class BathForce:
    """K7 for one segment of ``ntraj`` trajectories starting at global
    step ``t0``: ``pred`` and ``corr`` run the kernel on CUDA tensors
    (operands and launch arguments set up once per stage) and the twins
    on CPU tensors. A call names its step ``s`` of the segment: the noise
    rows are (t0 + s) mod nmd (predictor) and one more (correctors), the
    ring's head is -s mod mlr and the push row the one before it, and the
    predictor writes row s of its outputs. On the card the kernel reads
    s from ``word`` (``kernels.step_graph.StepWord``, made here when not
    given) plus the launch's offset, so the launches can be replayed in
    a CUDA graph.

    On the card the returned tensors are this object's own buffers, two
    sets per stage used in turn: what a stage returns stays intact
    until the second next call of that same stage (so through the other
    two stages of its step and the whole next step), and is overwritten
    after that. ``md.run_segment`` keeps nothing longer: p, pthalf and
    qtt live within a step, and the q it remembers as ``qprev`` is the
    last stage's output of the step before.

    ``tile`` overrides ``tile_size``'s trajectories per CTA."""

    def __init__(self, baths, ntraj: int, nph: int, nmd: int, dt: float,
                 device, tile=None, t0: int = 0, word=None):
        if len(baths) > MAX_BATHS:
            raise ValueError(f"bath_force: at most {MAX_BATHS} baths, got "
                             f"{len(baths)}")
        self.ops = pack_operands(baths)
        self.ntraj, self.nph, self.nmd, self.dt = ntraj, nph, nmd, dt
        self.t0 = int(t0) % nmd
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if not self.cuda:
            return
        self.word = StepWord(self.device) if word is None else word
        nsm = torch.cuda.get_device_properties(device).multi_processor_count
        shapes = [(op.bath.nc, op.MT.shape[0]) for op in self.ops]
        allc = np.concatenate([np.asarray(op.bath.cids) for op in self.ops]
                              or [np.zeros(0, int)])
        disjoint = len(np.unique(allc)) == len(allc)
        tt, plan, self.wide = choose_route(shapes, nph, ntraj, nsm, tile,
                                           disjoint)
        self.wide_pred = self.wide
        self.tile = tt
        # per stage the wide route's arguments, whose first member ``a``
        # (in ``stages``) the tiled kernel takes
        self.wides, self.stages = [], []
        for stage in (PRED, CORR, LAST):
            w = _BwArgs()
            a = w.a
            a.ntraj, a.nph, a.nb, a.nmd = ntraj, nph, len(baths), nmd
            a.t0, a.step = self.t0, self.word.ptr
            a.tt, a.stage = tt, stage
            a.tail_col = 0 if stage == PRED else 1
            a.dt, a.hdt, a.dt2h = dt, dt / 2.0, dt * dt / 2.0
            for k in CTA_KEYS + ("staged",):
                setattr(a, k, plan[k])
            a.disjoint = int(disjoint)
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
            self.wides.append(w)
            self.stages.append(a)
        if self.wide:
            self._wide_scratch(shapes, allc)

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
        self.rows = None
        self.lib = build.load()
        if self.lib.bath_force_threads() != THREADS:
            raise RuntimeError("bath_force: THREADS differs from the "
                               "kernel's")
        if self.wide:
            dims = (ctypes.c_int * 6)()
            self.lib.bath_force_wide_dims(dims)
            if list(dims) != [WIDE_THREADS, WIDE_ROWS, WIDE_TRAJ, WIDE_KC,
                              WIDE_STAGES, self.wplan["ci_off"]]:
                raise RuntimeError("bath_force: the wide route's shape "
                                   "differs from the kernel's")

    def _wide_scratch(self, shapes, allc):
        """The wide route's plan and scratch, made once: the partial heat
        currents, the tickets (zero; each launch leaves them zero) and the
        flags of the bath DOFs."""
        wp = self.wplan = wide_plan(shapes, self.ntraj)
        if wp["smem_bytes"] > SMEM_LIMIT:
            raise ValueError(
                f"bath_force: {wp['smem_bytes']} bytes of shared memory "
                f"needed, {SMEM_LIMIT} available")
        dev = self.device
        part = torch.zeros((wp["nprod"], WIDE_TRAJ), dtype=torch.float32,
                           device=dev)
        tickets = torch.zeros(len(shapes) * wp["ntiles"], dtype=torch.int32,
                              device=dev)
        bath_dof = torch.zeros(self.nph, dtype=torch.uint8, device=dev)
        bath_dof[torch.as_tensor(allc, dtype=torch.long, device=dev)] = 1
        self._wide_keep = (part, tickets, bath_dof)
        for w in self.wides:
            w.part, w.tickets = part.data_ptr(), tickets.data_ptr()
            w.bath_dof = bath_dof.data_ptr()
            w.nprod, w.ntiles = wp["nprod"], wp["ntiles"]
            w.smem_bytes = wp["smem_bytes"]
            for i, (n, p0) in enumerate(zip(wp["nrt"], wp["p0"])):
                w.nrt[i], w.p0[i] = n, p0

    def _vec(self, t, name):
        """Device address of a state vector; this object's own outputs
        need no check."""
        ptr = t.data_ptr()
        if ptr not in self.own:
            _check_vec(t, self.ntraj, self.nph, name)
        return ptr

    def _launch(self, stage, x, q, pf, h, h_stride, base, tails, step,
                mask=None, f_out=None, fbs=None):
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
        a.step_off = self.word.off(step)
        for i, (b, was) in enumerate(zip(self.bath_args[stage],
                                         self.bound[stage])):
            tail, fb = tails[i], None if fbs is None else fbs[i]
            if tail is not was[0]:
                b.tail = 0 if tail is None else tail.data_ptr()
                was[0] = tail
            if fb is not was[1]:
                b.fb = 0 if fb is None else fb.data_ptr()
                was[1] = fb
        stream = build.current_stream(self.device)
        if self.wide and (stage != PRED or self.wide_pred):
            rc = self.lib.bath_force_wide_f32(
                ctypes.byref(self.wides[stage]), stream)
        else:
            rc = self.lib.bath_force_f32(ctypes.byref(a), stream)
        build.check(rc, "bath_force")
        launches += 1
        if a.tt <= 2 and not a.staged:
            launches_wide += 1
        return out_p, out_q

    def _bind_rows(self, ring, cur, etot, ps, qs):
        """The predictor's ring and output arrays, checked and set once
        for as long as the same tensors are passed."""
        key = tuple(None if t is None else (t.data_ptr(), t.stride())
                    for t in (ring, cur, etot, ps, qs))
        if key == self.rows:
            return
        n, nb, nph = self.ntraj, len(self.ops), self.nph
        if ring.ndim != 3 or ring.shape[0] != n or ring.shape[2] != nph or \
                not ring.is_contiguous() or ring.dtype != torch.float32:
            raise ValueError("bath_force: the ring must be a contiguous "
                             "float32 (traj, mlr, nph) tensor")
        if (cur.ndim != 3 or cur.shape[0] != n or cur.shape[2] != nb or
                (nb and cur.stride(2) != 1) or etot.ndim != 2 or
                etot.shape[0] != n):
            raise ValueError("bath_force: cur must be (traj, steps, nb) "
                             "with unit stride along baths, etot (traj, "
                             "steps)")
        for t, name in ((ps, "ps"), (qs, "qs")):
            if t is not None and (t.ndim != 3 or t.shape[0] != n or
                                  t.shape[2] != nph or t.stride(2) != 1 or
                                  t.dtype != torch.float32):
                raise ValueError(f"bath_force: {name} must be float32 "
                                 "(traj, steps, nph) with unit stride "
                                 "along DOFs")
        a = self.stages[PRED]
        mlr = ring.shape[1]
        a.mlr = mlr
        # a ring of one row is read at the head and pushed on that same
        # row: the wide route's CTAs would race there, the tiled kernel's
        # (a trajectory each) do not
        self.wide_pred = self.wide and (
            mlr > 1 or not any(op.has_h for op in self.ops))
        a.push = ring.data_ptr()
        a.push_stride = mlr * nph
        a.cur, a.cur_stride = cur.data_ptr(), cur.stride(0)
        a.cur_step = cur.stride(1)
        a.etot, a.etot_stride = etot.data_ptr(), etot.stride(0)
        a.etot_step = etot.stride(1)
        for t, name in ((ps, "ps"), (qs, "qs")):
            setattr(a, name, 0 if t is None else t.data_ptr())
            setattr(a, name + "_stride", 0 if t is None else t.stride(0))
            setattr(a, name + "_step", 0 if t is None else t.stride(1))
        self.rows = key

    def pred(self, p, q, pf, ring, step: int, tails, cur, etot, fbs=None,
             ps=None, qs=None):
        """Predictor of step ``step``: (pthalf, qtt); writes row ``step``
        of ``cur`` (traj, steps, nb), ``etot`` (traj, steps) and, if
        given, of ``ps`` and ``qs`` (traj, steps, nph) (the step's p and
        q), pushes p onto the ring (traj, mlr, nph), and the per-bath
        forces into ``fbs`` if given."""
        mlr = ring.shape[1]
        if not self.cuda:
            head = (-step) % mlr
            if ps is not None:
                ps[:, step] = p
            if qs is not None:
                qs[:, step] = q
            return pred_plain(p, q, pf, ring, head, (head - 1) % mlr,
                              self.ops, tails, (self.t0 + step) % self.nmd,
                              self.dt, cur[:, step], etot[:, step], fbs)
        self._bind_rows(ring, cur, etot, ps, qs)
        return self._launch(PRED, p, q, pf, ring.data_ptr(), mlr * self.nph,
                            None, tails, step, fbs=fbs)

    def corr(self, x, qtt, pf2, p, pthalf, tails, step: int, mask=None,
             f_out=None):
        """Corrector of step ``step``: (pthalf + dt/2 f, None); with
        ``mask`` the last stage: (masked p, masked qtt). ``f_out``
        receives f."""
        if not self.cuda:
            return corr_plain(x, qtt, pf2, p, pthalf, self.ops, tails,
                              (self.t0 + step + 1) % self.nmd, self.dt, mask,
                              f_out)
        return self._launch(LAST if mask is not None else CORR, x, qtt, pf2,
                            self._vec(p, "p"), self.nph, pthalf, tails, step,
                            mask=mask, f_out=f_out)
