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

MAX_BATHS = 4         # BF_MAX_BATHS in csrc/bath_force.cu
PRED, CORR, LAST = 0, 1, 2


def reset_count():
    global launches
    launches = 0


class ForceOperands(NamedTuple):
    """One bath's operands, built once per segment: the force is
    ``n - s (Mv v + Mh h + tail) + Mq q``; matrices are stored transposed
    (``MvT[b, a] = Mv[a, b]``) for the kernel, None where absent."""
    bath: object                     # EBath or PhBath (the twin's rules)
    MvT: torch.Tensor
    MhT: Optional[torch.Tensor]
    MqT: Optional[torch.Tensor]
    s: float
    cids: torch.Tensor               # (nc,) int32 on the device


def force_operands(b) -> ForceOperands:
    dev = b.kernel.device
    cids = torch.as_tensor(b.cids, dtype=torch.int32, device=dev)
    if isinstance(b, EBath):
        Mv, Mq = b.efric, None
        if b.bias_terms:
            Mv = b.efric + b.bias * b.zeta2
            Mq = b.bias * (b.exim - b.zeta1)
        return ForceOperands(b, Mv.t().contiguous(), None,
                             None if Mq is None else Mq.t().contiguous(),
                             1.0, cids)
    if not isinstance(b, PhBath):
        raise TypeError(f"bath_force: unknown bath type {type(b).__name__}")
    if b.ml == 1:
        return ForceOperands(b, b.kernel[0].t().contiguous(), None, None,
                             1.0, cids)
    return ForceOperands(b, b.kernel[0].t().contiguous(),
                         b.kernel[1].t().contiguous(), None, float(b.dt),
                         cids)


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
            if op.MhT is not None else None
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
    _fields_ = [("noise", ctypes.c_void_p), ("MvT", ctypes.c_void_p),
                ("MhT", ctypes.c_void_p), ("MqT", ctypes.c_void_p),
                ("tail", ctypes.c_void_p), ("cids", ctypes.c_void_p),
                ("fb", ctypes.c_void_p), ("nc", ctypes.c_int),
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
                ("tt", ctypes.c_int), ("ncmax", ctypes.c_int),
                ("tail_col", ctypes.c_int),
                ("dt", ctypes.c_float), ("hdt", ctypes.c_float),
                ("dt2h", ctypes.c_float),
                ("baths", _BfBath * MAX_BATHS)]


def tile_size(ntraj: int, device) -> int:
    """Trajectories per CTA: the largest of 8/4/2/1 that still gives
    two CTAs per SM (each CTA reads every bath matrix once for its tile,
    so larger tiles cut L2 traffic; more CTAs keep the SMs busy)."""
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    for tt in (8, 4, 2):
        if -(-ntraj // tt) >= 2 * nsm:
            return tt
    return 1


def _vec(t, ntraj, nph, name):
    if t.shape != (ntraj, nph) or t.dtype != torch.float32 or \
            not t.is_contiguous():
        raise ValueError(f"bath_force: {name} must be a contiguous float32 "
                         f"({ntraj}, {nph}) tensor")
    return t.data_ptr()


class BathForce:
    """K7 for one segment of ``ntraj`` trajectories: ``pred`` and
    ``corr`` run the kernel on CUDA tensors (operands and launch
    arguments set up once) and the twins on CPU tensors."""

    def __init__(self, baths, ntraj: int, nph: int, nmd: int, dt: float,
                 device):
        if len(baths) > MAX_BATHS:
            raise ValueError(f"bath_force: at most {MAX_BATHS} baths, got "
                             f"{len(baths)}")
        self.ops = [force_operands(b) for b in baths]
        self.ntraj, self.nph, self.nmd, self.dt = ntraj, nph, nmd, dt
        self.cuda = torch.device(device).type == "cuda"
        if not self.cuda:
            return
        a = _BfArgs()
        a.ntraj, a.nph, a.nb, a.nmd = ntraj, nph, len(baths), nmd
        a.ncmax = max([op.bath.nc for op in self.ops], default=1)
        a.tt = tile_size(ntraj, device)
        a.dt, a.hdt, a.dt2h = dt, dt / 2.0, dt * dt / 2.0
        for i, op in enumerate(self.ops):
            b, nc = op.bath, op.bath.nc
            if np.min(b.cids) < 0 or np.max(b.cids) >= nph or \
                    len(np.unique(b.cids)) != nc:
                raise ValueError("bath_force: bath DOF indices must be "
                                 "distinct and in range")
            mats = [m for m in (op.MvT, op.MhT, op.MqT) if m is not None]
            for t in mats + [b.noise]:
                if t.device.type != "cuda" or t.dtype != torch.float32 or \
                        not t.is_contiguous():
                    raise TypeError("bath_force: the kernel takes "
                                    "contiguous float32 CUDA operands")
            if b.noise.shape != (ntraj, nmd, nc):
                raise ValueError(f"bath_force: bath {i} needs a ({ntraj}, "
                                 f"{nmd}, {nc}) noise batch")
            a.baths[i] = _BfBath(
                b.noise.data_ptr(), op.MvT.data_ptr(),
                0 if op.MhT is None else op.MhT.data_ptr(),
                0 if op.MqT is None else op.MqT.data_ptr(),
                0, op.cids.data_ptr(), 0, nc, op.s)
        self.args = a
        self.stream = torch.cuda.current_stream(device).cuda_stream
        self.lib = build.load()

    def _launch(self, stage, x, q, pf, h, h_stride, base, tails, row,
                mask=None, push=None, push_stride=0, cur=None, etot=None,
                f_out=None, fbs=None):
        global launches
        a, n, nph = self.args, self.ntraj, self.nph
        a.x, a.q, a.pf = (_vec(x, n, nph, "x"), _vec(q, n, nph, "q"),
                          _vec(pf, n, nph, "pf"))
        a.base = 0 if base is None else _vec(base, n, nph, "base")
        a.h, a.h_stride = (0, 0) if h is None else (h.data_ptr(), h_stride)
        a.mask = 0 if mask is None else mask.data_ptr()
        out_p = torch.empty_like(x)
        out_q = torch.empty_like(x) if stage != CORR else None
        a.out_p = out_p.data_ptr()
        a.out_q = 0 if out_q is None else out_q.data_ptr()
        a.f_out = 0 if f_out is None else _vec(f_out, n, nph, "f_out")
        a.push, a.push_stride = (0, 0) if push is None else \
            (push.data_ptr(), push_stride)
        a.cur, a.cur_stride = (0, 0) if cur is None else \
            (cur.data_ptr(), cur.stride(0))
        a.etot, a.etot_stride = (0, 0) if etot is None else \
            (etot.data_ptr(), etot.stride(0))
        a.row, a.stage = row % self.nmd, stage
        a.tail_col = 0 if stage == PRED else 1
        for i in range(a.nb):
            a.baths[i].tail = 0 if tails[i] is None else tails[i].data_ptr()
            a.baths[i].fb = 0 if fbs is None else fbs[i].data_ptr()
        rc = self.lib.bath_force_f32(ctypes.byref(a), self.stream)
        build.check(rc, "bath_force")
        launches += 1
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
        if ring.shape != (self.ntraj, mlr, self.nph) or \
                not ring.is_contiguous() or ring.dtype != torch.float32:
            raise ValueError("bath_force: the ring must be a contiguous "
                             "float32 (traj, mlr, nph) tensor")
        if (cur.shape != (self.ntraj, len(self.ops)) or
                etot.shape != (self.ntraj,) or
                (len(self.ops) and cur.stride(1) != 1)):
            raise ValueError("bath_force: cur must be (traj, nb) with "
                             "unit stride along baths, etot (traj,)")
        return self._launch(PRED, p, q, pf, ring[:, head], mlr * self.nph,
                            None, tails, row,
                            push=None if push is None else ring[:, push],
                            push_stride=mlr * self.nph, cur=cur, etot=etot,
                            fbs=fbs)

    def corr(self, x, qtt, pf2, p, pthalf, tails, row: int, mask=None,
             f_out=None):
        """Corrector: (pthalf + dt/2 f, None); with ``mask`` the last
        stage: (masked p, masked qtt). ``f_out`` receives f."""
        if not self.cuda:
            return corr_plain(x, qtt, pf2, p, pthalf, self.ops, tails, row,
                              self.dt, mask, f_out)
        return self._launch(LAST if mask is not None else CORR, x, qtt, pf2,
                            p, self.nph, pthalf, tails, row, mask=mask,
                            f_out=f_out)
