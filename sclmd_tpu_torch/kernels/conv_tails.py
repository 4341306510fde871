"""K6: the memory-kernel tails shared by the three bath-force evaluations
of a plain GLE step (``PhBath.step_plan``, used by ``md.run_segment``).

For every non-local phonon bath with ml > 2 and every trajectory t,

    tails[t, :, 0] = sum_{r=2}^{ml-1} K[r] old[r-1]    (predictor)
    tails[t, :, 1] = sum_{r=2}^{ml-1} K[r] old[r-2]    (corrector)

where old[i] is the pre-step velocity history on the bath's DOFs,
newest first. The integrator keeps that history as a circular ring
(traj, mlr, nph) with a head index, old[i] = ring[:, (head + i) % mlr],
so no step shifts the history; both forms read it modulo mlr.

``ConvTails`` launches the hand-written kernel (csrc/conv_tails.cu) on
CUDA tensors and runs ``conv_tails_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sclmd_tpu_torch.baths import PhBath
from sclmd_tpu_torch.kernels import build

launches = 0          # conv_tails kernel launches (not twin calls)

MAX_BATHS = 4         # CT_MAX_BATHS in csrc/conv_tails.cu
TAPS = 8              # CT_TAPS: kernel taps per CTA (the K split)


def reset_count():
    global launches
    launches = 0


def tail_baths(baths) -> list:
    """Indices of the baths that need tails: non-local phonon baths with
    ml > 2 (every other force rule reads no history beyond old[0])."""
    return [i for i, b in enumerate(baths)
            if isinstance(b, PhBath) and b.ml > 2]


def conv_tails_plain(ring: torch.Tensor, head: int, baths) -> list:
    """Plain torch twin: per bath (traj, nc, 2), from ``PhBath.step_plan``
    on the history gathered out of the ring."""
    mlr = ring.shape[1]
    out = []
    for b in baths:
        idx = (head + torch.arange(b.ml, device=ring.device)) % mlr
        out.append(b.step_plan(ring.index_select(1, idx)[:, :, b.cols]))
    return out


class _CtBath(ctypes.Structure):
    _fields_ = [("K", ctypes.c_void_p), ("cids", ctypes.c_void_p),
                ("part", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("nc", ctypes.c_int), ("ml", ctypes.c_int),
                ("nsplit", ctypes.c_int), ("split0", ctypes.c_int)]


class _CtArgs(ctypes.Structure):
    _fields_ = [("ring", ctypes.c_void_p),
                ("ntraj", ctypes.c_int), ("mlr", ctypes.c_int),
                ("nph", ctypes.c_int), ("head", ctypes.c_int),
                ("nb", ctypes.c_int), ("nsplit", ctypes.c_int),
                ("tt", ctypes.c_int),
                ("baths", _CtBath * MAX_BATHS)]


class ConvTailsCuda:
    """K6 launches for one segment: the operands, outputs and split
    workspace are set up once; each call passes only the ring's head.
    The outputs are reused by every call, so a step's tails live until
    the next call (the integrator reads them within the step)."""

    def __init__(self, ring: torch.Tensor, baths):
        dev = ring.device
        if dev.type != "cuda":
            raise ValueError("conv_tails: the kernel takes CUDA tensors")
        if ring.dtype != torch.float32 or not ring.is_contiguous():
            raise TypeError("conv_tails: the ring must be contiguous float32")
        if not 1 <= len(baths) <= MAX_BATHS:
            raise ValueError(f"conv_tails: 1..{MAX_BATHS} baths supported, "
                             f"got {len(baths)}")
        ntraj, mlr, nph = ring.shape
        self._keep = [ring]
        a = _CtArgs()
        a.ring, a.ntraj, a.mlr, a.nph = ring.data_ptr(), ntraj, mlr, nph
        a.nb = len(baths)
        a.tt = 1 if ntraj == 1 else (2 if ntraj == 2 else 4)
        self.outs = []
        split0 = 0
        for i, b in enumerate(baths):
            K = b.kernel
            nc, ml = b.nc, b.ml
            if K.device != dev or K.dtype != torch.float32 or \
                    not K.is_contiguous() or K.shape != (ml, nc, nc):
                raise ValueError("conv_tails: each kernel must be a "
                                 "contiguous float32 (ml, nc, nc) tensor "
                                 "on the ring's device")
            if ml <= 2 or ml > mlr:
                raise ValueError(f"conv_tails: need 2 < ml <= {mlr}, got {ml}")
            if np.min(b.cids) < 0 or np.max(b.cids) >= nph:
                raise ValueError("conv_tails: bath DOF index out of range")
            cids = torch.as_tensor(b.cids, dtype=torch.int32, device=dev)
            nsplit = -(-(ml - 2) // TAPS)
            part = torch.empty((nsplit, ntraj, nc, 2), dtype=torch.float32,
                               device=dev)
            out = torch.empty((ntraj, nc, 2), dtype=torch.float32,
                              device=dev)
            self._keep += [K, cids, part]
            self.outs.append(out)
            a.baths[i] = _CtBath(K.data_ptr(), cids.data_ptr(),
                                 part.data_ptr(), out.data_ptr(), nc, ml,
                                 nsplit, split0)
            split0 += nsplit
        a.nsplit = split0
        self.args = a
        self.mlr = mlr
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.lib = build.load()

    def __call__(self, head: int) -> list:
        global launches
        self.args.head = head % self.mlr
        rc = self.lib.conv_tails_f32(ctypes.byref(self.args), self.stream)
        build.check(rc, "conv_tails")
        launches += 1
        return self.outs


def conv_tails_plan(ring: torch.Tensor, baths):
    """A callable ``head -> [tails per bath]`` for one segment: the CUDA
    kernel for a CUDA ring, the plain twin for a CPU ring."""
    if ring.device.type == "cpu":
        return lambda head: conv_tails_plain(ring, head, baths)
    return ConvTailsCuda(ring, baths)
