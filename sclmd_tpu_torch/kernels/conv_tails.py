"""K6: the memory-kernel tails shared by the three bath-force evaluations
of a plain GLE step (``PhBath.step_plan``, used by ``md.run_segment``).

For every non-local phonon bath with ml > 2 and every trajectory t,

    tails[t, :, 0] = sum_{r=2}^{ml-1} K[r] old[r-1]    (predictor)
    tails[t, :, 1] = sum_{r=2}^{ml-1} K[r] old[r-2]    (corrector)

where old[i] is the pre-step velocity history on the bath's DOFs,
newest first. The integrator keeps that history as a circular ring
(traj, mlr, nph) with a head index, old[i] = ring[:, (head + i) % mlr],
so no step shifts the history; both forms read it modulo mlr. At step s
of a segment the head is -s mod mlr; the kernel reads s on the card
(the segment's step word, ``kernels.step_graph``), so its launch replays
in a CUDA graph.

``ConvTails`` launches the hand-written kernel (csrc/conv_tails.cu) on
CUDA tensors and runs ``conv_tails_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sclmd_tpu_torch.baths import PhBath
from sclmd_tpu_torch.kernels import build
from sclmd_tpu_torch.kernels.step_graph import StepWord
from sclmd_tpu_torch.utils import profiling

launches = 0          # conv_tails kernel launches (not twin calls)

MAX_BATHS = 4         # CT_MAX_BATHS in csrc/conv_tails.cu
ROWS = 96             # CT_ROWS: most output rows a CTA (a stream) takes
MAX_STAGES = 8        # CT_MAX_STAGES: most stages of the shared-memory ring
BAR_BYTES = 128       # CT_BAR_BYTES: the ring's barriers
THREADS = 640         # CT_THREADS: 16 consumer warps and 4 producer warps
SMEM_LIMIT = 227 * 1024   # dynamic shared memory a CTA may ask for (H100)
# The share of L2 that the kernel slab is asked to stay in from one step
# to the next; the rest of a slab larger than that streams through what is
# left. On an H100 (50 MB of L2) with the primary junction's 65 MB slab at
# one trajectory, shares of 0.55-0.7 gave about 24 us per step against
# about 29 both with none of it and with all of L2 asked for, and about 26
# at 0.4 and 0.85 (PERF.md, Findings)
KEEP_L2_SHARE = 0.7


def reset_count():
    global launches
    launches = 0


profiling.register("launches.K6", __name__, "launches")


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


def tap_partition(taps, weights, ncta: int) -> list:
    """Deal the taps of ``len(taps)`` streams out to at most ``ncta``
    CTAs: ``[(stream, r0, r1), ...]`` in stream order, tap indices
    counted from 0. A CTA takes a contiguous range of one stream; every
    tap of every stream is taken exactly once; every stream gets at
    least one CTA (so the result may exceed ``ncta`` where it is below
    the number of streams) and no CTA is empty. ``weights`` are bytes
    per tap: the CTAs go, one by one, to the stream with the most bytes
    per CTA, and a stream's taps are split evenly over its CTAs."""
    n = len(taps)
    if n == 0 or min(taps) < 1:
        raise ValueError("tap_partition: every stream needs a tap")
    cnt = [1] * n
    for _ in range(min(ncta, sum(taps)) - n):
        open_ = [i for i in range(n) if cnt[i] < taps[i]]
        i = max(open_, key=lambda j: (taps[j] * weights[j] / cnt[j], -j))
        cnt[i] += 1
    out = []
    for i in range(n):
        base, extra = divmod(taps[i], cnt[i])
        r = 0
        for c in range(cnt[i]):
            step = base + (1 if c < extra else 0)
            out.append((i, r, r + step))
            r += step
    return out


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def stream_plan(ncs, mls, ntraj: int, nsm: int) -> dict:
    """The kernel's launch plan for baths of widths ``ncs`` and kernel
    lengths ``mls`` on a card of ``nsm`` SMs.

    ``tt`` trajectories per CTA and ``ntiles`` trajectory tiles; the
    streams (bath, first row, rows): a bath's rows in slices of at most
    ``ROWS`` that fit a stage; ``kfloats`` floats of a stage for the
    tap's rows (3 spare for a chunk that starts off a 16-byte boundary);
    ``nstage`` stages, beside ``nstage + 1`` history rows of ``hld``
    floats per trajectory; the table ``desc`` with one row per CTA (bath, first row,
    rows, first tap, end tap, stream, the stream's first CTA, its CTA
    count), from ``tap_partition`` over about ``nsm / ntiles`` CTAs."""
    tt = 1 if ntraj == 1 else (2 if ntraj == 2 else 4)
    ntiles = -(-ntraj // tt)
    ncmax = max(ncs)
    hld = _up4(ncmax)
    budget = (SMEM_LIMIT - BAR_BYTES - 4 * _up4(ncmax)) // 4   # floats
    for want in (4, 3, 2):
        cap = (budget - (want + 1) * tt * hld) // want - 4
        if cap >= ncmax:
            break
    else:
        raise ValueError(f"conv_tails: a row of {ncmax} floats does not fit "
                         "the shared-memory ring")
    streams = []
    for i, nc in enumerate(ncs):
        nsl = -(-nc // min(ROWS, nc, cap // nc))
        ra = -(-nc // nsl)
        streams += [(i, a0, min(ra, nc - a0)) for a0 in range(0, nc, ra)]
    kfloats = _up4(max(ra * ncs[i] for i, _, ra in streams) + 3)
    nstage = min(MAX_STAGES, (budget - tt * hld) // (kfloats + tt * hld))
    taps = [mls[i] - 2 for i, _, _ in streams]
    parts = tap_partition(taps, [4 * ra * ncs[i] for i, _, ra in streams],
                          max(1, nsm // ntiles))
    desc, first, count = [], {}, {}
    for c, (st, _, _) in enumerate(parts):
        first.setdefault(st, c)
        count[st] = count.get(st, 0) + 1
    for st, r0, r1 in parts:
        i, a0, ra = streams[st]
        desc.append((i, a0, ra, 2 + r0, 2 + r1, st, first[st], count[st]))
    return {"tt": tt, "ntiles": ntiles, "streams": streams, "hld": hld,
            "kfloats": kfloats, "nstage": nstage, "desc": desc,
            # (the closing sum keeps THREADS float pairs where the ring was)
            "smem_bytes": BAR_BYTES + 4 * max(
                nstage * kfloats + (nstage + 1) * tt * hld + _up4(ncmax),
                2 * THREADS)}


class _CtBath(ctypes.Structure):
    _fields_ = [("K", ctypes.c_void_p), ("cids", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("nc", ctypes.c_int), ("ml", ctypes.c_int)]


class _CtArgs(ctypes.Structure):
    _fields_ = [("ring", ctypes.c_void_p), ("desc", ctypes.c_void_p),
                ("part", ctypes.c_void_p), ("tickets", ctypes.c_void_p),
                ("step", ctypes.c_void_p),
                ("ntraj", ctypes.c_int), ("mlr", ctypes.c_int),
                ("nph", ctypes.c_int), ("step_off", ctypes.c_int),
                ("nb", ctypes.c_int), ("ncta", ctypes.c_int),
                ("ntiles", ctypes.c_int), ("nstream", ctypes.c_int),
                ("tt", ctypes.c_int), ("nstage", ctypes.c_int),
                ("kfloats", ctypes.c_int),
                ("hld", ctypes.c_int), ("smem_bytes", ctypes.c_int),
                ("keep_permille", ctypes.c_int),
                ("baths", _CtBath * MAX_BATHS)]


class ConvTailsCuda:
    """K6 launches for one segment: the operands, outputs, launch plan
    and partial-sum workspace are set up once; each call passes only the
    step s of the segment (the head is -s mod mlr), as an offset to the
    step word ``word`` (``kernels.step_graph.StepWord``, made here when
    not given). The outputs are reused by every call, so a step's tails
    live until the next call (the integrator reads them within the
    step). ``nsm`` overrides the card's SM count in the plan,
    ``keep_l2_share`` the share of L2 the slab is asked to stay in."""

    def __init__(self, ring: torch.Tensor, baths, nsm=None,
                 keep_l2_share: float = KEEP_L2_SHARE, word=None):
        dev = ring.device
        if dev.type != "cuda":
            raise ValueError("conv_tails: the kernel takes CUDA tensors")
        if ring.dtype != torch.float32 or not ring.is_contiguous():
            raise TypeError("conv_tails: the ring must be contiguous float32")
        if not 1 <= len(baths) <= MAX_BATHS:
            raise ValueError(f"conv_tails: 1..{MAX_BATHS} baths supported, "
                             f"got {len(baths)}")
        ntraj, mlr, nph = ring.shape
        if nsm is None:
            nsm = torch.cuda.get_device_properties(dev).multi_processor_count
        self.plan = plan = stream_plan([b.nc for b in baths],
                                       [b.ml for b in baths], ntraj, nsm)
        self.lib = build.load()
        if self.lib.conv_tails_rows() != ROWS:
            raise RuntimeError("conv_tails: ROWS differs from the kernel's")
        desc = torch.tensor(plan["desc"], dtype=torch.int32, device=dev)
        ncta = desc.shape[0]
        part = torch.empty((plan["ntiles"], ncta, plan["tt"], ROWS, 2),
                           dtype=torch.float32, device=dev)
        tickets = torch.zeros((plan["ntiles"], len(plan["streams"])),
                              dtype=torch.int32, device=dev)
        self._keep = [ring, desc, part, tickets]
        self.word = StepWord(dev) if word is None else word
        a = _CtArgs()
        a.ring, a.ntraj, a.mlr, a.nph = ring.data_ptr(), ntraj, mlr, nph
        a.step = self.word.ptr
        a.desc, a.part, a.tickets = (desc.data_ptr(), part.data_ptr(),
                                     tickets.data_ptr())
        a.nb, a.ncta, a.nstream = len(baths), ncta, len(plan["streams"])
        for k in ("ntiles", "tt", "nstage", "kfloats", "hld", "smem_bytes"):
            setattr(a, k, plan[k])
        slab = 4 * sum((b.ml - 2) * b.nc * b.nc for b in baths)
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        a.keep_permille = min(1000, int(1000 * keep_l2_share * l2 / slab))
        self.outs = []
        for i, b in enumerate(baths):
            K = b.kernel
            nc, ml = b.nc, b.ml
            if K.device != dev or K.dtype != torch.float32 or \
                    not K.is_contiguous() or K.shape != (ml, nc, nc):
                raise ValueError("conv_tails: each kernel must be a "
                                 "contiguous float32 (ml, nc, nc) tensor "
                                 "on the ring's device")
            if K.data_ptr() % 16:
                raise ValueError("conv_tails: each kernel must start on a "
                                 "16-byte boundary")
            if ml <= 2 or ml > mlr:
                raise ValueError(f"conv_tails: need 2 < ml <= {mlr}, got {ml}")
            if np.min(b.cids) < 0 or np.max(b.cids) >= nph:
                raise ValueError("conv_tails: bath DOF index out of range")
            cids = torch.as_tensor(b.cids, dtype=torch.int32, device=dev)
            out = torch.empty((ntraj, nc, 2), dtype=torch.float32,
                              device=dev)
            self._keep += [K, cids]
            self.outs.append(out)
            a.baths[i] = _CtBath(K.data_ptr(), cids.data_ptr(),
                                 out.data_ptr(), nc, ml)
        self.args = a
        self.device = dev

    def __call__(self, step: int) -> list:
        global launches
        self.args.step_off = self.word.off(step)
        rc = self.lib.conv_tails_f32(ctypes.byref(self.args),
                                     build.current_stream(self.device))
        build.check(rc, "conv_tails")
        launches += 1
        return self.outs


def conv_tails_plan(ring: torch.Tensor, baths, word=None):
    """A callable ``step -> [tails per bath]`` for one segment (the ring's
    head at step s is -s mod mlr): the CUDA kernel for a CUDA ring, on
    the step word ``word``, the plain twin for a CPU ring."""
    if ring.device.type == "cpu":
        mlr = ring.shape[1]
        return lambda step: conv_tails_plain(ring, (-step) % mlr, baths)
    return ConvTailsCuda(ring, baths, word=word)
