"""K1: one block of fused GLE velocity-Verlet steps for a batch of
trajectories (the inner scan body of ``md.run_segment_blocked``).

Per step and trajectory, term by term as the JAX package's
``_run_segment_blocked_body.inner``:

* per non-local phonon bath: the predictor bath force
  ``n0 - dt (K0 p + tails[:, 0] + O[s])`` with the in-block tails
  ``kin @ S``, S stacking [ring; 0] (predictor) and [0; ring]
  (corrector) as its two columns, and the corrector base
  ``K1 p + tails[:, 1] + O[s+1]``;
* the Verlet half-step and ``qtt``; the harmonic force ``-dyn qtt``;
  two corrector bath sums; the mask;
* the per-bath current ``fb . p`` and ``etot = p.p / 2`` of the
  pre-step state; the ring push of the pre-step ``p``; the force
  carry-forward ``pf = -dyn qtt`` when the system is unconstrained
  (else ``pf = -dyn q`` at every step).

``gle_block_plain`` is that block written out whole, the reference.

``gle_block`` runs the block as sub-blocks of ``sub_steps`` steps. The
in-block tails are C[s] = O[s] + sum_{j<s} K[s-j] p_j for the predictor
and C[s+1] (with p_s) for the corrector base, so they split in two:

* near taps, ``gle_near``: the sequential steps of one sub-block, which
  convolve only the rows of their own sub-block (at most S taps);
* far taps, ``gle_far``: after a sub-block, its S rows are added to the
  tails O of every later step of the block, one GEMM for all
  trajectories (kin read once per tile of trajectories, not per step).

On CUDA tensors both are hand-written kernels (csrc/gle_block.cu and
csrc/gle_far.cu); on CPU tensors their plain twins ``gle_near_plain``
and ``gle_far_plain`` run in the same composition.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sclmd_tpu_torch.kernels import build
from sclmd_tpu_torch.ops.functions import matvec
from sclmd_tpu_torch.utils import profiling

launches_near = 0     # gle_near kernel launches (not twin calls)
launches_far = 0      # gle_far kernel launches (not twin calls)

MAX_BATHS = 4         # GLE_MAX_BATHS in csrc/gle_block.cu, FAR_MAX_BATHS
THREADS = 512         # GLE_THREADS in csrc/gle_block.cu
SMEM_LIMIT = 227 * 1024
# steps per sub-block: at the primary shapes on an H100, 8 to 16 steps
# ran within 1-2 % of each other, 12 the fastest, and 32 and 64 slower by
# 10 and 36 % a block (PERF.md, Findings)
SUB = 12


def reset_count():
    global launches_near, launches_far
    launches_near = launches_far = 0


profiling.register("launches.K1_near", __name__, "launches_near")
profiling.register("launches.K1_far", __name__, "launches_far")


class BathOperands(NamedTuple):
    """One non-local phonon bath's operands for one block."""
    noise: torch.Tensor   # (traj, nmd, nc) colored noise, row t at t mod nmd
    O: torch.Tensor       # (traj, block+1, nc) pre-block tails from K2
    kin: torch.Tensor     # (nc, (block+1)*nc) taps 1..block+1
    kinT: torch.Tensor    # kin as the kernels read it (``tap_major``)
    K0: torch.Tensor      # (nc, nc) tap 0
    cols: object          # slice (contiguous DOFs) or long index tensor
    cids: torch.Tensor    # (nc,) int32 DOF indices on the device


class BlockResult(NamedTuple):
    p: torch.Tensor       # (traj, nph) after the block
    q: torch.Tensor
    pf: torch.Tensor      # potential force carried into the next block
    qprev: torch.Tensor   # q at the start of the block's last step
    rings: tuple          # per bath (traj, block, nc), newest first
    cur: torch.Tensor     # (traj, block, nb) per-bath heat current
    etot: torch.Tensor    # (traj, block) kinetic energy p.p/2


def gle_block_plain(p, q, pf, dyn, mask, baths, t0: int, nmd: int,
                    dt: float, free: bool, block: int) -> BlockResult:
    """The whole block written out, batched over the leading trajectory
    axis: the reference the split composition is held against."""
    ntraj, nph = p.shape
    nb = len(baths)
    dtype = p.dtype
    rings = [torch.zeros((ntraj, block, b.kin.shape[0]), dtype=dtype,
                         device=p.device) for b in baths]
    K1s = [b.kin[:, :b.kin.shape[0]] for b in baths]
    curs, etots = [], []
    qprev = q
    for s in range(block):
        r0, r1 = (t0 + s) % nmd, (t0 + s + 1) % nmd
        if not free:
            pf = -matvec(dyn, q)
        etots.append(0.5 * (p * p).sum(-1))
        f = pf.clone()
        fbs, cbases = [], []
        for i, b in enumerate(baths):
            nc = b.kin.shape[0]
            p_c = p[:, b.cols]
            z1 = torch.zeros((ntraj, 1, nc), dtype=dtype, device=p.device)
            S = torch.stack([torch.cat([rings[i], z1], 1),
                             torch.cat([z1, rings[i]], 1)], dim=3)
            tails = b.kin @ S.reshape(ntraj, (block + 1) * nc, 2)
            conv = matvec(b.K0, p_c) + tails[..., 0] + b.O[:, s]
            fb = b.noise[:, r0] - conv * dt
            cbases.append(matvec(K1s[i], p_c) + tails[..., 1] + b.O[:, s + 1])
            f[:, b.cols] += fb
            fbs.append((fb, p_c))
        pthalf = p + f * (dt / 2.0)
        qtt = q + p * dt + f * (dt * dt / 2.0)
        curs.append(torch.stack([(fb * p_c).sum(-1) for fb, p_c in fbs],
                                dim=-1) if nb else p.new_zeros((ntraj, 0)))
        pf2 = -matvec(dyn, qtt)

        def bath_sum(pt):
            out = pf2.clone()
            for i, b in enumerate(baths):
                fl = b.noise[:, r1] - (matvec(b.K0, pt[:, b.cols])
                                       + cbases[i]) * dt
                out[:, b.cols] += fl
            return out

        ptt1 = pthalf + (dt / 2.0) * bath_sum(pthalf)
        ptt2 = pthalf + (dt / 2.0) * bath_sum(ptt1)
        rings = [torch.cat([p[:, b.cols].unsqueeze(1), rings[i][:, :-1]], 1)
                 for i, b in enumerate(baths)]
        qprev = q
        p, q = ptt2 * mask, qtt * mask
        if free:
            pf = pf2
    return BlockResult(p, q, pf, qprev, tuple(rings),
                       torch.stack(curs, dim=1), torch.stack(etots, dim=1))


class BlockState:
    """What the sub-blocks of one block hand on: the state (p, q, pf,
    qprev), the tails O with every finished sub-block added, and the
    block's outputs (rings, cur, etot), filled step by step. The CUDA
    kernels update these tensors in place."""

    def __init__(self, p, q, pf, baths, block: int):
        ntraj = p.shape[0]
        dev, dtype = p.device, p.dtype
        self.p, self.q, self.pf = p.clone(), q.clone(), pf.clone()
        self.qprev = q.clone()
        self.Os = [b.O.clone() for b in baths]
        self.rings = [torch.zeros((ntraj, block, b.kin.shape[0]),
                                  dtype=dtype, device=dev) for b in baths]
        self.cur = torch.zeros((ntraj, block, len(baths)), dtype=dtype,
                               device=dev)
        self.etot = torch.zeros((ntraj, block), dtype=dtype, device=dev)

    def result(self) -> BlockResult:
        return BlockResult(self.p, self.q, self.pf, self.qprev,
                           tuple(self.rings), self.cur, self.etot)


def gle_near_plain(st: BlockState, dyn, mask, baths, t0: int, nmd: int,
                   dt: float, free: bool, block: int, b0: int, ns: int):
    """Plain torch twin of the near-tap kernel: steps [b0, b0+ns) of the
    block, the in-block tails taken over the rows of this sub-block only
    and the rest from ``st.Os``."""
    p, q, pf = st.p, st.q, st.pf
    ntraj = p.shape[0]
    for s in range(b0, b0 + ns):
        r0, r1 = (t0 + s) % nmd, (t0 + s + 1) % nmd
        if not free:
            pf = -matvec(dyn, q)
        st.etot[:, s] = 0.5 * (p * p).sum(-1)
        f = pf.clone()
        fbs, cbases = [], []
        for i, b in enumerate(baths):
            nc = b.kin.shape[0]
            p_c = p[:, b.cols]
            st.rings[i][:, block - 1 - s] = p_c
            # p_s, p_{s-1}, ..., p_b0: newest first, contiguous in the ring
            near = st.rings[i][:, block - 1 - s:block - b0]
            k = near.shape[1]
            corr = matvec(b.kin[:, :k * nc], near.reshape(ntraj, k * nc))
            conv = matvec(b.K0, p_c) + st.Os[i][:, s]
            if k > 1:
                conv = conv + matvec(b.kin[:, :(k - 1) * nc],
                                     near[:, 1:].reshape(ntraj, -1))
            fb = b.noise[:, r0] - conv * dt
            cbases.append(corr + st.Os[i][:, s + 1])
            f[:, b.cols] += fb
            fbs.append((fb, p_c))
        pthalf = p + f * (dt / 2.0)
        qtt = q + p * dt + f * (dt * dt / 2.0)
        for i, (fb, p_c) in enumerate(fbs):
            st.cur[:, s, i] = (fb * p_c).sum(-1)
        pf2 = -matvec(dyn, qtt)

        def bath_sum(pt):
            out = pf2.clone()
            for i, b in enumerate(baths):
                fl = b.noise[:, r1] - (matvec(b.K0, pt[:, b.cols])
                                       + cbases[i]) * dt
                out[:, b.cols] += fl
            return out

        ptt1 = pthalf + (dt / 2.0) * bath_sum(pthalf)
        ptt2 = pthalf + (dt / 2.0) * bath_sum(ptt1)
        st.qprev = q
        p, q = ptt2 * mask, qtt * mask
        if free:
            pf = pf2
    st.p, st.q, st.pf = p, q, pf


def gle_far_plain(kin: torch.Tensor, ring: torch.Tensor, O: torch.Tensor,
                  block: int, b0: int, ns: int):
    """Plain torch twin of the far-tap kernel, in place on ``O`` (traj,
    block+1, nc): O[:, s] += sum_{i<ns} K[s-b0-i] p_{b0+i} for s in
    [b0+ns, block], with p_j = ring[:, block-1-j] and K[d] = kin's column
    block d-1."""
    nc = kin.shape[0]
    lo = b0 + ns
    taps = kin.view(nc, block + 1, nc)
    for i in range(ns):
        d0, d1 = lo - b0 - i, block - b0 - i       # taps for s = lo, block
        A = taps[:, d0 - 1:d1, :].permute(1, 0, 2).reshape(-1, nc)
        O[:, lo:] += matvec(A, ring[:, block - 1 - b0 - i]).view(
            O.shape[0], -1, nc)


def sub_steps(block: int) -> int:
    """Steps per sub-block: ``SUB`` (the fastest of a sweep at the
    primary shapes), at most the block."""
    return min(block, SUB)


def sub_blocks(block: int) -> list:
    """(first step, steps) of each sub-block of a block: ``sub_steps``
    each, the last one shorter where they do not divide the block."""
    sub = sub_steps(block)
    return [(b0, min(sub, block - b0)) for b0 in range(0, block, sub)]


def gle_block(p, q, pf, dyn, mask, baths, t0: int, nmd: int, dt: float,
              free: bool, block: int) -> BlockResult:
    """Advance every trajectory through ``block`` steps starting at
    global step ``t0``, as sub-blocks of near taps with the far taps
    added between them: the CUDA kernels for CUDA tensors, their plain
    twins for CPU tensors."""
    if p.device.type != "cpu":
        return gle_block_cuda(p, q, pf, dyn, mask, baths, t0, nmd, dt,
                              free, block)
    st = BlockState(p, q, pf, baths, block)
    subs = sub_blocks(block)
    for b0, ns in subs:
        gle_near_plain(st, dyn, mask, baths, t0, nmd, dt, free, block, b0,
                       ns)
        if (b0, ns) != subs[-1]:
            for b, ring, O in zip(baths, st.rings, st.Os):
                gle_far_plain(b.kin, ring, O, block, b0, ns)
    return st.result()


# --- the CUDA kernels ------------------------------------------------------
class _GleBath(ctypes.Structure):
    _fields_ = [("noise", ctypes.c_void_p), ("O", ctypes.c_void_p),
                ("kinT", ctypes.c_void_p), ("K0", ctypes.c_void_p),
                ("cids", ctypes.c_void_p), ("ring", ctypes.c_void_p),
                ("nc", ctypes.c_int), ("ncs", ctypes.c_int)]


class _GleArgs(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("pf", ctypes.c_void_p), ("qprev", ctypes.c_void_p),
                ("dyn", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("cur", ctypes.c_void_p), ("etot", ctypes.c_void_p),
                ("ntraj", ctypes.c_int), ("nph", ctypes.c_int),
                ("nb", ctypes.c_int), ("block", ctypes.c_int),
                ("nmd", ctypes.c_int), ("t0", ctypes.c_int),
                ("free_", ctypes.c_int), ("tt", ctypes.c_int),
                ("ncmax", ctypes.c_int),
                ("b0", ctypes.c_int), ("ns", ctypes.c_int),
                ("sub", ctypes.c_int),
                ("dt", ctypes.c_float), ("hdt", ctypes.c_float),
                ("dt2h", ctypes.c_float),
                ("baths", _GleBath * MAX_BATHS)]


class _FarBath(ctypes.Structure):
    _fields_ = [("kinT", ctypes.c_void_p), ("ring", ctypes.c_void_p),
                ("O", ctypes.c_void_p), ("nc", ctypes.c_int),
                ("ncs", ctypes.c_int)]


class _FarArgs(ctypes.Structure):
    _fields_ = [("ntraj", ctypes.c_int), ("block", ctypes.c_int),
                ("b0", ctypes.c_int), ("ns", ctypes.c_int),
                ("nb", ctypes.c_int), ("baths", _FarBath * MAX_BATHS)]


def tile_size(ntraj: int, nph: int, nb: int, ncmax: int, sub: int,
              device) -> int:
    """Trajectories per CTA of the near-tap kernel: the largest of 4/2/1
    that fits shared memory and still gives about one CTA per SM. A CTA
    reads dyn and its near taps from L2 at every step for its whole
    tile, so a larger tile cuts L2 traffic; fewer CTAs than SMs leave
    SMs idle (a sweep at the primary shapes on an H100: 256
    trajectories fastest at two per CTA, 512 at four; PERF.md,
    Findings)."""
    lib = build.load()
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    for tt in (4, 2, 1):
        if lib.gle_near_smem_bytes(tt, nph, nb, ncmax, sub) > SMEM_LIMIT:
            continue
        if tt == 1 or -(-ntraj // tt) >= (9 * nsm) // 10:
            return tt
    raise ValueError(f"gle_block: nph={nph}, nb={nb}, nc={ncmax}, "
                     f"sub-block {sub} do not fit in shared memory even at "
                     "one trajectory per CTA")


def tap_major(kin: torch.Tensor, block: int) -> torch.Tensor:
    """kin (nc, (block+1)*nc) as the kernels read it: (block+1, ncs, nc)
    with kinT[k, b, a] = kin[a, k*nc + b] and b zero-padded to ncs, a
    multiple of 4. Constant over a segment: build it once per segment."""
    nc = kin.shape[0]
    ncs = -(-nc // 4) * 4
    kt = kin.new_zeros((block + 1, ncs, nc))
    kt[:, :nc, :] = kin.view(nc, block + 1, nc).permute(1, 2, 0)
    return kt


def _check_cuda(p, q, pf, dyn, mask, baths, nmd: int, block: int):
    dev = p.device
    if dev.type != "cuda":
        raise ValueError("gle_block: the kernels take CUDA tensors")
    ntraj, nph = p.shape
    nb = len(baths)
    if nb < 1 or nb > MAX_BATHS:
        raise ValueError(f"gle_block: 1..{MAX_BATHS} baths supported, "
                         f"got {nb}")
    dense = [p, q, pf, dyn, mask] + [t for b in baths for t in
                                     (b.noise, b.O, b.kinT, b.K0, b.cids)]
    for t in dense:
        if t.device != dev:
            raise ValueError("gle_block: all operands must be on one "
                             "CUDA device")
        if t.dtype != (torch.int32 if any(t is b.cids for b in baths)
                       else torch.float32):
            raise TypeError(f"gle_block: the CUDA kernels take float32 "
                            f"operands and int32 cids, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("gle_block: operands must be contiguous")
    if q.shape != p.shape or pf.shape != p.shape or \
            dyn.shape != (nph, nph) or mask.shape != (nph,):
        raise ValueError("gle_block: p/q/pf must be (traj, nph), dyn "
                         "(nph, nph), mask (nph,)")
    for b in baths:
        nc = b.kin.shape[0]
        if b.cids.shape != (nc,) or \
                b.noise.shape != (ntraj, nmd, nc) or \
                b.O.shape != (ntraj, block + 1, nc) or \
                b.kin.shape != (nc, (block + 1) * nc) or \
                b.kinT.shape != (block + 1, -(-nc // 4) * 4, nc) or \
                b.K0.shape != (nc, nc):
            raise ValueError("gle_block: bath operand shapes do not match "
                             f"traj={ntraj} nmd={nmd} block={block} nc={nc}")
    ncmax = max(b.kin.shape[0] for b in baths)
    if ncmax > THREADS:
        raise ValueError(f"gle_block: baths wider than {THREADS} DOFs are "
                         "not supported by the kernel")
    return ncmax


def gle_near_cuda(st: BlockState, dyn, mask, baths, t0: int, nmd: int,
                  dt: float, free: bool, block: int, b0: int, ns: int,
                  sub: int, tt: int):
    """One launch of the near-tap kernel: steps [b0, b0+ns) in place on
    ``st`` (``ns`` <= ``sub``, the sub-block its shared memory holds)."""
    global launches_near
    ntraj, nph = st.p.shape
    a = _GleArgs()
    a.p, a.q, a.pf = st.p.data_ptr(), st.q.data_ptr(), st.pf.data_ptr()
    a.qprev, a.dyn, a.mask = st.qprev.data_ptr(), dyn.data_ptr(), \
        mask.data_ptr()
    a.cur, a.etot = st.cur.data_ptr(), st.etot.data_ptr()
    a.ntraj, a.nph, a.nb, a.block = ntraj, nph, len(baths), block
    a.nmd, a.t0, a.free_, a.tt = nmd, t0 % nmd, int(free), tt
    a.ncmax = max(b.kin.shape[0] for b in baths)
    a.b0, a.ns, a.sub = b0, ns, sub
    a.dt, a.hdt, a.dt2h = dt, dt / 2.0, dt * dt / 2.0
    for i, b in enumerate(baths):
        a.baths[i] = _GleBath(b.noise.data_ptr(), st.Os[i].data_ptr(),
                              b.kinT.data_ptr(), b.K0.data_ptr(),
                              b.cids.data_ptr(), st.rings[i].data_ptr(),
                              b.kin.shape[0], b.kinT.shape[1])
    rc = build.load().gle_near_f32(
        ctypes.byref(a), torch.cuda.current_stream(st.p.device).cuda_stream)
    build.check(rc, "gle_near")
    launches_near += 1


def gle_far_cuda(baths, rings, Os, block: int, b0: int, ns: int):
    """One launch of the far-tap kernel for every bath, in place on
    ``Os``: the twin is ``gle_far_plain``."""
    global launches_far
    ntraj = Os[0].shape[0]
    for r, O in zip(rings, Os):
        if r.device.type != "cuda" or O.device != r.device or \
                r.dtype != torch.float32 or O.dtype != torch.float32 or \
                not (r.is_contiguous() and O.is_contiguous()) or \
                r.shape[0] != ntraj or O.shape[0] != ntraj:
            raise ValueError("gle_far: rings and O must be contiguous "
                             "float32 CUDA tensors of one trajectory count")
    if not 0 <= b0 < b0 + ns < block:
        raise ValueError(f"gle_far: sub-block [{b0}, {b0 + ns}) must end "
                         f"before the block's last step {block - 1}")
    a = _FarArgs()
    a.ntraj, a.block, a.b0, a.ns, a.nb = ntraj, block, b0, ns, len(baths)
    for i, (b, r, O) in enumerate(zip(baths, rings, Os)):
        a.baths[i] = _FarBath(b.kinT.data_ptr(), r.data_ptr(), O.data_ptr(),
                              b.kin.shape[0], b.kinT.shape[1])
    rc = build.load().gle_far_f32(
        ctypes.byref(a), torch.cuda.current_stream(Os[0].device).cuda_stream)
    build.check(rc, "gle_far")
    launches_far += 1


def gle_block_cuda(p, q, pf, dyn, mask, baths, t0: int, nmd: int,
                   dt: float, free: bool, block: int) -> BlockResult:
    """The block on the card: near-tap launches for the sub-blocks, a
    far-tap launch between each two."""
    ncmax = _check_cuda(p, q, pf, dyn, mask, baths, nmd, block)
    ntraj, nph = p.shape
    sub = sub_steps(block)
    tt = tile_size(ntraj, nph, len(baths), ncmax, sub, p.device)
    st = BlockState(p, q, pf, baths, block)
    subs = sub_blocks(block)
    for b0, ns in subs:
        gle_near_cuda(st, dyn, mask, baths, t0, nmd, dt, free, block, b0,
                      ns, sub, tt)
        if (b0, ns) != subs[-1]:
            gle_far_cuda(baths, st.rings, st.Os, block, b0, ns)
    return st.result()
