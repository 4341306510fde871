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

``gle_block`` launches the hand-written kernel (csrc/gle_block.cu) on
CUDA tensors and runs ``gle_block_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sclmd_tpu_torch.kernels import build
from sclmd_tpu_torch.ops.functions import matvec

launches = 0          # gle_block kernel launches (not twin calls)

MAX_BATHS = 4         # GLE_MAX_BATHS in csrc/gle_block.cu
THREADS = 512         # GLE_THREADS in csrc/gle_block.cu
SMEM_LIMIT = 227 * 1024


def reset_count():
    global launches
    launches = 0


class BathOperands(NamedTuple):
    """One non-local phonon bath's operands for one block."""
    noise: torch.Tensor   # (traj, nmd, nc) colored noise, row t at t mod nmd
    O: torch.Tensor       # (traj, block+1, nc) pre-block tails from K2
    kin: torch.Tensor     # (nc, (block+1)*nc) taps 1..block+1
    kinT: torch.Tensor    # kin as the kernel reads it (``tap_major``)
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
    """Plain torch twin, batched over the leading trajectory axis."""
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


class _GleBath(ctypes.Structure):
    _fields_ = [("noise", ctypes.c_void_p), ("O", ctypes.c_void_p),
                ("kinT", ctypes.c_void_p), ("K0", ctypes.c_void_p),
                ("cids", ctypes.c_void_p), ("ring", ctypes.c_void_p),
                ("nc", ctypes.c_int), ("ncs", ctypes.c_int)]


class _GleArgs(ctypes.Structure):
    _fields_ = [("p_in", ctypes.c_void_p), ("q_in", ctypes.c_void_p),
                ("pf_in", ctypes.c_void_p), ("p_out", ctypes.c_void_p),
                ("q_out", ctypes.c_void_p), ("pf_out", ctypes.c_void_p),
                ("qprev", ctypes.c_void_p), ("dyn", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("cur", ctypes.c_void_p),
                ("etot", ctypes.c_void_p),
                ("ntraj", ctypes.c_int), ("nph", ctypes.c_int),
                ("nb", ctypes.c_int), ("block", ctypes.c_int),
                ("nmd", ctypes.c_int), ("t0", ctypes.c_int),
                ("free_", ctypes.c_int), ("tt", ctypes.c_int),
                ("ncmax", ctypes.c_int),
                ("dt", ctypes.c_float), ("hdt", ctypes.c_float),
                ("dt2h", ctypes.c_float),
                ("baths", _GleBath * MAX_BATHS)]


def tile_size(ntraj: int, nph: int, nb: int, ncmax: int,
              device) -> int:
    """Trajectories per CTA: the largest of 4/2/1 that fits shared
    memory and still gives about 1.5 CTAs per SM. Larger tiles read the
    in-block kernel taps from L2 once for more trajectories, but on the
    H100 a CTA is bound by its own load latency and barriers, so the
    kernel needs CTAs in flight more than it needs L2 reuse
    (``tools/k1_sweep.py`` at the primary shapes on an H100 at 700 W:
    256 trajectories 86.8 ms per block at TT 1, 119.9 at TT 2, 141.3 at
    TT 4; 512 trajectories 208.4, 150.5, 169.1)."""
    lib = build.load()
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    for tt in (4, 2, 1):
        if lib.gle_block_smem_bytes(tt, nph, nb, ncmax) > SMEM_LIMIT:
            continue
        if tt == 1 or -(-ntraj // tt) >= (3 * nsm) // 2:
            return tt
    raise ValueError(f"gle_block: nph={nph}, nb={nb}, nc={ncmax} do not "
                     "fit in shared memory even at one trajectory per CTA")


def tap_major(kin: torch.Tensor, block: int) -> torch.Tensor:
    """kin (nc, (block+1)*nc) as the kernel reads it: (block+1, ncs, nc)
    with kinT[k, b, a] = kin[a, k*nc + b] and b zero-padded to ncs, a
    multiple of 4. Constant over a segment: build it once per segment."""
    nc = kin.shape[0]
    ncs = -(-nc // 4) * 4
    kt = kin.new_zeros((block + 1, ncs, nc))
    kt[:, :nc, :] = kin.view(nc, block + 1, nc).permute(1, 2, 0)
    return kt


def gle_block_cuda(p, q, pf, dyn, mask, baths, t0: int, nmd: int,
                   dt: float, free: bool, block: int) -> BlockResult:
    global launches
    dev = p.device
    if dev.type != "cuda":
        raise ValueError("gle_block: the kernel takes CUDA tensors")
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
            raise TypeError(f"gle_block: the CUDA kernel takes float32 "
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
    tt = tile_size(ntraj, nph, nb, ncmax, dev)

    p_out, q_out, pf_out, qprev = (torch.empty_like(p) for _ in range(4))
    rings = tuple(torch.empty((ntraj, block, b.kin.shape[0]),
                              dtype=torch.float32, device=dev)
                  for b in baths)
    cur = torch.empty((ntraj, block, nb), dtype=torch.float32, device=dev)
    etot = torch.empty((ntraj, block), dtype=torch.float32, device=dev)

    a = _GleArgs()
    a.p_in, a.q_in, a.pf_in = p.data_ptr(), q.data_ptr(), pf.data_ptr()
    a.p_out, a.q_out = p_out.data_ptr(), q_out.data_ptr()
    a.pf_out, a.qprev = pf_out.data_ptr(), qprev.data_ptr()
    a.dyn, a.mask = dyn.data_ptr(), mask.data_ptr()
    a.cur, a.etot = cur.data_ptr(), etot.data_ptr()
    a.ntraj, a.nph, a.nb, a.block = ntraj, nph, nb, block
    a.nmd, a.t0, a.free_, a.tt, a.ncmax = nmd, t0 % nmd, int(free), tt, ncmax
    a.dt, a.hdt, a.dt2h = dt, dt / 2.0, dt * dt / 2.0
    for i, b in enumerate(baths):
        a.baths[i] = _GleBath(b.noise.data_ptr(), b.O.data_ptr(),
                              b.kinT.data_ptr(), b.K0.data_ptr(),
                              b.cids.data_ptr(), rings[i].data_ptr(),
                              b.kin.shape[0], b.kinT.shape[1])
    lib = build.load()
    rc = lib.gle_block_f32(ctypes.byref(a),
                           torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "gle_block")
    launches += 1
    return BlockResult(p_out, q_out, pf_out, qprev, rings, cur, etot)


def gle_block(p, q, pf, dyn, mask, baths, t0: int, nmd: int, dt: float,
              free: bool, block: int) -> BlockResult:
    """Advance every trajectory through ``block`` steps starting at
    global step ``t0``: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors."""
    if p.device.type == "cpu":
        return gle_block_plain(p, q, pf, dyn, mask, baths, t0, nmd, dt,
                               free, block)
    return gle_block_cuda(p, q, pf, dyn, mask, baths, t0, nmd, dt, free,
                          block)
