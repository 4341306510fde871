"""GLE molecular dynamics engine (counterpart of ``sclmd_tpu.md``).

The trajectory batch is an explicit leading dimension everywhere: an
``MDState`` holds (traj, nph) velocities and displacements, and the
blocked integrator ``run_segment_blocked`` advances the whole batch.
Per block of ``block`` steps it calls kernel K2 (``block_corr``) once
per bath for the pre-block memory-kernel tails, then kernel K1
(``gle_block``) for the block's steps.

Step structure (the reference's 3-bath-eval / 2-potential-eval scheme):

    f0  = V'(q) + sum_b bforce_b(t)          (predictor)
    p_half = p + f0 dt/2 ;  q' = q + p dt + f0 dt^2/2
    cur_b  = f_b . p
    f1  = V'(q') + sum_b bforce_b(t+1, p_half)
    p1  = p_half + f1 dt/2
    f2  = V'(q') + sum_b bforce_b(t+1, p1)
    p'  = p_half + f2 dt/2 ;  constrain p', q'

Ported so far: the harmonic force (``dyn``) with non-local phonon baths
on the blocked path, and the ``md`` runner's fused ``RunEnsemble``.
Still to port (ROADMAP queue 1): ``vv_step``/``run_segment`` (the plain
scan), electron and local baths, force drivers, ``Run`` and the
checkpointed/segmented ``RunEnsemble``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.baths import PhBath
from sclmd_tpu_torch.kernels.gle_block import (BathOperands, gle_block,
                                               tap_major)
from sclmd_tpu_torch.ops.functions import bose, matvec


@dataclass
class MDState:
    t: torch.Tensor      # (traj,) int64 global step counter
    p: torch.Tensor      # (traj, nph) velocity (mass-weighted natural units)
    q: torch.Tensor      # (traj, nph) displacement
    phis: torch.Tensor   # (traj, ml, nph) newest-first velocity history
    qhis: torch.Tensor   # (traj, 1, nph) newest displacement

    def replace(self, **changes) -> "MDState":
        return replace(self, **changes)

    def select(self, i: int) -> "MDState":
        """Trajectory ``i`` as a batch of one."""
        return MDState(*(x[i:i + 1] for x in
                         (self.t, self.p, self.q, self.phis, self.qhis)))


@dataclass
class GLESystem:
    """Everything the step needs: harmonic force ``-dyn q``, the baths,
    the constraint mask and the static run parameters."""

    dyn: torch.Tensor            # (nph, nph)
    baths: tuple                 # PhBath, each with (traj, nmd, nc) noise
    mask: torch.Tensor           # (nph,) 1.0 = free, 0.0 = constrained
    dt: float
    nph: int
    ml: int
    nmd: int
    # promise that ``mask`` is identically 1: the predictor force at
    # q_{t+1} then equals the last corrector force at q_tt, so each step
    # needs one fresh potential evaluation instead of two
    unconstrained: bool = False

    def replace(self, **changes) -> "GLESystem":
        return replace(self, **changes)

    def potential_force(self, q: torch.Tensor) -> torch.Tensor:
        return -matvec(self.dyn, q)


def initial_state(system: GLESystem, ntraj: int = 1,
                  dtype=None) -> MDState:
    """Zero state for ``ntraj`` trajectories."""
    nph, ml = system.nph, system.ml
    dtype = dtype or system.dyn.dtype
    dev = system.dyn.device
    z = torch.zeros((ntraj, nph), dtype=dtype, device=dev)
    return MDState(t=torch.zeros((ntraj,), dtype=torch.long, device=dev),
                   p=z, q=z.clone(),
                   phis=torch.zeros((ntraj, ml, nph), dtype=dtype, device=dev),
                   qhis=torch.zeros((ntraj, 1, nph), dtype=dtype, device=dev))


def thermal_init(u: torch.Tensor, system: GLESystem, hw, evecs, T,
                 freq_cut: float = 0.01) -> MDState:
    """Bose-weighted random initial conditions from the normal modes.

    ``u`` (traj, nm) are the uniform draws of the random phases. Each
    mode with hw_i >= freq_cut gets amplitude
    sqrt(2 (n_B(hw_i, T) + 1/2) / hw_i); constrained DOFs are zeroed.
    The amplitudes are setup quantities, computed on the host in float64.
    """
    hw_np = np.asarray(hw.cpu() if torch.is_tensor(hw) else hw, np.float64)
    safe_hw = np.where(hw_np < freq_cut, 1.0, hw_np)
    am_np = np.where(hw_np < freq_cut, 0.0,
                     np.sqrt((bose(safe_hw, T) + 0.5) * 2.0 / safe_hw))
    dtype, dev = u.dtype, u.device
    am = torch.as_tensor(am_np, dtype=dtype, device=dev)
    hw_t = torch.as_tensor(hw_np, dtype=dtype, device=dev)
    ev = torch.as_tensor(evecs, dtype=dtype, device=dev)
    dis = matvec(ev, am * torch.cos(2 * np.pi * u))
    vel = -matvec(ev, hw_t * am * torch.sin(2 * np.pi * u))
    st = initial_state(system, u.shape[0], dtype=dtype)
    return st.replace(p=vel * system.mask, q=dis * system.mask)


def set_dyn(dyn, dtype=torch.float64, device=None):
    """Symmetrise, clamp negative modes, return (dyn, hw, U) as tensors.

    Host numpy float64 (a device f32 eigh + rebuild of a stiff matrix
    leaves negative leakage that grows over long runs); cast to
    ``dtype`` at the end."""
    dyn = np.asarray(dyn, np.float64)
    dyn = (dyn + dyn.T) / 2
    av, au = np.linalg.eigh(dyn)
    av = np.clip(av, 0.0, None)
    hw = np.sqrt(av)
    dyn = (au * av[None, :]) @ au.T
    return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                 for x in (dyn, hw, au))


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _check_blocked(system: GLESystem, ntraj: int):
    for b in system.baths:
        if not isinstance(b, PhBath) or b.ml <= 1:
            raise NotImplementedError(
                "run_segment_blocked: only non-local phonon baths (ml > 1) "
                "are ported; electron and local baths wait for the plain "
                "step (ROADMAP queue 1 items 3-4)")
        if b.noise is None or b.noise.ndim != 3 or \
                b.noise.shape != (ntraj, system.nmd, b.nc):
            raise ValueError(
                "run_segment_blocked: each bath needs a (traj, nmd, nc) "
                f"noise batch for {ntraj} trajectories")


def run_segment_blocked(system: GLESystem, state: MDState, nsteps: int,
                        t0: int = 0, block: int = 64):
    """Advance the batch ``nsteps`` steps with the blocked memory-kernel
    convolution; returns (final_state, {"etot": (traj, nsteps),
    "cur": (traj, nsteps, nb)}).

    Per block: the pre-block part of the friction convolution (taps
    j > s) is ONE FFT cross-correlation of the kernel with the (ml-1, nc)
    history (K2), the in-block part (taps j <= s) runs against the
    (block, nc) ring inside K1, and the history advances once per block.
    ``t0`` is the segment's global step offset (noise rows at t mod nmd).
    """
    if nsteps % block:
        raise ValueError(f"nsteps={nsteps} must be a multiple of "
                         f"block={block}")
    ntraj = state.p.shape[0]
    _check_blocked(system, ntraj)
    nmd, dt = system.nmd, system.dt
    dev, dtype = state.p.device, state.p.dtype
    t0 = t0 % nmd

    plans, hists = [], []
    for b in system.baths:
        nfft = _next_pow2(b.ml + block + 2)
        kpad = torch.nn.functional.pad(b.kernel, (0, 0, 0, 0, 0, nfft - b.ml))
        kin = b.block_tap_kernel(block)
        plans.append({
            "khat": torch.fft.rfft(kpad, dim=0).contiguous(),
            "nfft": nfft,
            "kin": kin,
            "kinT": tap_major(kin, block),
            "K0": b.kernel[0].contiguous(),
            "cids": torch.as_tensor(b.cids, dtype=torch.int32, device=dev),
        })
        hists.append(state.phis[:, :b.ml - 1, b.cols])

    free = system.unconstrained
    p, q = state.p.contiguous(), state.q.contiguous()
    pf = system.potential_force(q) if free else torch.zeros_like(p)
    qprev = state.qhis[:, 0]
    curs, etots = [], []
    for ib in range(nsteps // block):
        ops = []
        for b, plan, hist in zip(system.baths, plans, hists):
            O = b.block_corr(hist, block, plan["khat"], plan["nfft"])
            ops.append(BathOperands(b.noise, O.contiguous(), plan["kin"],
                                    plan["kinT"], plan["K0"], b.cols,
                                    plan["cids"]))
        res = gle_block(p, q, pf, system.dyn, system.mask, ops,
                        (t0 + ib * block) % nmd, nmd, dt, free, block)
        p, q, pf, qprev = res.p, res.q, res.pf, res.qprev
        hists = [torch.cat([ring, hist], dim=1)[:, :b.ml - 1]
                 for ring, hist, b in zip(res.rings, hists, system.baths)]
        curs.append(res.cur)
        etots.append(res.etot)

    # a plain-path-compatible history: columns outside the bath DOFs are
    # never read by any force rule
    phis = torch.zeros((ntraj, system.ml, system.nph), dtype=dtype,
                       device=dev)
    for b, hist in zip(system.baths, hists):
        phis[:, :b.ml - 1, b.cols] = hist
    final = MDState(t=state.t + nsteps, p=p, q=q, phis=phis,
                    qhis=qprev.unsqueeze(1))
    return final, {"etot": torch.cat(etots, dim=1),
                   "cur": torch.cat(curs, dim=1)}


class md:
    """User-facing MD runner with the JAX package's constructor and
    method names (the parts the ensemble path needs)."""

    def __init__(self, dt, nmd, T, syslist=None, axyz=None, dyn=None,
                 nstart=0, nstop=1, npie=1, md2ang=U.MD2ANG,
                 dtype=torch.float32, seed=1234, outdir=".", block=None,
                 device=None):
        self.dt, self.nmd, self.T = float(dt), int(nmd), float(T)
        self.nstart, self.nstop, self.npie = int(nstart), int(nstop), int(npie)
        self.block = None if block is None else int(block)
        self.md2ang = md2ang
        self.dtype = dtype
        self.device = torch.device(device if device is not None else "cpu")
        self.outdir = outdir
        self.seed = int(seed)
        self._ensemble_calls = 0
        self.constraint = None
        self.initranvel = True
        self.state = None

        self.SetXyz(axyz)
        if syslist is not None:
            syslist = np.asarray(syslist, dtype=np.int64)
            if (len(syslist) > self.nta or syslist.min() < 0
                    or syslist.max() > self.nta - 1):
                raise ValueError("syslist out of range")
            self.syslist = syslist
            self.na = len(syslist)
            self.nph = 3 * self.na
        elif axyz is not None:
            self.syslist = np.arange(len(axyz))
            self.na = len(self.syslist)
            self.nph = 3 * self.na
        else:
            self.syslist, self.na, self.nph = None, None, None

        self.ml = 1
        self.baths = []
        self.setDyn(dyn)

    def SetXyz(self, axyz):
        if axyz is not None:
            self.xyz = np.array([a[1:] for a in axyz], dtype=float).flatten()
            self.els = [a[0] for a in axyz]
            self.nta = len(axyz)
        else:
            self.xyz, self.els, self.nta = None, None, None

    def setDyn(self, dyn=None):
        if dyn is not None:
            n = np.asarray(dyn).shape[0]
            if self.nph is not None and self.nph != n:
                raise ValueError("dynamical matrix dimension mismatch")
            self.nph = n
            d, hw, evecs = set_dyn(dyn, dtype=self.dtype, device=self.device)
            self.dyn = d
            self.hw = hw.cpu().numpy()
            self.U = evecs
        else:
            self.dyn = None
            self.hw = np.array([1.0])
            self.U = None

    def AddBath(self, bath: PhBath):
        if self.dt != bath.dt:
            raise ValueError("md.AddBath: time step dt not consistent")
        if self.nmd != bath.nmd:
            raise ValueError("md.AddBath: nmd not consistent")
        self.baths.append(bath.to(self.device))
        self.ml = max(self.ml, bath.ml)

    def AddConstr(self, constr):
        self.constraint = constr

    def _constraint_mask(self) -> torch.Tensor:
        mask = np.ones(self.nph, dtype=np.float64)
        if self.constraint is not None:
            for grp in self.constraint:
                mask[np.asarray(list(grp), dtype=np.int64)] = 0.0
        return torch.as_tensor(mask, dtype=self.dtype, device=self.device)

    def _build_system(self) -> GLESystem:
        if self.dyn is None:
            raise ValueError("no driver, no md: the port runs the harmonic "
                             "force from dyn (force drivers: ROADMAP queue "
                             "1 item 7)")
        return GLESystem(
            dyn=self.dyn, baths=tuple(self.baths),
            mask=self._constraint_mask(),
            dt=self.dt, nph=self.nph, ml=self.ml, nmd=self.nmd,
            unconstrained=self.constraint is None or not self.constraint)

    def Run(self):
        raise NotImplementedError(
            "md.Run (segmented runs with MD{j} checkpoints) is not ported "
            "yet (ROADMAP queue 1 item 5); use RunEnsemble")

    def RunEnsemble(self, ntraj: int, nsteps: Optional[int] = None,
                    equil_frac: float = 0.25, block: Optional[int] = None,
                    npie: Optional[int] = None, checkpoint: bool = False,
                    chunk: Optional[int] = None):
        """Run ``ntraj`` independent trajectories; returns the
        per-trajectory mean bath currents (ntraj, nbaths) after skipping
        the first ``equil_frac`` of the steps, and writes the
        kappa.T.bathI.runJ.dat files.

        Chunks of ``chunk`` trajectories (default: ``auto_chunk`` from
        the card's memory) run one after another, each synthesising only
        its own noise. Every draw comes from a generator keyed by (seed,
        stream, trajectory index), so the draws do not depend on the
        chunking.
        """
        from sclmd_tpu_torch.parallel.ensemble import (
            auto_chunk, bath_factors, draw_chunk, ensemble_seed,
            fused_chunk)

        nsteps = nsteps or self.nmd
        npie = npie or 1
        if checkpoint or npie != 1:
            raise NotImplementedError(
                "RunEnsemble: the checkpointed and segmented (npie > 1) "
                "branches are not ported yet (ROADMAP queue 1 item 5)")
        block = block if block is not None else self.block
        if not block or nsteps % block:
            raise ValueError(
                f"RunEnsemble: nsteps={nsteps} needs a block size that "
                f"divides it (got block={block}); the plain scan it would "
                "fall back to is not ported yet")
        system = self._build_system()
        nb = len(self.baths)
        skip = int(nsteps * equil_frac)
        if chunk is None:
            chunk = auto_chunk(system, ntraj, nsteps, block, depth=2)
        chunk = max(1, min(int(chunk), ntraj))

        self._ensemble_calls += 1
        seed = ensemble_seed(self.seed, self._ensemble_calls)
        thermal = self.initranvel
        facs = bath_factors(self.baths, self.device)
        cur_sum = np.zeros((ntraj, nb))
        cur_cnt = nsteps - min(skip, nsteps)
        pending = []

        def drain(item):
            d0, d1, dic, dsum, dok = item
            if not bool(dok):
                raise FloatingPointError(
                    f"RunEnsemble: non-finite heat currents in chunk {dic} "
                    "- reduce dt or check the force driver")
            cur_sum[d0:d1] += dsum.double().cpu().numpy()

        first = None
        for ic in range(-(-ntraj // chunk)):
            c0, c1 = ic * chunk, min((ic + 1) * chunk, ntraj)
            rs, us = draw_chunk(facs, seed, c0, c1, self.nph if thermal
                                else None, self.device, self.dtype)
            finals, sums, ok = fused_chunk(
                system, facs, rs, us, self.hw, self.U, self.T, nsteps, 0,
                block, min(skip, nsteps))
            # read a chunk's sums back only after the next chunk's host-side
            # draws and launches: those then overlap this chunk on the card
            # (reading them at once would leave the card idle meanwhile)
            pending.append((c0, c1, ic, sums, ok))
            while len(pending) > 1:
                drain(pending.pop(0))
            if first is None:
                first = finals.select(0)
        for item in pending:
            drain(item)
        means = cur_sum / max(cur_cnt, 1)
        self._write_kappa_files(ntraj, nb, means)
        self.state = first
        return means

    def _write_kappa_files(self, ntraj, nb, means):
        """Per-trajectory kappa.T.bathI.runJ.dat files, the format the
        calHF/calTC aggregators read."""
        for jtraj in range(ntraj):
            for ii in range(nb):
                path = os.path.join(
                    self.outdir, f"kappa.{self.T:g}.bath{ii}.run{jtraj}.dat")
                with open(path, "w") as f:
                    f.write("%i %f    %f \n" % (
                        jtraj, self.T, means[jtraj, ii] * U.CURCOF))
