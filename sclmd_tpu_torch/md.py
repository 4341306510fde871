"""GLE molecular dynamics engine (counterpart of ``sclmd_tpu.md``).

The trajectory batch is an explicit leading dimension everywhere: an
``MDState`` holds (traj, nph) velocities and displacements, and both
integrators advance the whole batch:

* ``run_segment``, the plain step (any mix of electron, local and
  memory-kernel phonon baths): per step kernel K6 (``conv_tails``) for
  the memory-kernel tails shared by the step's three bath-force
  evaluations, and kernel K7 (``bath_force``) for each evaluation; the
  potential force is a force driver's (``force_fn``: for the C/H
  junction kernel K5, ``ch_force``, twice a step) or the harmonic
  ``-dyn q``, a ``torch.matmul``. The velocity history
  is a circular ring with a head index, turned back into the newest-first
  ``phis`` only at the segment's end. On the card the steps after the
  first run as a CUDA graph of ``kernels.step_graph.GRAPH_STEPS``
  steps, captured once a segment and replayed (``graph_plan`` says
  where).
* ``run_segment_blocked``, the blocked memory-kernel convolution
  (non-local phonon baths only): per block of ``block`` steps kernel K2
  (``block_corr``) once per bath for the pre-block tails, then kernel K1
  (``gle_block``) for the block's steps: sub-blocks of near-tap steps
  with far-tap GEMMs between them.

Step structure (the reference's 3-bath-eval / 2-potential-eval scheme):

    f0  = V'(q) + sum_b bforce_b(t)          (predictor)
    p_half = p + f0 dt/2 ;  q' = q + p dt + f0 dt^2/2
    cur_b  = f_b . p
    f1  = V'(q') + sum_b bforce_b(t+1, p_half)
    p1  = p_half + f1 dt/2
    f2  = V'(q') + sum_b bforce_b(t+1, p1)
    p'  = p_half + f2 dt/2 ;  constrain p', q'

Ported so far: the harmonic force (``dyn``) and force drivers
(``AddPotential``, ``CompareForce``), both integrators, the ``md``
runner's ``Run`` (segments, ``MD{j}.npz`` checkpoints with the JAX
package's keys and shapes, so either package resumes the other's
checkpoints) and ``RunEnsemble`` (``steady_init``, segments, and
``MDE.npz`` checkpoints with the JAX package's keys), and the
periodic warm start (``steady_mode_temps``, ``state_ravel``/
``state_unravel`` in the JAX order, ``gle_step_jacobian``,
``period_power``, ``fixed_point_solver``, ``periodic_fixed_point``). A
system with a force driver takes the plain step: K1 fuses the harmonic
force into its recurrence. Random draws come from the counter-keyed
Philox schedule of ``parallel.ensemble`` (kernels K3 and K3b on the
card), so they are not the JAX package's draws; tests inject the same
noise into both. Still to port (ROADMAP queue 1): traced
``force_params``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.baths import PhBath
from sclmd_tpu_torch.kernels import step_graph
from sclmd_tpu_torch.kernels.bath_force import BathForce
from sclmd_tpu_torch.kernels.conv_tails import conv_tails_plan, tail_baths
from sclmd_tpu_torch.kernels.gle_block import (BathOperands, gle_block,
                                               tap_major)
from sclmd_tpu_torch.ops.functions import bose, matvec, powerspecp
from sclmd_tpu_torch.utils import profiling


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
    """Everything the step needs: the potential force (a driver's
    ``force_fn``, else the harmonic ``-dyn q``), the baths, the
    constraint mask and the static run parameters."""

    dyn: Optional[torch.Tensor]  # (nph, nph), or None with a force_fn
    baths: tuple                 # EBath/PhBath, each with (traj, nmd, nc) noise
    mask: torch.Tensor           # (nph,) 1.0 = free, 0.0 = constrained
    dt: float
    nph: int
    ml: int
    nmd: int
    # promise that ``mask`` is identically 1: the predictor force at
    # q_{t+1} then equals the last corrector force at q_tt, so each step
    # needs one fresh potential evaluation instead of two
    # (blocked path only; the plain path evaluates the force twice)
    unconstrained: bool = False
    # per-step outputs of the plain path: "ps", "qs", and "fbaths"/"f"
    savep: bool = False
    saveq: bool = False
    savef: bool = False
    # a force driver's batched q (traj, nph) -> force (traj, nph); taken
    # instead of -dyn q (never added to it)
    force_fn: Optional[Callable] = None
    # a second driver's force, compared with the harmonic one: the plain
    # path's "cf" output is cf_fn(q) + dyn q
    cf_fn: Optional[Callable] = None

    def replace(self, **changes) -> "GLESystem":
        return replace(self, **changes)

    @functools.cached_property
    def neg_dyn_t(self) -> torch.Tensor:
        """``-dyn.T``, made once per system: the plain step asks for the
        force twice a step, and the host's time per step is what bounds
        it, so the sign is not a kernel of its own each time."""
        return (-self.dyn).T

    def potential_force(self, q: torch.Tensor) -> torch.Tensor:
        """The force driver's force if one is attached, else -dyn q per
        trajectory: one GEMM on the card; on the CPU the batch-invariant
        ``matvec`` (see ops.functions)."""
        if self.force_fn is not None:
            return self.force_fn(q)
        if self.dyn is None:
            raise ValueError("no driver, no md")
        if q.device.type == "cuda":
            return torch.mm(q, self.neg_dyn_t)
        return -matvec(self.dyn, q)


def initial_state(system: GLESystem, ntraj: int = 1,
                  dtype=None) -> MDState:
    """Zero state for ``ntraj`` trajectories."""
    nph, ml = system.nph, system.ml
    dtype = dtype or system.mask.dtype
    dev = system.mask.device
    z = torch.zeros((ntraj, nph), dtype=dtype, device=dev)
    return MDState(t=torch.zeros((ntraj,), dtype=torch.long, device=dev),
                   p=z, q=z.clone(),
                   phis=torch.zeros((ntraj, ml, nph), dtype=dtype, device=dev),
                   qhis=torch.zeros((ntraj, 1, nph), dtype=dtype, device=dev))


def mode_amplitudes(hw, T, freq_cut: float = 0.01):
    """Host float64 (am, hw) of the thermal start: each mode with
    hw_i >= freq_cut gets amplitude sqrt(2 (n_B(hw_i, T) + 1/2) / hw_i),
    the others 0; ``T`` a scalar or a per-mode array."""
    hw_np = np.asarray(hw.cpu() if torch.is_tensor(hw) else hw, np.float64)
    safe_hw = np.where(hw_np < freq_cut, 1.0, hw_np)
    am_np = np.where(hw_np < freq_cut, 0.0,
                     np.sqrt((bose(safe_hw, T) + 0.5) * 2.0 / safe_hw))
    return am_np, hw_np


def thermal_init(u: torch.Tensor, system: GLESystem, hw, evecs, T,
                 freq_cut: float = 0.01) -> MDState:
    """Bose-weighted random initial conditions from the normal modes.

    ``u`` (traj, nm) are the uniform draws of the random phases. Each
    mode with hw_i >= freq_cut gets amplitude
    sqrt(2 (n_B(hw_i, T) + 1/2) / hw_i); constrained DOFs are zeroed.
    The amplitudes are setup quantities, computed on the host in float64.
    The runners take ``ThermalStart`` instead, which draws ``u`` itself.
    """
    am_np, hw_np = mode_amplitudes(hw, T, freq_cut)
    dtype, dev = u.dtype, u.device
    am = torch.as_tensor(am_np, dtype=dtype, device=dev)
    hw_t = torch.as_tensor(hw_np, dtype=dtype, device=dev)
    ev = torch.as_tensor(evecs, dtype=dtype, device=dev)
    dis = matvec(ev, am * torch.cos(2 * np.pi * u))
    vel = -matvec(ev, hw_t * am * torch.sin(2 * np.pi * u))
    st = initial_state(system, u.shape[0], dtype=dtype)
    return st.replace(p=vel * system.mask, q=dis * system.mask)


class ThermalStart:
    """The thermal start at one temperature, its constants made once on
    the device: the mode amplitudes ``am`` and frequencies ``hw`` (host
    float64, then cast) and the eigenvectors. ``states`` draws the phases
    of a trajectory window on the schedule and makes the mode-space
    amplitudes (K3b on the card, one launch) and their product with the
    eigenvectors (one ``torch.matmul`` on the card; on the CPU the
    batch-invariant ``matvec``, bitwise ``thermal_init`` on the same
    uniforms): no host-device copy per window."""

    def __init__(self, hw, evecs, T, dtype, device, freq_cut: float = 0.01):
        am, hw_np = mode_amplitudes(hw, T, freq_cut)
        self.am = torch.as_tensor(am, dtype=dtype, device=device)
        self.hw = torch.as_tensor(hw_np, dtype=dtype, device=device)
        self.evecs = torch.as_tensor(evecs, dtype=dtype, device=device)
        self.evecs_t = self.evecs.T.contiguous()

    def project(self, amps: torch.Tensor, system: GLESystem) -> MDState:
        """The state of mode-space amplitudes (2, traj, nm): q from the
        first, p from the second, constrained DOFs zeroed."""
        if amps.device.type == "cuda":
            ds = torch.matmul(amps, self.evecs_t)
        else:
            ds = matvec(self.evecs, amps)
        st = initial_state(system, amps.shape[1], dtype=amps.dtype)
        return st.replace(p=ds[1] * system.mask, q=ds[0] * system.mask)

    def states(self, system: GLESystem, seed: int, stream: int, lo: int,
               hi: int) -> MDState:
        """Initial states of trajectories [lo, hi) on the schedule's
        stream ``stream`` (the number of baths)."""
        from sclmd_tpu_torch.kernels import noise_synth as K3
        return self.project(
            K3.thermal_amplitudes(seed, stream, lo, hi, self.am, self.hw),
            system)


def set_dyn(dyn, dtype=torch.float64, device=None):
    """Symmetrise, clamp negative modes, return (dyn, hw, U) as tensors.

    Host numpy float64 (a device f32 eigh + rebuild of a stiff matrix
    leaves negative leakage that grows over long runs); cast to
    ``dtype`` at the end, on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    with profiling.span("setup/thermal_start"):
        dyn = np.asarray(dyn, np.float64)
        dyn = (dyn + dyn.T) / 2
        av, au = np.linalg.eigh(dyn)
        av = np.clip(av, 0.0, None)
        hw = np.sqrt(av)
        dyn = (au * av[None, :]) @ au.T
    return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                 for x in (dyn, hw, au))


def steady_mode_temps(evecs, baths, T, hw=None):
    """Coupling-weighted steady-state temperature per normal mode (the
    JAX package's ``steady_mode_temps``, copied; host numpy).

    T_i = sum_b g_bi T_b / sum_b g_bi with g_bi = s_b(hw_i) sum_{d in b}
    U[d, i]^2, s_b the bath's mean diagonal friction (an electron bath's
    efric; a phonon bath's Gamma(w) diagonal at the mode frequency when
    ``hw`` is given). Modes with negligible total coupling keep ``T``.
    Equal bath temperatures return that temperature exactly, so
    ``RunEnsemble(steady_init=True)`` then repeats the uniform start
    bitwise."""
    U_ = np.asarray(evecs.cpu() if torch.is_tensor(evecs) else evecs,
                    np.float64)
    nm = U_.shape[1]
    temps = [float(b.T) for b in baths]
    if temps and all(t == temps[0] for t in temps):
        return np.full(nm, temps[0])
    num = np.zeros(nm)
    den = np.zeros(nm)
    for b in baths:
        proj = (U_[np.asarray(b.cids), :] ** 2).sum(axis=0)
        if getattr(b, "efric", None) is not None:
            g = float(np.mean(np.diag(_host(b.efric)))) * proj
        elif getattr(b, "gamma", None) is not None:
            gam = np.asarray(b.gamma, np.float64)
            gwl = np.asarray(b.gwl, np.float64)
            sdiag = np.einsum("wii->w", gam) / gam.shape[1]
            if hw is None:
                g = float(sdiag.mean()) * proj
            else:
                w = np.clip(np.abs(np.asarray(hw, np.float64)),
                            gwl[0], gwl[-1])
                g = np.interp(w, gwl, sdiag) * proj
        else:
            g = proj
        num += g * float(b.T)
        den += g
    tol = 1e-8 * max(float(den.max()), 1e-300)
    safe = np.where(den > tol, den, 1.0)
    return np.where(den > tol, num / safe, float(T))


def state_ravel(st: MDState) -> np.ndarray:
    """The batch of states as host rows [p, q, phis, qhis] (the JAX
    package's order): (traj, (3 + ml) nph)."""
    n = st.p.shape[0]
    return _host(torch.cat([st.p, st.q, st.phis.reshape(n, -1),
                            st.qhis.reshape(n, -1)], dim=1))


def state_unravel(x, system: GLESystem, dtype=None) -> MDState:
    """Inverse of ``state_ravel``, on the system's device; a single
    (n,) vector gives a batch of one."""
    nph, ml = system.nph, system.ml
    dtype = dtype or system.mask.dtype
    x = torch.as_tensor(np.asarray(x), device=system.mask.device)
    x = x.reshape(-1, x.shape[-1]).to(dtype)
    n = x.shape[0]
    return MDState(
        t=torch.zeros((n,), dtype=torch.long, device=x.device),
        p=x[:, :nph].contiguous(), q=x[:, nph:2 * nph].contiguous(),
        phis=x[:, 2 * nph:(2 + ml) * nph].reshape(n, ml, nph).contiguous(),
        qhis=x[:, (2 + ml) * nph:].reshape(n, 1, nph).contiguous())


def gle_step_jacobian(system: GLESystem) -> np.ndarray:
    """Host float64 one-step Jacobian A of the plain GLE step at zero
    noise, in the ``state_ravel`` basis (``ops.exact_gle.linearize_step``:
    the basis states stepped once through ``run_segment``). For a
    harmonic system the step is affine, so A is exact."""
    from sclmd_tpu_torch.ops.exact_gle import linearize_step
    return linearize_step(system)


def period_power(A, nperiod: int, device=None) -> np.ndarray:
    """A^nperiod by binary powering, in float64: numpy on the host, or
    torch on ``device`` (a CUDA card's float64 GEMMs); returns numpy."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cpu":
        base = torch.as_tensor(np.asarray(A, np.float64), device=dev)
        power = torch.eye(base.shape[0], dtype=torch.float64, device=dev)
    else:
        base = np.asarray(A, np.float64)
        power = np.eye(base.shape[0])
    k = int(nperiod)
    while k:
        if k & 1:
            power = power @ base
        k >>= 1
        if k:
            base = base @ base
    return _host(power) if torch.is_tensor(power) else power


def fixed_point_solver(power, tol: float = 1e-8):
    """x1 -> x* = (I - A^P)^+ x1, the least-squares point of the discrete
    periodic attractor of a noise period, with c = x1 the end-of-period
    state of a zero-start run ((n,) or (batch, n), ``state_ravel``
    order). The pseudo-inverse is formed once (one SVD, host float64) for
    every batch and direction of a system; singular values at or below
    ``tol`` times the largest are dropped (undamped modes
    near-commensurate with the period), as the JAX package's
    ``lstsq(rcond=tol)`` drops them."""
    P = np.asarray(power, np.float64)
    pinv = np.linalg.pinv(np.eye(P.shape[0]) - P, rcond=tol)

    def solve(x1):
        x1 = np.asarray(x1, np.float64)
        return x1 @ pinv.T if x1.ndim == 2 else pinv @ x1

    return solve


def periodic_fixed_point(A, x1, nperiod: int, tol: float = 1e-8,
                         power=None):
    """Initial state(s) on the discrete periodic attractor: one
    ``fixed_point_solver`` solve of ``x1``, with ``power`` = A^nperiod
    computed here when not given. The JAX package's
    ``periodic_fixed_point``."""
    if power is None:
        power = period_power(A, nperiod)
    return fixed_point_solver(power, tol)(x1)


def _check_noise(system: GLESystem, ntraj: int, who: str):
    for b in system.baths:
        if b.noise is None or b.noise.ndim != 3 or \
                b.noise.shape != (ntraj, system.nmd, b.nc):
            raise ValueError(
                f"{who}: each bath needs a (traj, nmd, nc) noise batch for "
                f"{ntraj} trajectories")


def graph_plan(system: GLESystem, state: MDState, nsteps: int) -> tuple:
    """(lead, replays, tail) of ``run_segment``'s steps
    (``kernels.step_graph.group_plan``), or (nsteps, 0, 0): every step
    eager. The steps replay as a CUDA graph only where the code can see
    that a replay does what the eager steps do: on the card, with no
    per-step write left on the host (``cf_fn``, ``savef``'s scatter) and
    with the harmonic ``torch.mm`` or a force driver that declares itself
    capturable (``capturable``: its card force launches kernels only, no
    host sync); and where the segment holds a whole group after its
    first step."""
    fn = system.force_fn
    if (state.p.device.type != "cuda" or system.cf_fn is not None or
            system.savef or (fn is not None and not getattr(
                getattr(fn, "__self__", None), "capturable", False))):
        return nsteps, 0, 0
    return step_graph.group_plan(nsteps)


def run_segment(system: GLESystem, state: MDState, nsteps: int,
                t0: int = 0):
    """Advance the batch ``nsteps`` plain GLE steps; returns
    (final_state, outputs) with "etot" (traj, nsteps), "cur" (traj,
    nsteps, nb) and, as the system's save flags ask, "ps"/"qs" (traj,
    nsteps, nph) (the state at each step's start), "fbaths" (traj,
    nsteps, nb, nph) (the predictor bath forces) and "f" (traj, nsteps,
    nph) (the last corrector's total force); with a ``cf_fn``, "cf"
    (traj, nsteps, nph): the compared driver's force plus ``dyn q`` at
    each step's start.

    ``t0`` is the segment's global step offset: step s reads noise row
    (t0+s) mod nmd for the predictor and (t0+s+1) mod nmd for the
    correctors, so a segment longer than nmd wraps. The velocity history
    is a ring: old[i] = ring[:, (head+i) % ml] with head = -s mod ml at
    step s, and each step's push writes one row instead of shifting all
    of them. On the card the kernels read s from a step word
    (``kernels.step_graph``), and where ``graph_plan`` allows it the
    steps after the first run as a captured CUDA graph replayed in
    groups; the outputs are the same bits either way.
    """
    ntraj, nph = state.p.shape
    _check_noise(system, ntraj, "run_segment")
    nmd, dt, nb = system.nmd, system.dt, len(system.baths)
    dev, dtype = state.p.device, state.p.dtype
    t0 = t0 % nmd
    if nsteps == 0:
        return state, {"etot": state.p.new_zeros((ntraj, 0)),
                       "cur": state.p.new_zeros((ntraj, 0, nb))}

    plan = graph_plan(system, state, nsteps)
    word = step_graph.StepWord(dev, base=plan[0] if plan[1] else 0) \
        if dev.type == "cuda" else None
    ring = state.phis.contiguous().clone()
    tidx = tail_baths(system.baths)
    tails_of = conv_tails_plan(ring, [system.baths[i] for i in tidx],
                               word) if tidx else None
    force = BathForce(system.baths, ntraj, nph, nmd, dt, dev, t0=t0,
                      word=word)

    def buf(*shape):
        return torch.empty((ntraj, nsteps) + shape, dtype=dtype, device=dev)

    ys = {"etot": buf(), "cur": buf(nb)}
    if system.savep:
        ys["ps"] = buf(nph)
    if system.saveq:
        ys["qs"] = buf(nph)
    fbs = f_last = None
    if system.savef:
        ys["fbaths"] = buf(nb, nph).zero_()
        ys["f"] = buf(nph)
        fbs = [torch.empty((ntraj, b.nc), dtype=dtype, device=dev)
               for b in system.baths]
        f_last = torch.empty((ntraj, nph), dtype=dtype, device=dev)
    if system.cf_fn is not None:
        ys["cf"] = buf(nph)

    p, q = state.p.contiguous(), state.q.contiguous()
    qprev = state.qhis[:, 0]
    tails = [None] * nb

    def step(s):
        nonlocal p, q, qprev
        if system.cf_fn is not None:
            ys["cf"][:, s] = system.cf_fn(q) + matvec(system.dyn, q)
        if tails_of is not None:
            for i, tl in zip(tidx, tails_of(s)):
                tails[i] = tl
        pthalf, qtt = force.pred(p, q, system.potential_force(q), ring, s,
                                 tails, ys["cur"], ys["etot"], fbs,
                                 ps=ys.get("ps"), qs=ys.get("qs"))
        pf2 = system.potential_force(qtt)
        ptt1, _ = force.corr(pthalf, qtt, pf2, p, pthalf, tails, s)
        pnew, qnew = force.corr(ptt1, qtt, pf2, p, pthalf, tails, s,
                                mask=system.mask, f_out=f_last)
        if system.savef:
            ys["f"][:, s] = f_last
            for i, b in enumerate(system.baths):
                ys["fbaths"][:, s, i, b.cols] = fbs[i]
        qprev, p, q = q, pnew, qnew

    step_graph.run_steps(step, nsteps, plan, word, dev)
    final = MDState(t=state.t + nsteps, p=p, q=q,
                    phis=torch.roll(ring, nsteps % ring.shape[1], dims=1),
                    qhis=qprev.unsqueeze(1))
    return final, ys


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _check_blocked(system: GLESystem, ntraj: int):
    for b in system.baths:
        if not isinstance(b, PhBath) or b.ml <= 1:
            raise NotImplementedError(
                "run_segment_blocked: only non-local phonon baths (ml > 1) "
                "are ported to K1; electron and local baths take the plain "
                "step, run_segment (ROADMAP queue 1 item 7)")
    _check_noise(system, ntraj, "run_segment_blocked")


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




def blocked_supports(system: GLESystem) -> bool:
    """True when ``run_segment_blocked`` runs this system: non-local
    phonon baths only (K1 has no electron or local rule yet), the
    harmonic force (K1 fuses ``-dyn q`` into its recurrence, so a force
    driver takes the plain step) and no per-step outputs beyond etot and
    cur."""
    return (all(isinstance(b, PhBath) and b.ml > 1 for b in system.baths)
            and system.force_fn is None and system.cf_fn is None
            and not (system.savep or system.saveq or system.savef))


def _host(x: torch.Tensor) -> np.ndarray:
    profiling.count("syncs")
    return x.detach().cpu().numpy()


def _to_host_async(*xs: torch.Tensor):
    """Start copying the tensors ``xs`` of one card into pinned host
    memory; returns the host tensors and a CUDA event recorded after the
    copies, or, for tensors on the CPU, plain copies and None."""
    cuda = xs[0].is_cuda
    out = []
    for x in xs:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=cuda)
        h.copy_(x, non_blocking=cuda)
        out.append(h)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(xs[0].device))
    return out, event


def _write_texts(files, count: bool = True):
    """Write small text files, each ``(path, text)`` of ``files``, through
    raw ``os.open``/``os.write``: the runner writes one kappa file per
    trajectory and bath, and buffered ``open()`` costs several times the
    two syscalls a file (the JAX package measured 2-3 ms against 0.13
    ms; ``sclmd_tpu/md.py:396``). The bytes are those ``open(path,
    "w").write(text)`` would write. Returns (files, bytes), counted once
    for the batch unless ``count`` is false (another thread's writes:
    the counters are not thread-safe)."""
    n = nbytes = 0
    for path, text in files:
        data = text.encode()
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
        n += 1
        nbytes += len(data)
    if count:
        profiling.count("files", n)
        profiling.count("bytes_written", nbytes)
    return n, nbytes


def _write_text(path: str, text: str):
    _write_texts(((path, text),))


def _save_npz(path: str, data: dict):
    """``np.savez`` of a checkpoint, counted as a file and its bytes."""
    np.savez(path, **data)
    profiling.count("files")
    profiling.count("bytes_written", os.path.getsize(path))


class md:
    """User-facing MD runner with the JAX package's constructor, method
    names and output files.

    ``Run`` draws each run's noise, and its thermal start, from the
    counter-keyed Philox schedule of ``parallel.ensemble`` (stream = bath
    index for the noise of run j, index j; stream = number of baths for
    the start; kernels K3 and K3b on the card), seeded by the runner's
    seed and call count. These are not the JAX package's draws; a resumed
    run reads its noise back from ``MD{j}.npz`` as in the JAX package.
    """

    def __init__(self, dt, nmd, T, syslist=None, axyz=None, dyn=None,
                 nstart=0, nstop=1, npie=1, md2ang=U.MD2ANG,
                 dtype=torch.float32, seed=1234, outdir=".", block=None,
                 device=None):
        self.dt, self.nmd, self.T = float(dt), int(nmd), float(T)
        self.nstart, self.nstop, self.npie = int(nstart), int(nstop), int(npie)
        self.block = None if block is None else int(block)
        self.md2ang = md2ang
        self.dtype = dtype
        self.device = resolve_device(device)
        self.outdir = outdir
        self.seed = int(seed)
        self._calls = 0
        self.saveall = self.savep = self.saveq = self.rmnc = False
        self.nstep = None
        self.pforce = None
        self.cf = False
        self.forcedriver = None
        self.constraint = None
        self.atomlist = None
        self.initranvel = True
        self.state = None
        self.power = self.poweratomlist = None
        self.etot = self.curs = None
        self.t = 0

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
        if axyz is not None:
            self.mass = [U.AtomicMassTable[el] for el in self.els]
            self.conv = self.md2ang * np.repeat(
                1.0 / np.sqrt(np.array(self.mass)), 3)
        else:
            self.mass = self.conv = None

    # ---- setup (the JAX package's names) ----
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
        self._starts = {}

    def AddBath(self, bath):
        """Attach an ``EBath`` or a ``PhBath`` (moved to the runner's
        device)."""
        if self.dt != bath.dt:
            raise ValueError("md.AddBath: time step dt not consistent")
        if self.nmd != bath.nmd:
            raise ValueError("md.AddBath: nmd not consistent")
        self.baths.append(bath.to(self.device))
        self.ml = max(self.ml, bath.ml)

    def AddPotential(self, pint):
        """Attach a force driver: its batched ``force_torch(q)`` (else a
        callable ``force``) replaces ``-dyn q`` in the step. The driver's
        tensors must live on the runner's device."""
        self.pforce = pint

    def AddConstr(self, constr):
        self.constraint = constr

    def AddPowerSection(self, atomlist):
        self.atomlist = atomlist

    def CalPowerSpec(self, cal=True):
        self.savep = cal

    def CalAveStruct(self, cal=True):
        self.saveq = cal

    def SaveAll(self, save=True):
        self.saveall = save

    def Savep(self, save=True):
        self.savep = save

    def Saveq(self, save=True):
        self.saveq = save

    def SaveTraj(self, nstep=100):
        self.nstep = nstep

    def RemoveNC(self, rmnc=True):
        self.rmnc = rmnc

    def SetT(self, T):
        self.T = T

    def SetMD(self, dt, nmd):
        self.dt, self.nmd = dt, nmd

    def noranvel(self, rf=False):
        self.initranvel = rf

    def SetSyslist(self, syslist):
        """Reset the system-atom list."""
        self.syslist = np.asarray(syslist, dtype=np.int64)
        self.na = len(self.syslist)
        self.nph = 3 * self.na
        if self.nta is not None and self.na > self.nta:
            raise ValueError("system atom number larger than total")

    def CompareForce(self, forcedriver):
        """Record, at every step of ``Run``, ``forcedriver``'s force
        minus the harmonic one (``deltaforce.run{j}.npy``, in
        eV/angstrom units through the driver's ``conv``)."""
        self.cf = True
        self.forcedriver = forcedriver

    def ResetHis(self) -> MDState:
        """Zeroed history rings as a fresh one-trajectory state."""
        return initial_state(self._build_system(), 1, dtype=self.dtype)

    def ResetSavepq(self):
        """No-op, as in the JAX package: the per-step series are outputs
        of the segment, not preallocated buffers."""

    def get_atommass(self):
        """Per-atom mass list from the element names."""
        self.mass = [U.AtomicMassTable[el] for el in self.els]
        return self.mass

    def energy(self, state: MDState) -> float:
        return 0.5 * float((state.p * state.p).sum())

    def _constraint_mask(self) -> torch.Tensor:
        mask = np.ones(self.nph, dtype=np.float64)
        if self.constraint is not None:
            for grp in self.constraint:
                mask[np.asarray(list(grp), dtype=np.int64)] = 0.0
        return torch.as_tensor(mask, dtype=self.dtype, device=self.device)

    @staticmethod
    def _driver_force(driver):
        fn = getattr(driver, "force_torch", None)
        if fn is None and callable(getattr(driver, "force", None)):
            fn = driver.force
        return fn

    def _build_system(self) -> GLESystem:
        force_fn = None if self.pforce is None else \
            self._driver_force(self.pforce)
        if self.dyn is None and force_fn is None:
            raise ValueError("no driver, no md")
        cf_fn = self._driver_force(self.forcedriver) \
            if self.cf and self.forcedriver is not None else None
        return GLESystem(
            force_fn=force_fn, cf_fn=cf_fn,
            dyn=self.dyn, baths=tuple(self.baths),
            mask=self._constraint_mask(),
            dt=self.dt, nph=self.nph, ml=self.ml, nmd=self.nmd,
            unconstrained=self.constraint is None or not self.constraint,
            savep=self.savep or self.saveall,
            saveq=self.saveq or self.saveall or self.nstep is not None,
            savef=self.saveall or self.nstep is not None)

    def _next_seed(self) -> int:
        from sclmd_tpu_torch.parallel.ensemble import ensemble_seed
        self._calls += 1
        return ensemble_seed(self.seed, self._calls)

    def initialise(self, system: GLESystem, seed: Optional[int] = None):
        """The start of ``Run``: a Bose-weighted thermal draw (stream =
        number of baths of the schedule seeded ``seed``), or zeros."""
        if self.dyn is None or not self.initranvel:
            return initial_state(system, 1, dtype=self.dtype)
        seed = self._next_seed() if seed is None else seed
        return self._thermal_start(self.T).states(system, seed,
                                                  len(self.baths), 0, 1)

    def _thermal_start(self, T) -> ThermalStart:
        """The thermal start at temperature ``T`` (a scalar or per-mode
        array), made once per runner and temperature."""
        key = float(T) if np.ndim(T) == 0 else \
            np.asarray(T, np.float64).tobytes()
        if key not in self._starts:
            self._starts[key] = ThermalStart(self.hw, self.U, T, self.dtype,
                                             self.device)
        return self._starts[key]

    def _draw_noise(self, seed: int, j: int):
        """Fresh noise of run ``j`` for every bath, as a batch of one:
        trajectory j of the schedule (K3 on the card)."""
        from sclmd_tpu_torch.parallel.ensemble import (bath_factors,
                                                       chunk_noise)
        facs = bath_factors(self.baths, self.device)
        for i, nz in enumerate(chunk_noise(facs, seed, j, j + 1, self.dt,
                                           self.nmd)):
            self.baths[i] = self.baths[i].replace(noise=nz.to(self.dtype))

    def info(self):
        print("-" * 44)
        print("GLE MD (torch, %s): na=%s dt=%s nmd=%s ml=%s baths=%d" %
              (self.device, self.na, self.dt, self.nmd, self.ml,
               len(self.baths)))

    # ---- checkpoints (the JAX package's MD{j}.npz keys and shapes) ----
    def _ckfile(self, j):
        return os.path.join(self.outdir, f"MD{j}.npz")

    def _check_checkpoint(self, ck, fn):
        """Refuse checkpoints from a different setup (stale files in a
        shared working directory would resume silently otherwise)."""
        if ck["p"].shape != (self.nph,):
            raise ValueError(
                f"{fn} holds a different system (nph="
                f"{ck['p'].shape[0]} vs {self.nph}) — stale checkpoint "
                "in the working directory? Remove it or change outdir")
        for i, b in enumerate(self.baths):
            key = f"noise{i}"
            if key in ck and ck[key].shape[1] != b.nc:
                raise ValueError(
                    f"{fn} bath {i} noise width {ck[key].shape[1]} != "
                    f"{b.nc} — stale checkpoint from a different bath "
                    "setup")
        if "nmd" in ck and int(ck["nmd"][0]) != self.nmd:
            raise ValueError(
                f"{fn} was written with nmd={int(ck['nmd'][0])} but this "
                f"run has nmd={self.nmd} — stale checkpoint")
        if "dt" in ck and not np.isclose(float(ck["dt"][0]), self.dt,
                                         rtol=1e-12):
            raise ValueError(
                f"{fn} was written with dt={float(ck['dt'][0])} but this "
                f"run has dt={self.dt} — stale checkpoint")

    def dump(self, state: MDState, ipie, j, outputs=None):
        """Write the MD{j} checkpoint of a one-trajectory state."""
        with profiling.span("run/checkpoint"):
            data = {
                "p": _host(state.p[0]), "q": _host(state.q[0]),
                "t": np.asarray([int(state.t[0])]),
                "ipie": np.asarray([ipie]),
                "nmd": np.asarray([self.nmd]), "dt": np.asarray([self.dt]),
                "phis": _host(state.phis[0]), "qhis": _host(state.qhis[0]),
            }
            for i, b in enumerate(self.baths):
                if b.noise is not None:
                    data[f"noise{i}"] = _host(b.noise[0])
            if outputs is not None:
                for k, v in outputs.items():
                    if v is not None:
                        data[k] = np.asarray(v)
            if self.power is not None:
                data["power"] = np.asarray(self.power)
                if self.poweratomlist is not None:
                    data["poweratomlist"] = np.asarray(self.poweratomlist)
            _save_npz(self._ckfile(j), data)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)[None]

    # ---- main loop ----
    @profiling.call("Run", "run")
    def Run(self):
        """Runs ``nstart..nstop-1`` of ``nmd`` steps each, in ``npie``
        segments with an ``MD{j}.npz`` checkpoint after every segment: an
        unfinished run resumes from its checkpoint (state and noise), a
        finished one is skipped, and a new run chains from MD{j-1}. One
        report of ``utils.profiling`` a call (spans ``run/...``)."""
        with profiling.span("run/start"):
            system = self._build_system()
            seed = self._next_seed()
            state = self.initialise(system, seed)
            self.info()

        seg = self.nmd // self.npie
        for j in range(self.nstart, self.nstop):
            fn, fnm = self._ckfile(j), self._ckfile(j - 1)
            collected = {}
            ipie0 = -1
            with profiling.span("run/start"):
                if os.path.isfile(fn):
                    ck = np.load(fn)
                    self._check_checkpoint(ck, fn)
                    ipie = int(ck["ipie"][0])
                    if ipie + 1 < self.npie:
                        # resume an unfinished run
                        state = MDState(
                            t=torch.as_tensor([int(ck["t"][0])],
                                              device=self.device),
                            p=self._tensor(ck["p"]), q=self._tensor(ck["q"]),
                            phis=self._tensor(ck["phis"]),
                            qhis=self._tensor(ck["qhis"]))
                        missing = [i for i in range(len(self.baths))
                                   if f"noise{i}" not in ck]
                        if missing:
                            self._draw_noise(seed, j)
                        for i in range(len(self.baths)):
                            if f"noise{i}" in ck:
                                self.baths[i] = self.baths[i].replace(
                                    noise=self._tensor(ck[f"noise{i}"]))
                        for k in ("etot", "cur", "ps", "qs", "fbaths", "f"):
                            if k in ck:
                                collected[k] = [np.asarray(ck[k])]
                        ipie0 = ipie
                        system = self._build_system()
                    else:
                        # finished run: skip
                        if "power" in ck:
                            self.power = np.asarray(ck["power"])
                        self.t = int(ck["t"][0])
                        continue
                else:
                    if os.path.isfile(fnm):
                        # chain from the previous run with its warm history
                        ck = np.load(fnm)
                        state = state.replace(
                            t=torch.as_tensor([int(ck["t"][0])],
                                              device=self.device),
                            p=self._tensor(ck["p"]), q=self._tensor(ck["q"]))
                        if ck["phis"].shape == tuple(state.phis.shape[1:]):
                            state = state.replace(
                                phis=self._tensor(ck["phis"]),
                                qhis=self._tensor(ck["qhis"]))
                    elif j != 0 and j != self.nstart:
                        raise FileNotFoundError(
                            "no previous checkpoint exists")
                    self._draw_noise(seed, j)
                    system = self._build_system()

            trajfile = None
            if self.nstep is not None:
                trajfile = open(os.path.join(
                    self.outdir, f"trajectories.{self.T:g}.run{j}.ani"), "w")

            ck_keys = ("etot", "cur", "ps", "qs") + \
                (("fbaths", "f") if self.saveall else ())
            blocked = bool(self.block) and seg % self.block == 0 and \
                blocked_supports(system)
            wrote_segment = ipie0 >= 0
            try:
                for i in range(ipie0 + 1, self.npie):
                    t0 = int(state.t[0]) % self.nmd
                    with profiling.span("run/segment"):
                        if blocked:
                            state, ys = run_segment_blocked(
                                system, state, seg, t0=t0, block=self.block)
                        else:
                            state, ys = run_segment(system, state, seg,
                                                    t0=t0)
                    profiling.count("steps", seg)
                    # a diverged segment aborts with context instead of
                    # writing non-finite checkpoints; etot observes the
                    # state at each step's start, so the final state is
                    # checked too
                    with profiling.span("run/readback"):
                        ys = {k: _host(v[0]) for k, v in ys.items()}
                        state_bad = not bool(torch.isfinite(state.p).all()
                                             and torch.isfinite(state.q).all())
                        profiling.count("syncs", 2)
                    if state_bad or not np.isfinite(ys["etot"]).all():
                        bad = seg - 1 if state_bad else int(np.argmax(
                            ~np.isfinite(ys["etot"])))
                        if wrote_segment:
                            last_good = self._ckfile(j)
                        elif os.path.isfile(self._ckfile(j - 1)):
                            last_good = self._ckfile(j - 1)
                        else:
                            last_good = "none (run diverged before the "\
                                "first checkpoint)"
                        raise FloatingPointError(
                            f"run {j}: non-finite state at step "
                            f"{int(state.t[0]) - seg + bad}; last good "
                            f"checkpoint: {last_good} — reduce dt or "
                            f"check the force driver")
                    for k, v in ys.items():
                        collected.setdefault(k, []).append(v)
                    if trajfile is not None:
                        with profiling.span("run/traj"):
                            self._write_traj(trajfile, ys, seg, i)
                    self.dump(state, i, j, outputs={
                        k: np.concatenate(v, axis=0)
                        for k, v in collected.items() if k in ck_keys})
                    wrote_segment = True

                outputs = {k: np.concatenate(v, axis=0)
                           for k, v in collected.items()}
                with profiling.span("run/postrun"):
                    self._postrun(j, state, outputs)
            finally:
                if trajfile is not None:
                    trajfile.close()
            if self.rmnc and os.path.exists(self._ckfile(j - 1)):
                os.remove(self._ckfile(j - 1))
        self.state = state

    def _eck_file(self):
        return os.path.join(self.outdir, "MDE.npz")

    def _load_ensemble_checkpoint(self, fn, ntraj, chunk):
        """The MDE.npz of an earlier call (this package's or the JAX
        package's): (ichunk, ipie, cur_sum, seed or None, the chunk's
        state, its noise per bath). A file of another setup raises."""
        with np.load(fn) as ck:
            rows = ck["p"].shape[0]
            ck_chunk = int(ck["chunk"][0]) if "chunk" in ck else rows
            ck_ntraj = int(ck["ntraj"][0]) if "ntraj" in ck else rows
            if (ck["p"].shape[1:] != (self.nph,) or ck_ntraj != ntraj
                    or ck_chunk != chunk or int(ck["nmd"][0]) != self.nmd
                    or not np.isclose(float(ck["dt"][0]), self.dt)
                    or any(f"noise{i}" not in ck or
                           ck[f"noise{i}"].shape[1:] != (self.nmd, b.nc)
                           for i, b in enumerate(self.baths))):
                raise ValueError(
                    f"{fn} holds a different ensemble setup — stale "
                    "checkpoint; remove it or change outdir")

            def dev(x, dtype=None):
                return torch.as_tensor(np.asarray(x), device=self.device,
                                       dtype=dtype or self.dtype)

            state = MDState(t=dev(ck["t"], torch.long), p=dev(ck["p"]),
                            q=dev(ck["q"]), phis=dev(ck["phis"]),
                            qhis=dev(ck["qhis"]))
            return (int(ck["ichunk"][0]) if "ichunk" in ck else 0,
                    int(ck["ipie"][0]), np.array(ck["cur_sum"], np.float64),
                    int(ck["seed"][0]) if "seed" in ck else None, state,
                    [dev(ck[f"noise{i}"]) for i in range(len(self.baths))])

    @profiling.call("RunEnsemble", "ensemble")
    def RunEnsemble(self, ntraj: int, nsteps: Optional[int] = None,
                    equil_frac: float = 0.25, block: Optional[int] = None,
                    npie: Optional[int] = None, checkpoint: bool = False,
                    chunk: Optional[int] = None,
                    steady_init: bool = False):
        """Run ``ntraj`` independent trajectories; returns the
        per-trajectory mean bath currents (ntraj, nbaths) after skipping
        the first ``equil_frac`` of the steps, and writes the
        kappa.T.bathI.runJ.dat files. Without ``checkpoint``, a chunk
        followed by another has its sums copied to the host as soon as
        its last segment is enqueued, and a writer thread writes its files
        while the next chunk runs on the card (counter ``files_behind``);
        the last chunk's files are written on the calling thread. Every
        file is written when the call returns or raises; the writer's
        ``OSError`` is raised by the call, and a chunk's non-finite
        currents at most one chunk late, with no file of that chunk.

        The blocked integrator runs when ``block`` (or the runner's)
        divides the segment length and the baths are non-local phonon
        baths; else the plain step, as the JAX runner falls back to it.
        Chunks of ``chunk`` trajectories (default: ``auto_chunk`` from the
        card's memory) run one after another, each synthesising only its
        own noise (K3 on the card, one launch per bath and chunk; K3b for
        the thermal phases). Every draw is keyed by (seed, stream,
        trajectory index), so the draws do not depend on the chunking.
        ``steady_init``: the thermal start takes each mode's steady-state
        temperature (``steady_mode_temps``) instead of the runner's T.

        ``npie`` splits each chunk's run into segments of nsteps / npie
        steps (it must divide ``nsteps``: ValueError), each starting at
        its step offset in the noise period; the currents of the steps
        past the equilibration skip add up across segments. Without
        ``checkpoint`` the next segment's launches go out before a
        segment's sums are read back (a non-finite current is then
        reported one segment late). ``checkpoint=True`` runs the
        segments synchronously and after each one writes ``MDE.npz`` in
        ``outdir``: the chunk's batched state and noise, the accumulated
        currents of every trajectory, the chunk and segment reached, the
        setup (ntraj, chunk, nmd, dt) and the ensemble seed. A later call
        with ``checkpoint=True`` in the same ``outdir`` resumes from it
        (a finished ensemble returns its means again, a file of another
        setup raises ValueError). The keys are the JAX package's, with
        this package's integer seed under ``seed`` where the JAX package
        stores ``noise_key``/``init_key``: either package resumes the
        other's current chunk, whose state and noise are in the file, but
        later chunks draw from the resuming package's own schedule. One
        report of ``utils.profiling`` a call (spans ``ensemble/...``).
        """
        from sclmd_tpu_torch.parallel.ensemble import (
            auto_chunk, bath_factors, draw_chunk, fused_chunk)

        nsteps = nsteps or self.nmd
        npie = npie or 1
        if nsteps % npie:
            raise ValueError(f"nsteps={nsteps} not divisible by "
                             f"npie={npie}")
        seg = nsteps // npie
        with profiling.span("ensemble/start"):
            system = self._build_system()
            block = block if block is not None else self.block
            if not (block and seg % block == 0 and blocked_supports(system)):
                block = None
            nb = len(self.baths)
            skip = int(nsteps * equil_frac)
            if chunk is None:
                chunk = auto_chunk(system, ntraj, nsteps, block, depth=2)
            chunk = max(1, min(int(chunk), ntraj))

            seed = self._next_seed()
            start = None
            if self.initranvel and self.dyn is not None:
                T_init = self.T
                if steady_init and self.baths:
                    T_init = steady_mode_temps(self.U, self.baths, self.T,
                                               hw=self.hw)
                start = self._thermal_start(T_init)
            facs = bath_factors(self.baths, self.device)
            cur_sum = np.zeros((ntraj, nb))
            # counted steps per trajectory, the same for every chunk: a
            # function of the segment schedule (a resumed call must not
            # count again)
            cur_cnt = sum(seg - min(max(0, skip - i * seg), seg)
                          for i in range(npie))
            ichunk0, ipie0, ck_state, ck_noises = 0, -1, None, None
            fn = self._eck_file()
            if checkpoint and os.path.isfile(fn):
                ichunk0, ipie0, cur_sum, ck_seed, ck_state, ck_noises = \
                    self._load_ensemble_checkpoint(fn, ntraj, chunk)
                if ck_seed is not None:
                    seed = ck_seed

        def finish(c0, c1):
            with profiling.span("ensemble/files"):
                self._write_kappa_files(cur_sum[c0:c1] / max(cur_cnt, 1), c0)

        def nonfinite(dic, di):
            return FloatingPointError(
                f"RunEnsemble: non-finite heat currents in chunk {dic} "
                f"segment {di} - reduce dt or check the force driver")

        def drain(item):
            d0, d1, dic, di, dsum, dok, last = item
            with profiling.span("ensemble/readback"):
                good = bool(dok)
                if good:
                    cur_sum[d0:d1] += dsum.double().cpu().numpy()
            profiling.count("syncs", 2 if good else 1)
            if not good:
                raise nonfinite(dic, di)
            if last:
                finish(d0, d1)

        # The kappa files of every chunk but the last are written on one
        # writer thread while the later chunks run on the card: its waits
        # (the event, the file syscalls) release the GIL, as do the
        # calling thread's waits in graph replays and blocking copies.
        # The writer touches only its chunk's rows of cur_sum and no
        # profiling state.
        writer, behind = None, None

        def write_behind(d0, d1, dic, di, sums, ok, event):
            if event is not None:
                event.synchronize()
            if not ok.numpy():
                raise nonfinite(dic, di)
            cur_sum[d0:d1] += sums.numpy()
            t0 = time.perf_counter()
            n, nbytes = self._write_kappa_files(
                cur_sum[d0:d1] / max(cur_cnt, 1), d0, count=False)
            return n, nbytes, time.perf_counter() - t0

        def join():
            """Wait for the writer's chunk, raise what it raised, and count
            its read-back and files here."""
            nonlocal behind
            if behind is None:
                return
            done, behind = behind, None
            n, nbytes, seconds = done.result()
            profiling.count("syncs", 2)
            profiling.count("files", n)
            profiling.count("files_behind", n)
            profiling.count("bytes_written", nbytes)
            profiling.add_span("ensemble/files_behind", seconds)

        def hand_over(item):
            """A chunk's last segment, with another chunk after it: its
            sums and flag start for the host now, and the writer adds them
            up and writes its files once the chunk before's are done (so a
            failure is raised at most one chunk late)."""
            nonlocal writer, behind
            d0, d1, dic, di, dsum, dok, _ = item
            with profiling.span("ensemble/readback"):
                (sums, ok), event = _to_host_async(dsum.double(), dok)
            join()
            if writer is None:
                writer = concurrent.futures.ThreadPoolExecutor(
                    1, thread_name_prefix="sclmd-kappa")
            behind = writer.submit(write_behind, d0, d1, dic, di, sums, ok,
                                   event)

        pending, first = [], None
        try:
            for ic in range(-(-ntraj // chunk)):
                c0, c1 = ic * chunk, min((ic + 1) * chunk, ntraj)
                if ic < ichunk0:                  # finished before the resume
                    finish(c0, c1)
                    continue
                if ic == ichunk0 and ck_state is not None:
                    noises, states, pie0 = ck_noises, ck_state, ipie0 + 1
                    if pie0 >= npie:
                        finish(c0, c1)
                        continue
                else:
                    with profiling.span("ensemble/draw"):
                        noises, states = draw_chunk(facs, seed, c0, c1,
                                                    self.dt, self.nmd, start,
                                                    system)
                    pie0 = 0
                for i in range(pie0, npie):
                    with profiling.span("ensemble/segment"):
                        states, sums, ok = fused_chunk(
                            system, facs, None, seg, (i * seg) % self.nmd,
                            block, min(max(0, skip - i * seg), seg),
                            noises=noises, states=states)
                    profiling.count("steps", seg)
                    item = (c0, c1, ic, i, sums, ok, i == npie - 1)
                    if checkpoint:
                        drain(item)
                        self._save_ensemble_checkpoint(
                            fn, states, noises, ic, i, chunk, ntraj, cur_sum,
                            cur_cnt, seed)
                        continue
                    if i == npie - 1 and c1 < ntraj:
                        while pending:
                            drain(pending.pop(0))
                        hand_over(item)
                        continue
                    # read a segment's sums back only after the next one's
                    # launches: those then overlap it on the card (reading
                    # them at once would leave the card idle)
                    pending.append(item)
                    while len(pending) > 1:
                        drain(pending.pop(0))
                if first is None:
                    first = states.select(0)
            for item in pending:
                drain(item)
            join()
        finally:
            if writer is not None:
                writer.shutdown()   # no file write outlives the call
        self.state = first
        return cur_sum / max(cur_cnt, 1)

    def _save_ensemble_checkpoint(self, fn, states, noises, ic, ipie, chunk,
                                  ntraj, cur_sum, cur_cnt, seed):
        with profiling.span("ensemble/checkpoint"):
            data = {"p": _host(states.p), "q": _host(states.q),
                    "t": _host(states.t), "phis": _host(states.phis),
                    "qhis": _host(states.qhis), "ichunk": np.asarray([ic]),
                    "ipie": np.asarray([ipie]), "chunk": np.asarray([chunk]),
                    "ntraj": np.asarray([ntraj]),
                    "nmd": np.asarray([self.nmd]),
                    "dt": np.asarray([self.dt]), "cur_sum": cur_sum,
                    "cur_cnt": np.asarray([cur_cnt]),
                    "seed": np.asarray([seed], np.uint64)}
            for ib, nz in enumerate(noises):
                data[f"noise{ib}"] = _host(nz)
            _save_npz(fn, data)

    # ---- output files ----
    def _write_kappa_files(self, means, lo: int = 0, count: bool = True):
        """Per-trajectory kappa.T.bathI.runJ.dat files of trajectories
        lo, lo+1, ... (the rows of ``means``), the format the calHF/calTC
        aggregators read; returns (files, bytes) (``_write_texts``)."""
        return _write_texts(
            ((os.path.join(self.outdir,
                           f"kappa.{self.T:g}.bath{ii}.run{lo + jj}.dat"),
              "%i %f    %f \n" % (lo + jj, self.T, m * U.CURCOF))
             for jj, row in enumerate(means) for ii, m in enumerate(row)),
            count)

    def _write_traj(self, fh, ys, seg, ipie):
        """ani-format frames every ``nstep`` steps: element, position
        (angstrom) and force per atom."""
        qs, fs = ys.get("qs"), ys.get("f")
        if qs is None or fs is None:
            return
        base = ipie * seg
        for s in range(seg):
            tstep = base + s
            if tstep == 0 or tstep % self.nstep == 0:
                fh.write(f"{len(self.els)}\n{tstep}\n")
                struct_ = self.xyz + self.conv * qs[s]
                frc = fs[s]
                for ip, el in enumerate(self.els):
                    fh.write("%s    %s   %s   %s   %s   %s   %s\n" % (
                        el, struct_[3 * ip], struct_[3 * ip + 1],
                        struct_[3 * ip + 2], frc[3 * ip],
                        frc[3 * ip + 1], frc[3 * ip + 2]))

    def _power(self, ps) -> np.ndarray:
        return _host(powerspecp(torch.as_tensor(ps), self.dt, self.nmd))

    def _postrun(self, j, state, outputs):
        """Per-run power spectra, kappa files, average structure and the
        final MD{j} checkpoint."""
        self.etot = outputs.get("etot")
        self.curs = outputs.get("cur")
        if self.cf and "cf" in outputs:
            np.save(os.path.join(self.outdir, f"deltaforce.run{j}"),
                    outputs["cf"] / np.asarray(self.forcedriver.conv))
        if self.savep and "ps" in outputs:
            power = self._power(outputs["ps"])
            if self.power is None or j == self.nstart:
                self.power = power
            else:
                self.power = (self.power * (j - self.nstart) + power) / \
                    float(j - self.nstart + 1)
            self._write_power(j, self.power, "power")
            if self.atomlist is not None:
                pal = np.array([self._power(outputs["ps"][:, list(sel)])
                                for sel in self.atomlist])
                if self.poweratomlist is None or j == self.nstart:
                    self.poweratomlist = pal
                else:
                    self.poweratomlist = (
                        self.poweratomlist * (j - self.nstart) + pal) / \
                        float(j - self.nstart + 1)
                for layer in range(len(self.atomlist)):
                    self._write_power(j, self.poweratomlist[layer],
                                      f"poweratomlist.{layer}")

        if self.curs is not None:
            for ii in range(len(self.baths)):
                _write_text(os.path.join(
                    self.outdir, f"kappa.{self.T:g}.bath{ii}.run{j}.dat"),
                    "%i %f    %f \n" % (
                        j, self.T,
                        float(np.mean(self.curs[:, ii])) * U.CURCOF))

        if self.saveq and "qs" in outputs and self.xyz is not None:
            ave = self.conv * outputs["qs"].mean(axis=0) + self.xyz
            _write_text(os.path.join(
                self.outdir, f"avestructure.{self.T:g}.run{j}.dat"),
                f"{len(self.els)}\naverage structure\n" + "".join(
                    "%s    %s   %s   %s\n" % (
                        el, ave[3 * ip], ave[3 * ip + 1], ave[3 * ip + 2])
                    for ip, el in enumerate(self.els)))

        keep = ("etot", "cur", "ps", "qs") + \
            (("fbaths", "f") if self.saveall else ())
        self.dump(state, self.npie - 1, j, outputs={
            k: outputs.get(k) for k in keep if k in outputs})

    def _write_power(self, j, power, prefix):
        lines = []
        for ni in range(len(power)):
            if self.hw is not None and \
                    power[ni, 0] >= 1.5 * float(np.max(self.hw)):
                break
            lines.append("%f     %f \n" % (power[ni, 0], power[ni, 1]))
        _write_text(os.path.join(
            self.outdir, f"{prefix}.{self.T:g}.run{j}.dat"), "".join(lines))

    def GetPower(self):
        if self.curs is None:
            raise RuntimeError("run first")
        return self.power


def ApplyConstraint(f, constr=None):
    """Zero the listed DOFs of f (a float64 copy; f itself when ``constr``
    is None)."""
    if constr is None:
        return f
    f = np.array(f, dtype=float)
    for grp in constr:
        f[np.asarray(list(grp), dtype=np.int64)] = 0.0
    return f


def sameq(q1, q2, tol=10e-10):
    """True when two displacement vectors coincide (same shape, largest
    difference below ``tol``)."""
    q1, q2 = np.asarray(q1), np.asarray(q2)
    if q1.shape != q2.shape:
        return False
    return bool(np.max(np.abs(q1 - q2)) < tol)
