"""Trajectory ensembles (counterpart of ``sclmd_tpu.parallel.ensemble``):
the ``md.RunEnsemble`` path, the noise and runs of a trajectory window,
and the antithetic conductance estimator with its periodic warm start.

Randomness comes from a counter-keyed schedule (``ops.philox``): the
noise of bath i for trajectory j is drawn by Philox4x32-10 keyed by
(ensemble seed, stream i) at counters (element // 4, 0, j, 0), and the
thermal start's phases on stream = number of baths. On the card kernel
K3 draws the noise inside the product with the PSD eigenvectors (then
one cuFFT C2R plan makes the series) and K3b the phases and the start's
mode-space amplitudes (``kernels.noise_synth``, ``md.ThermalStart``); on
the CPU the twin draws the same integers. A chunked ensemble therefore
draws bitwise the same numbers as the unchunked one; chunking changes
peak memory, never the physics. The
numbers are not the JAX package's (threefry), nor the per-trajectory
``torch.Generator`` streams of the port before the schedule moved into
the kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch.kernels.noise_synth import Factors
from sclmd_tpu_torch.md import (GLESystem, MDState, ThermalStart,
                                blocked_supports, initial_state, run_segment,
                                run_segment_blocked)
from sclmd_tpu_torch.ops.noise import (factor_matrix, sample_noise_from_r,
                                       schedule_noise)
from sclmd_tpu_torch.ops.philox import splitmix64


def ensemble_seed(seed: int, call: int) -> int:
    """Seed of the ``call``-th ensemble drawn by a runner seeded ``seed``."""
    return splitmix64(splitmix64(int(seed)) ^ int(call))


def bath_factors(baths, device) -> list:
    """Per-bath noise factors (``kernels.noise_synth.Factors``: the pair
    (evecs, std) on ``device``, with K3's packed operand made once on the
    card): one (nc, nc) matrix for a proportional spectrum (never nw
    broadcast copies), else the (nw, nc, nc) batch."""
    facs = []
    for b in baths:
        if b.nstd is None:
            raise ValueError("bath carries no PSD factors: build it with "
                             "factorize=True")
        facs.append(Factors(
            torch.as_tensor(factor_matrix(b.nevecs), device=device),
            torch.as_tensor(np.asarray(b.nstd), device=device)))
    return facs


def chunk_noise(facs, seed: int, lo: int, hi: int, dt: float,
                nmd: int) -> list:
    """Per bath the (hi-lo, nmd, nc) noise series of trajectories [lo, hi)
    on the schedule (stream = bath index): K3 and cuFFT on the card."""
    return [schedule_noise(f[0], f[1], seed, i, lo, hi, dt, nmd,
                           packed=getattr(f, "packed", None))
            for i, f in enumerate(facs)]


def draw_chunk(facs, seed: int, lo: int, hi: int, dt: float, nmd: int,
               start: Optional[ThermalStart] = None,
               system: Optional[GLESystem] = None):
    """The schedule's draws for trajectories [lo, hi), synthesised: per
    bath the (hi-lo, nmd, nc) noise series (``chunk_noise``), and the
    thermal start's states of ``system`` (stream = number of baths; None
    when ``start`` is None)."""
    states = None if start is None else start.states(system, seed,
                                                     len(facs), lo, hi)
    return chunk_noise(facs, seed, lo, hi, dt, nmd), states


def ensemble_states(system: GLESystem, n: int, seed: Optional[int] = None,
                    hw=None, evecs=None, T=None, lo: int = 0,
                    hi: Optional[int] = None, dtype=None) -> MDState:
    """Initial states of trajectories [lo, hi) of an ``n``-trajectory
    ensemble: zeros, or Bose-weighted thermal draws from the schedule
    (stream = number of baths)."""
    hi = n if hi is None else hi
    dtype = dtype or system.mask.dtype
    if seed is None:
        return initial_state(system, hi - lo, dtype=dtype)
    start = ThermalStart(hw, evecs, T, dtype, system.mask.device)
    return start.states(system, seed, len(system.baths), lo, hi)


def estimate_traj_bytes(system: GLESystem, nsteps: int,
                        block: Optional[int] = None) -> int:
    """Rough per-trajectory peak device memory of one ensemble member:
    the noise series and its half-spectrum synthesis transients, the
    blocked path's history, tails, ring and FFT scratch (``block`` given)
    or the plain path's tail partials (``block`` None), the state and
    history ring, and the per-step outputs, with a 2x allocator-slack
    factor. A force
    driver adds nothing: kernel K5 keeps its whole working set in shared
    memory (the autograd twin's (traj, na, nn, nn) temporaries are what a
    CPU run pays)."""
    item = torch.empty((), dtype=system.mask.dtype).element_size()
    nb = len(system.baths)
    total = 0
    for b in system.baths:
        nc = int(b.nc)
        # the series (nmd, nc), and while it is made the folded half
        # spectrum K3 writes (~nmd reals) and cuFFT's (nc, nmd) output
        # before the transpose to the series' layout (K3 writes no draws)
        total += 3 * system.nmd * nc * item
        if b.ml > 1 and block:
            nfft = 1 << (int(b.ml + block + 2) - 1).bit_length()
            total += (2 * (b.ml - 1 + block) + 2 * (block + 1)
                      + 4 * (nfft // 2 + 1)) * nc * item
        elif b.ml > 2:
            # K6's per-split partial sums (8 taps per split) and tails
            total += (2 * (b.ml // 8 + 1) + 2) * nc * item
    total += (system.ml + 8) * system.nph * item
    total += nsteps * (nb + 1) * item
    return 2 * total


def auto_chunk(system: GLESystem, ntraj: int, nsteps: int,
               block: Optional[int] = None,
               budget_bytes: Optional[int] = None, depth: int = 1) -> int:
    """Largest trajectory chunk that fits the memory budget.

    Budget: half of the CUDA device's memory (40 GB on an 80 GB H100),
    leaving the rest to cuFFT plans and allocator slack; for a CPU run
    the same 40 GB nominal budget. ``depth`` chunk footprints are live
    at once (2 when RunEnsemble keeps one chunk in flight)."""
    if budget_bytes is None:
        dev = system.mask.device
        if dev.type == "cuda":
            budget_bytes = torch.cuda.get_device_properties(dev).total_memory // 2
        else:
            budget_bytes = 40 * 10 ** 9
    budget_bytes //= max(1, int(depth))
    per = max(estimate_traj_bytes(system, nsteps, block), 1)
    chunk = max(1, budget_bytes // per)
    if chunk >= ntraj:
        return int(ntraj)
    # a power of two keeps every chunk the same shape
    return 1 << (int(chunk).bit_length() - 1)


def fused_chunk(system: GLESystem, facs, rs, nsteps: int, t0: int,
                block: Optional[int], skiplo: int,
                noises: Optional[list] = None,
                states: Optional[MDState] = None):
    """Noise synthesis + run + current reduction for one chunk of
    trajectories: the blocked integrator with ``block``, the plain step
    (``run_segment``) when ``block`` is None.

    ``noises``: per-bath (chunk, nmd, nc) series already synthesised
    (``draw_chunk``, the runner's path); else ``rs``: per-bath (chunk, nw,
    nc) standard-normal draws injected by a test. ``states``: the chunk's
    initial states (``draw_chunk``, or ``md.thermal_init`` of injected
    phases), None for a zero start.
    Returns (final states, per-trajectory current sums over steps
    [skiplo, nsteps), finite flag as a 0-dim bool tensor).
    """
    dt, nmd = system.dt, system.nmd
    if noises is None:
        noises = [sample_noise_from_r(r, ev, std, dt, nmd)
                  for r, (ev, std) in zip(rs, facs)]
    sysb = system.replace(baths=tuple(
        b.replace(noise=nz) for b, nz in zip(system.baths, noises)))
    if states is None:
        states = initial_state(system, noises[0].shape[0])
    finals, ys = ensemble_run(sysb, states, nsteps, t0=t0, block=block)
    return (finals,) + cur_reduce(ys["cur"], skiplo)


def cur_reduce(cur: torch.Tensor, lo: int):
    """Per-trajectory current sums over steps [lo, nsteps) and the finite
    flag of every step's currents.

    The stable observation point for per-step currents: ``fused_chunk``
    calls it through this module at call time with each segment's
    (chunk, steps, nb) currents on the device, so a wrapper set on
    ``parallel.ensemble.cur_reduce`` sees every segment of every chunk in
    order (the benchmark's correctness check keeps a few trajectories'
    rows this way). Keep its name, arguments and the call through the
    module."""
    return cur[:, lo:, :].sum(dim=1), torch.isfinite(cur).all()


def ensemble_run(system: GLESystem, states: MDState, nsteps: int,
                 t0: int = 0, block: Optional[int] = None):
    """Run ``nsteps`` steps of the whole batch (the baths carry (traj,
    nmd, nc) noise): ``run_segment_blocked`` with ``block``, else the
    plain step. ``t0`` is the trajectories' step offset (mod nmd)."""
    if block is None:
        return run_segment(system, states, nsteps, t0=t0)
    return run_segment_blocked(system, states, nsteps, t0=t0, block=block)


def ensemble_noise(system: GLESystem, seed: int, n: int, lo: int = 0,
                   hi: Optional[int] = None) -> GLESystem:
    """The system with every bath carrying the schedule's noise of
    trajectories [lo, hi) of an ``n``-trajectory ensemble seeded
    ``seed`` (K3 on the card): the draws depend only on (seed, bath,
    trajectory), so windows reproduce the full batch bitwise."""
    hi = n if hi is None else hi
    facs = bath_factors(system.baths, system.mask.device)
    noises = chunk_noise(facs, seed, lo, hi, system.dt, system.nmd)
    return system.replace(baths=tuple(
        b.replace(noise=nz) for b, nz in zip(system.baths, noises)))


def _noisy_system(runner) -> GLESystem:
    """The runner's system with every bath carrying PSD factors, so
    ``ensemble_noise`` can synthesise its noise."""
    system = runner._build_system()
    return system.replace(baths=tuple(
        b if b.nstd is not None else b.prepare_noise()
        for b in system.baths))


def antithetic_run(build, TL, TR, ntraj: int, nsteps: Optional[int] = None,
                   seed: Optional[int] = None, warm_start: bool = True,
                   equil_frac: float = 0.25, block: Optional[int] = None,
                   pair=(0, 1), chunk: Optional[int] = None,
                   steady_init: bool = False):
    """Antithetic common-random-numbers conductance estimator (the JAX
    package's ``antithetic_run``).

    ``build(Ta, Tb) -> md`` makes a fresh runner whose baths sit at lead
    temperatures (Ta, Tb), everything else identical. The forward (TL,
    TR) and reversed (TR, TL) ensembles take their noise from the same
    (seed, stream, trajectory) triples of the schedule: the draws are
    identical and only the PSD's temperature scaling differs, so the
    zero-point-scale fluctuations cancel in (J_fwd - J_rev) / 2.

    ``warm_start=True`` (harmonic systems, ``nsteps`` = the runner's
    nmd): each trajectory runs one zero-start noise period; the periodic
    point x* of its own noise is solved on the host in float64 from the
    one-step Jacobian (``md.gle_step_jacobian``, temperature-independent,
    so one Jacobian and one period power serve both directions), and the
    measured period starts at x*: no start transient, so the whole period
    is averaged. ``warm_start=False``: each direction is the plain
    ``RunEnsemble`` estimator (thermal start and equilibration discard),
    common random numbers from the runners' shared seed.

    ``seed``: the ensemble seed is ``ensemble_seed(seed, 99)``; by
    default the forward runner's next seed. ``pair``: bath indices (hot,
    cold), J = (cur_hot - cur_cold) / 2. ``chunk``: trajectories resident
    at once (default ``auto_chunk``); windows of the same schedule, so
    the result does not depend on it beyond the solver's rounding.

    Returns the per-trajectory-pair J estimates (ntraj,): mean() is the
    conductance current, std() / sqrt(ntraj) its standard error.
    """
    from sclmd_tpu_torch.md import (fixed_point_solver, gle_step_jacobian,
                                    period_power, state_ravel, state_unravel)

    runner_f = build(TL, TR)
    nsteps = nsteps or runner_f.nmd
    nb = len(runner_f.baths)
    if max(pair) >= nb:
        raise ValueError(f"pair={pair} out of range for {nb} baths")

    if not warm_start:
        def one_direction(runner):
            means = runner.RunEnsemble(ntraj, nsteps=nsteps,
                                       equil_frac=equil_frac, block=block,
                                       chunk=chunk, steady_init=steady_init)
            return (means[:, pair[0]] - means[:, pair[1]]) / 2

        jf = one_direction(runner_f)
        jr = one_direction(build(TR, TL))
        return np.asarray(jf - jr) / 2

    if nsteps != runner_f.nmd:
        raise ValueError(
            f"warm_start needs nsteps == nmd (the attractor period is "
            f"the noise period); got nsteps={nsteps}, nmd="
            f"{runner_f.nmd}")

    system_f = runner_f._build_system()
    A = gle_step_jacobian(system_f)
    AP = period_power(A, nsteps, device=runner_f.device)
    solve = fixed_point_solver(AP)
    seed = runner_f._next_seed() if seed is None else ensemble_seed(seed, 99)

    block_eff = block if block is not None else runner_f.block
    if block_eff and (nsteps % block_eff or not blocked_supports(system_f)):
        block_eff = None
    if chunk is None:
        chunk = auto_chunk(system_f, ntraj, nsteps, block_eff)
    chunk = max(1, min(int(chunk), ntraj))

    def run_dir(runner):
        system = runner._build_system()
        sys_f = _noisy_system(runner)
        dsum = np.zeros((ntraj,))
        for c0 in range(0, ntraj, chunk):
            c1 = min(c0 + chunk, ntraj)
            bsys = ensemble_noise(sys_f, seed, ntraj, lo=c0, hi=c1)
            st0 = ensemble_states(bsys, ntraj, lo=c0, hi=c1)    # zeros
            fin1, _ = ensemble_run(bsys, st0, nsteps, t0=0, block=block_eff)
            x0 = solve(state_ravel(fin1))
            del fin1
            stw = state_unravel(x0, system, dtype=runner.dtype)
            _, ys = ensemble_run(bsys, stw, nsteps, t0=0, block=block_eff)
            sums, ok = cur_reduce(ys["cur"], 0)
            if not bool(ok):
                raise FloatingPointError(
                    f"antithetic_run: non-finite currents in "
                    f"trajectories [{c0}:{c1}]")
            sums = sums.double().cpu().numpy() / nsteps
            dsum[c0:c1] = (sums[:, pair[0]] - sums[:, pair[1]]) / 2
            del bsys, ys
        return dsum

    jf = run_dir(runner_f)
    jr = run_dir(build(TR, TL))
    return (jf - jr) / 2
