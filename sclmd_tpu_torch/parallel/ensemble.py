"""Trajectory ensembles (counterpart of ``sclmd_tpu.parallel.ensemble``,
the parts on the ``md.RunEnsemble`` path).

Randomness comes from a counter-keyed schedule: every draw of an
ensemble comes from its own ``torch.Generator`` seeded by (ensemble
seed, stream, trajectory index), with stream = bath index for the
noise draws and stream = number of baths for the thermal-init phases.
A chunked ensemble therefore draws bitwise the same numbers as the
unchunked one; chunking changes peak memory, never the physics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch.md import (GLESystem, MDState, initial_state,
                                run_segment, run_segment_blocked,
                                thermal_init)
from sclmd_tpu_torch.ops.noise import factor_matrix, sample_noise_from_r

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def ensemble_seed(seed: int, call: int) -> int:
    """Seed of the ``call``-th ensemble drawn by a runner seeded ``seed``."""
    return _splitmix64(_splitmix64(int(seed)) ^ int(call))


def draw_seed(seed: int, stream: int, index: int) -> int:
    """63-bit generator seed for (ensemble seed, stream, trajectory)."""
    x = _splitmix64(_splitmix64(_splitmix64(int(seed)) ^ int(stream))
                    ^ int(index))
    return x >> 1


def counter_generator(seed: int, stream: int, index: int,
                      device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(draw_seed(seed, stream, index))
    return g


def bath_factors(baths, device) -> list:
    """Per-bath (evecs, std) noise factors on ``device``: one (nc, nc)
    matrix for a proportional spectrum (never nw broadcast copies), else
    the (nw, nc, nc) batch."""
    facs = []
    for b in baths:
        if b.nstd is None:
            raise ValueError("bath carries no PSD factors: build it with "
                             "factorize=True")
        facs.append((torch.as_tensor(factor_matrix(b.nevecs), device=device),
                     torch.as_tensor(np.asarray(b.nstd), device=device)))
    return facs


def draw_chunk(facs, seed: int, lo: int, hi: int, nm: Optional[int],
               device, dtype):
    """The schedule's draws for trajectories [lo, hi): per bath the
    standard-normal (hi-lo, nw, nc) noise draws, and the (hi-lo, nm)
    uniform thermal-init phases (None when ``nm`` is None)."""
    rs = []
    for i, (_, std) in enumerate(facs):
        rs.append(torch.stack([
            torch.randn(tuple(std.shape), dtype=std.dtype, device=device,
                        generator=counter_generator(seed, i, j, device))
            for j in range(lo, hi)]))
    us = None if nm is None else init_draws(seed, len(facs), lo, hi, nm,
                                            device, dtype)
    return rs, us


def init_draws(seed: int, stream: int, lo: int, hi: int, nm: int, device,
               dtype) -> torch.Tensor:
    """Uniform (hi-lo, nm) thermal-init phases of the schedule's stream
    ``stream`` (the number of baths)."""
    return torch.stack([
        torch.rand((nm,), dtype=dtype, device=device,
                   generator=counter_generator(seed, stream, j, device))
        for j in range(lo, hi)])


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
    us = init_draws(seed, len(system.baths), lo, hi, system.nph,
                    system.mask.device, dtype)
    return thermal_init(us, system, hw, evecs, T)


def estimate_traj_bytes(system: GLESystem, nsteps: int,
                        block: Optional[int] = None) -> int:
    """Rough per-trajectory peak device memory of one ensemble member:
    the noise series and its synthesis transients, the blocked path's
    history, tails, ring and FFT scratch (``block`` given) or the plain
    path's tail partials (``block`` None), the state and history ring,
    and the per-step outputs, with a 2x allocator-slack factor. A force
    driver adds nothing: kernel K5 keeps its whole working set in shared
    memory (the autograd twin's (traj, na, nn, nn) temporaries are what a
    CPU run pays)."""
    item = torch.empty((), dtype=system.mask.dtype).element_size()
    nb = len(system.baths)
    total = 0
    for b in system.baths:
        nc = int(b.nc)
        # noise (nmd, nc) + draws + complex half and full spectra + fft
        total += (system.nmd + 6 * system.nmd) * nc * item
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


def fused_chunk(system: GLESystem, facs, rs, us, hw, evecs, T_init,
                nsteps: int, t0: int, block: Optional[int], skiplo: int):
    """Noise synthesis + initial states + run + current reduction for one
    chunk of trajectories: the blocked integrator with ``block``, the
    plain step (``run_segment``) when ``block`` is None.

    ``rs``: per-bath (chunk, nw, nc) standard-normal draws; ``us``:
    (chunk, nph) uniform thermal-init phases, or None for a zero start.
    Returns (final states, per-trajectory current sums over steps
    [skiplo, nsteps), finite flag as a 0-dim bool tensor).
    """
    dt, nmd = system.dt, system.nmd
    baths = tuple(b.replace(noise=sample_noise_from_r(rs[i], ev, std, dt,
                                                      nmd))
                  for i, (b, (ev, std)) in enumerate(zip(system.baths,
                                                         facs)))
    sysb = system.replace(baths=baths)
    chunk = rs[0].shape[0] if rs else us.shape[0]
    if us is None:
        states = initial_state(system, chunk)
    else:
        states = thermal_init(us, system, hw, evecs, T_init)
    if block is None:
        finals, ys = run_segment(sysb, states, nsteps, t0=t0)
    else:
        finals, ys = run_segment_blocked(sysb, states, nsteps, t0=t0,
                                         block=block)
    cur = ys["cur"]
    return finals, cur[:, skiplo:, :].sum(dim=1), torch.isfinite(cur).all()
