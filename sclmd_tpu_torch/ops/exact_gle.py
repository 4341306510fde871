"""The one-step linearisation of the plain GLE step (counterpart of
``sclmd_tpu.ops.exact_gle.linearize_step``, its A only).

For a harmonic system the step is affine in the state and the noise, so
at zero noise it is linear: A e_i is one step of the basis state e_i.
The port gets A by stepping all n basis states once, as one batch of n
trajectories of ``md.run_segment`` in float64 on the CPU: the integrator
that runs, not a model of it. The JAX package takes the same matrix from
``jax.jacfwd`` of its ``vv_step``. The noise operators B0, B1 and the
exact attractor currents are still to be ported (ROADMAP queue 1
item 6).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f64(x):
    if not torch.is_tensor(x):
        return x
    return x.detach().to("cpu", torch.complex128 if x.is_complex()
                         else torch.float64)


def cpu_f64_system(system):
    """The system with every tensor in float64 (complex128) on the CPU and
    no noise attached. A float32 system's matrices keep their float32
    values, the ones its run uses."""
    if system.force_fn is not None or system.dyn is None:
        raise ValueError("the linearisation needs the harmonic force "
                         "(-dyn q): a force driver's step is not affine")
    baths = []
    for b in system.baths:
        mats = {f.name: _f64(getattr(b, f.name))
                for f in dataclasses.fields(b)
                if torch.is_tensor(getattr(b, f.name)) and f.name != "noise"}
        baths.append(b.replace(noise=None, **mats))
    return system.replace(dyn=_f64(system.dyn), mask=_f64(system.mask),
                          baths=tuple(baths), savep=False, saveq=False,
                          savef=False, cf_fn=None)


def linearize_step(system) -> np.ndarray:
    """A (n, n), n = (3 + ml) nph: one zero-noise plain step in the
    ``md.state_ravel`` basis [p, q, phis, qhis], host float64. The noise
    is two zero rows (a step reads rows t and t+1 only)."""
    from sclmd_tpu_torch.md import run_segment, state_ravel, state_unravel

    sys0 = cpu_f64_system(system)
    n = (3 + sys0.ml) * sys0.nph
    sys0 = sys0.replace(nmd=2, baths=tuple(
        b.replace(noise=torch.zeros((n, 2, b.nc), dtype=torch.float64))
        for b in sys0.baths))
    basis = state_unravel(np.eye(n), sys0, dtype=torch.float64)
    new, _ = run_segment(sys0, basis, 1, t0=0)
    return np.ascontiguousarray(state_ravel(new).T)
