"""Structure relaxation over a differentiable energy function
(counterpart of ``sclmd_tpu.models.relax``): FIRE (Bitzek et al., PRL 97,
170201 (2006)) and L-BFGS with a strong-Wolfe line search.

Set-up work, always float64 on the CPU: in float32 a line search stalls
near fmax ~ 0.1 eV/Ang, where energy differences fall below the
resolution of a keV total energy. The energy function takes positions
(na, 3) in angstrom (see ``models.driver``) and serves any device, so a
driver built for the card relaxes here all the same.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _free_mask(shape, fixed_mask) -> np.ndarray:
    return (np.ones(shape, bool) if fixed_mask is None
            else ~np.asarray(fixed_mask, bool))


def _energy_and_grad(energy_fn, x: torch.Tensor):
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        e = energy_fn(x)
        g, = torch.autograd.grad(e, x)
    return e.detach(), g


def fire_relax(energy_fn: Callable, x0, tol: float = 1e-4,
               maxit: int = 5000, dt0: float = 0.02,
               dtmax_factor: float = 10.0, fixed_mask=None):
    """Minimise ``energy_fn(x)`` from x0 ((na, 3) Ang) with FIRE.

    Returns (x_relaxed (na, 3) numpy, fmax eV/Ang, iterations). ``tol``
    bounds the largest force component; ``fixed_mask`` (na, 3) True
    entries are held frozen. The standard schedule: f_inc=1.1, f_dec=0.5,
    alpha0=0.1, f_alpha=0.99, N_min=5; one force evaluation per
    iteration.
    """
    x0 = np.asarray(x0, float)
    free = torch.as_tensor(_free_mask(x0.shape, fixed_mask),
                           dtype=torch.float64)
    f_inc, f_dec, alpha0, f_alpha, n_min = 1.1, 0.5, 0.1, 0.99, 5
    dtmax = dtmax_factor * dt0

    def force(x):
        return -_energy_and_grad(energy_fn, x)[1] * free

    x = torch.as_tensor(x0, dtype=torch.float64)
    v = torch.zeros_like(x)
    f = force(x)
    dt, alpha, npos, it = dt0, alpha0, 0, 0
    while float(f.abs().max()) > tol and it < maxit:
        p = float((f * v).sum())
        if p <= 0.0:
            v = torch.zeros_like(v)
            dt, alpha, npos = dt * f_dec, alpha0, 0
        else:
            fnorm = float(f.norm()) + 1e-30
            v = (1.0 - alpha) * v + alpha * f * (float(v.norm()) / fnorm)
            if npos > n_min:
                dt, alpha = min(dt * f_inc, dtmax), alpha * f_alpha
            npos += 1
        # semi-implicit Euler step
        v = v + dt * f
        x = x + dt * v * free
        f = force(x)
        it += 1
    return x.numpy().reshape(x0.shape), float(f.abs().max()), it


def lbfgs_relax(energy_fn: Callable, x0, tol: float = 1e-4,
                maxit: int = 1000, fixed_mask=None,
                memory_size: int = 20):
    """Minimise ``energy_fn(x)`` with L-BFGS and a strong-Wolfe line
    search (``torch.optim.LBFGS``, one iteration per step), over the free
    coordinates only. Same contract as :func:`fire_relax`; far fewer
    iterations on landscapes that mix stiff and soft directions (C-H
    stretches against ribbon bending), at a few energy and gradient
    evaluations per iteration."""
    x0 = np.asarray(x0, float)
    shape = x0.shape
    idx = torch.as_tensor(np.nonzero(_free_mask(shape, fixed_mask).ravel())[0])
    base = torch.as_tensor(x0.ravel(), dtype=torch.float64)

    def fun(p):
        return energy_fn(base.index_put((idx,), p).reshape(shape))

    p = base[idx].clone().requires_grad_(True)
    # (max_eval bounds the line search's evaluations of one iteration;
    # its default of max_iter * 5 // 4 would leave the search none)
    opt = torch.optim.LBFGS([p], lr=1.0, max_iter=1, max_eval=26,
                            history_size=memory_size, tolerance_grad=0.0,
                            tolerance_change=0.0,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        e = fun(p)
        e.backward()
        return e

    def fmax_of():
        return float(_energy_and_grad(fun, p)[1].abs().max()) \
            if len(idx) else 0.0

    fmax, it = fmax_of(), 0
    while fmax > tol and it < maxit:
        opt.step(closure)
        fmax = fmax_of()
        it += 1
    x = base.index_put((idx,), p.detach()).numpy().reshape(shape)
    return x, fmax, it
