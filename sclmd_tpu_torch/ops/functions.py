"""Core numerics of the GLE slice (counterpart of ``sclmd_tpu.ops.functions``).

Conventions follow the JAX package exactly; they are load-bearing for
conductance and pinned by golden-value tests, so none is "fixed":

* Fourier pair: F^-1(t) = int f(w) e^{-iwt} dw/2pi -> ``fft(a) / (N dt)``.
* Bose edges: T=0 gives -1 for w<0 and 0 for w>=0; T>0 gives 0 at w=0.
* ``flinterp_np`` anchors on the nearest grid point and takes its slope
  toward the neighbour on the side of x, clamping at both grid ends.

Host-side setup helpers (``bose``, ``fermi``, ``equ_spectrum``,
``nonequ_spectrum``, ``flinterp_np``, ``hermitianize``, ``nearest``) are
numpy float64 (``bose``/``fermi`` are the JAX package's ``xp=np``
forms, which the Lambda pipeline calls); the runtime helpers
(``fourier_w2t``/``fourier_t2w``, ``myfft``, ``coth``/``xcoth``,
``flinterp``, ``mdot``, ``dagger``, ``powerspecp``/``powerspecq``,
``rpadleft``) take torch tensors (numpy arrays are converted);
``chkShape``/``symmetrize``/``antisymmetrize`` take either.
"""

from __future__ import annotations

import numpy as np
import torch

from sclmd_tpu_torch import units as U


def fourier_t2w(a: torch.Tensor, dt: float, dim: int = 0) -> torch.Tensor:
    """f(w) = int f(t) e^{iwt} dt = ``ifft(a) * N dt``."""
    n = a.shape[dim]
    return torch.fft.ifft(a, dim=dim) * (n * dt)


def fourier_w2t(a: torch.Tensor, dt: float, dim: int = 0) -> torch.Tensor:
    """f(t) = int f(w) e^{-iwt} dw / 2pi = ``fft(a) / (N dt)``."""
    n = a.shape[dim]
    return torch.fft.fft(a, dim=dim) / (n * dt)


class myfft:
    """Object-style wrapper of the Fourier pair with the reference's
    ``myfft`` API (length checked against ``n``)."""

    def __init__(self, dt: float, n: int):
        self.dt = dt
        self.N = n
        self.dw = 2.0 * np.pi / dt / n

    def _checked(self, a, who):
        a = torch.as_tensor(a)
        if a.shape[0] != self.N:
            raise ValueError(f"myfft.{who}: array length error")
        return a

    def Fourier1D(self, a):
        return fourier_t2w(self._checked(a, "Fourier1D"), self.dt, dim=0)

    def iFourier1D(self, a):
        return fourier_w2t(self._checked(a, "iFourier1D"), self.dt, dim=0)


def coth(x):
    x = torch.as_tensor(x)
    return torch.cosh(x) / torch.sinh(x)


def xcoth(x):
    """x coth(x) with the x = 0 limit equal to 1."""
    x = torch.as_tensor(x)
    safe = torch.where(x == 0.0, torch.ones_like(x), x)
    return torch.where(x == 0.0, torch.ones_like(x),
                       safe * torch.cosh(safe) / torch.sinh(safe))


def bose(w, T):
    """Bose-Einstein occupation with the reference's edge conventions
    (numpy, vectorised in ``w`` and ``T``)."""
    w = np.asarray(w, dtype=np.result_type(float, w))
    T = np.asarray(T, dtype=w.dtype)
    t_zero = T == 0.0
    b0 = np.where(w < 0.0, -1.0, 0.0)
    T_safe = np.where(t_zero, 1.0, T)
    with np.errstate(over="ignore"):
        x = w / (U.KB * T_safe)
        x_safe = np.where(w == 0.0, 1.0, x)
        bT = np.where(w == 0.0, 0.0, 1.0 / np.expm1(x_safe))
    return np.where(t_zero, b0, bT)


def fermi(ep, mu, T):
    """Fermi-Dirac occupation; at T=0 a step with 0.5 at ``mu`` (numpy)."""
    ep = np.asarray(ep, dtype=np.result_type(float, ep))
    T = np.asarray(T, dtype=ep.dtype)
    t_zero = T == 0.0
    f0 = np.where(ep < mu, 1.0, np.where(ep > mu, 0.0, 0.5))
    T_safe = np.where(t_zero, 1.0, T)
    with np.errstate(over="ignore"):
        fT = 1.0 / (np.exp((ep - mu) / (U.KB * T_safe)) + 1.0)
    return np.where(t_zero, f0, fT)


def equ_spectrum(w, cut, T, classical: bool = False, zpmotion: bool = True):
    """Equilibrium noise weight 2 hw (n_B(hw,T) + zp) with the strict
    ``hw < cut`` band window; 2 kT in the classical limit and at w=0."""
    w = np.asarray(w, dtype=np.result_type(float, w))
    hw = U.HBAR * w
    inside = hw < cut
    if classical:
        val = np.full_like(hw, 2.0 * U.KB) * T
    else:
        zp = 0.5 if zpmotion else 0.0
        quantum = 2.0 * hw * (zp + bose(hw, T))
        val = np.where(hw == 0.0, 2.0 * U.KB * T, quantum)
    return np.where(inside, val, 0.0)


def nonequ_spectrum(w, bias, T, sign: int, classical: bool = False):
    """Bias-shifted nonequilibrium weight 2 (hw + sign V) (n(hw + sign V)
    - n(hw)), ``sign`` -1 or +1 (numpy)."""
    w = np.asarray(w, dtype=np.result_type(float, w))
    hw1 = U.HBAR * w + sign * bias
    hw2 = U.HBAR * w
    if classical:
        small = 10e-20
        hw1s = np.where(hw1 == 0.0, small, hw1)
        hw2s = np.where(hw2 == 0.0, small, hw2)
        return 2.0 * hw1s * (U.KB * T / hw1s - U.KB * T / hw2s)
    return 2.0 * hw1 * (bose(hw1, T) - bose(hw2, T))


def flinterp_np(x, xs, ys):
    """Nearest-anchored linear interpolation of ``ys`` (n, ...) on grid
    ``xs`` at the points ``x``; slope term (ys[i]-ys[j])/(xs[i]-xs[j])
    as in the reference."""
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    x = np.atleast_1d(np.asarray(x, dtype=float))
    n = xs.shape[0]
    i = np.argmin(np.abs(xs[None, :] - x[:, None]), axis=1)
    dd = x - xs[i]
    j = np.clip(np.where(dd < 0, i - 1, i + 1), 0, n - 1)
    denom = xs[i] - xs[j]
    denom = np.where(denom == 0.0, 1.0, denom)
    extra = (Ellipsis,) + (None,) * (ys.ndim - 1)
    val = ys[i] + (dd / denom)[extra] * (ys[i] - ys[j])
    edge = (i == 0) | (i == n - 1)
    val[edge] = ys[i[edge]]
    return val


def flinterp(x, xs, ys):
    """Torch form of ``flinterp_np`` (the JAX package's device form):
    ``x`` a scalar or a vector, ``ys`` (n, ...) with trailing matrix
    dimensions; a scalar ``x`` gives one row."""
    xs = torch.as_tensor(xs)
    ys = torch.as_tensor(ys, device=xs.device)
    xv = torch.as_tensor(x, dtype=xs.dtype, device=xs.device)
    scalar = xv.ndim == 0
    xv = xv.reshape(-1)
    n = xs.shape[0]
    i = torch.argmin((xs[None, :] - xv[:, None]).abs(), dim=1)
    dd = xv - xs[i]
    j = torch.where(dd < 0, i - 1, i + 1).clamp(0, n - 1)
    denom = xs[i] - xs[j]
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    extra = (Ellipsis,) + (None,) * (ys.ndim - 1)
    val = ys[i] + (dd / denom)[extra] * (ys[i] - ys[j])
    edge = ((i == 0) | (i == n - 1))[extra]
    out = torch.where(edge, ys[i], val)
    return out[0] if scalar else out


def nearest(b, bs):
    """Index of the element of ``bs`` closest to ``b``."""
    return int(np.argmin(np.abs(np.asarray(bs) - b)))


def mdot(*args):
    """The matrix product of the arguments, left to right."""
    out = torch.as_tensor(args[0])
    for m in args[1:]:
        out = out @ torch.as_tensor(m)
    return out


# the reference's alias
mm = mdot


def dagger(a):
    """The conjugate transpose of a matrix."""
    return torch.as_tensor(a).conj().T


def hermitianize(a):
    """0.5 (A + A^dagger), batched over leading axes (numpy)."""
    a = np.asarray(a)
    return 0.5 * (a + np.conjugate(np.swapaxes(a, -1, -2)))


def chkShape(a) -> int:
    """Side of a square matrix; raises for anything else."""
    a = a if torch.is_tensor(a) else np.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError("matrix must be square, got shape %s"
                         % (tuple(a.shape),))
    return a.shape[0]


def symmetrize(a):
    """0.5 (A + A^T) of a numpy array or a torch tensor."""
    return 0.5 * (a + a.T)


def antisymmetrize(a):
    """0.5 (A - A^T) of a numpy array or a torch tensor."""
    return 0.5 * (a - a.T)


def _power(x: torch.Tensor, dt: float, nmd: int, name: str):
    if x.shape[0] != nmd:
        raise ValueError(f"{name}: shape error")
    xw = fourier_t2w(x, dt, dim=0)
    mag = (xw.real ** 2 + xw.imag ** 2).sum(dim=1) / (dt * nmd)
    w = 2.0 * np.pi / dt / nmd * torch.arange(nmd, dtype=x.dtype,
                                              device=x.device)
    return w, mag


def powerspecp(ps: torch.Tensor, dt: float, nmd: int) -> torch.Tensor:
    """Velocity power spectrum of ``ps`` (nmd, nph): (nmd, 2) rows of
    [w_i, sum_dof |v(w_i)|^2 / (dt nmd)]."""
    w, mag = _power(ps, dt, nmd, "powerspecp")
    return torch.stack([w, mag], dim=1)


def powerspecq(qs: torch.Tensor, dt: float, nmd: int) -> torch.Tensor:
    """Displacement power spectrum: rows of [w_i, w_i^2 |q(w_i)|^2 / (dt nmd)]."""
    w, mag = _power(qs, dt, nmd, "powerspecq")
    return torch.stack([w, w ** 2 * mag], dim=1)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-wise ``a @ x[i]`` for a batch x (traj, n). Written as a
    batched matrix product so every row is summed the same way for any
    batch of two or more rows (a plain ``x @ a.T`` takes another BLAS
    path below four rows), which keeps chunked ensembles bitwise equal
    to unchunked ones on the CPU."""
    return (a @ x.unsqueeze(-1)).squeeze(-1)


def rpadleft(hist: torch.Tensor, newest: torch.Tensor,
             dim: int = 0) -> torch.Tensor:
    """Push ``newest`` onto the front of a newest-first ring along
    ``dim`` (the oldest entry drops off)."""
    newest = newest.unsqueeze(dim)
    if hist.shape[dim] == 1:
        return newest
    return torch.cat([newest, hist.narrow(dim, 0, hist.shape[dim] - 1)],
                     dim=dim)
