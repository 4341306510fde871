"""Quantum colored-noise synthesis (counterpart of ``sclmd_tpu.ops.noise``).

Setup stays on the host in numpy float64: the half-spectrum PSD batch
(``phonon_psd``) and its one-time eigendecomposition (``noise_factors``).
Sampling runs on torch tensors with a leading trajectory dimension:
draw x std, times the PSD eigenvectors, Hermitian mirror to the full
spectrum, then ``fourier_w2t``. The Gaussian draw ``r`` is an argument
of the sampler core, so tests feed the JAX package and the port the
same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.ops.functions import (equ_spectrum, flinterp_np,
                                           fourier_w2t, hermitianize)


def _check_even(nmd: int):
    if nmd % 2 != 0:
        raise ValueError(
            f"nmd must be even for the Hermitian-mirror noise synthesis "
            f"(got {nmd})")


def _is_f64(dtype) -> bool:
    """True for a float64 numpy or torch dtype."""
    return dtype in (torch.float64, np.float64) or \
        (isinstance(dtype, np.dtype) and dtype == np.float64)


def phonon_psd(wl, gamma, gwl, T, phcut, classical: bool = False,
               zpmotion: bool = True, delta: float = 1.0) -> np.ndarray:
    """Phonon-bath noise PSD d * equ(w) * Gamma(w) on the grid ``wl``:
    a complex Hermitian (nw, nc, nc) batch, Gamma interpolated from
    (gwl, gamma) with the nearest-anchored scheme."""
    wl = np.asarray(wl)
    gamma = np.asarray(gamma)
    aw = delta * equ_spectrum(wl, phcut, T, classical, zpmotion)
    gw = flinterp_np(wl, np.asarray(gwl), gamma)
    cplx = np.result_type(gamma.dtype, np.complex64)
    return hermitianize((aw[..., None, None] * gw).astype(cplx))


def electron_psd(wl, efric, exim, exip, bias, T, ecut,
                 classical: bool = False, zpmotion: bool = True,
                 delta: float = 1.0) -> np.ndarray:
    """Electron-bath noise PSD on the grid ``wl``: the equilibrium part
    a(w) efric plus the bias-shifted parts (-a(w) + (a(w-V) + a(w+V))/2)
    exip + i (a(w-V) - a(w+V))/2 exim, with a = d * equ(w); a complex
    Hermitian (nw, nc, nc) batch (numpy)."""
    wl = np.asarray(wl)
    efric, exip, exim = (np.asarray(m) for m in (efric, exip, exim))
    aw = delta * equ_spectrum(wl, ecut, T, classical, zpmotion)
    awm = delta * equ_spectrum(wl - bias / U.HBAR, ecut, T, classical,
                               zpmotion)
    awp = delta * equ_spectrum(wl + bias / U.HBAR, ecut, T, classical,
                               zpmotion)
    aw_, awm_, awp_ = (x[..., None, None] for x in (aw, awm, awp))
    cplx = np.result_type(efric.dtype, np.complex64)
    amat = (aw_ * efric
            + (-aw_ + 0.5 * (awm_ + awp_)) * exip
            + 0.5j * (awm_ - awp_) * exim.astype(cplx))
    return hermitianize(amat.astype(cplx))


def noise_factors(psd, dtype=None):
    """Host float64 factorisation of the PSD batch: (evecs, std).

    std = sqrt(clip(eigenvalues, 0)). When the batch is frequency-
    PROPORTIONAL, S(w) = c(w) S_ref (wideband, Debye and scalar-profile
    baths), ONE nc x nc eigh replaces nw of them and ``evecs`` is a
    zero-stride broadcast view of that single matrix; the check runs
    only for nc >= 8, so small baths keep the per-frequency factors.
    ``dtype`` (float32/float64, numpy or torch) sets the output
    precision; complex64 eigenvectors go with float32.
    """
    psd_np = np.asarray(psd).astype(np.complex128)
    nw, nc = psd_np.shape[0], psd_np.shape[-1]
    cplx = np.complex128 if dtype is None or _is_f64(dtype) \
        else np.complex64
    rdt = np.float64 if dtype is None or _is_f64(dtype) else np.float32
    if nc >= 8 and nw > 4:
        norms = np.linalg.norm(psd_np.reshape(nw, -1), axis=1)
        r = int(np.argmax(norms))
        if norms[r] > 0:
            ref = psd_np[r]
            ref2 = float(np.vdot(ref, ref).real)
            c = np.real(np.einsum("wij,ij->w", psd_np, np.conjugate(ref))
                        ) / ref2
            resid = psd_np - c[:, None, None] * ref[None]
            tol = 1e-12 * norms[r]
            if (np.abs(resid).reshape(nw, -1).max(axis=1)
                    <= np.maximum(tol, 1e-13 * norms[r])).all() \
                    and (c >= -1e-15).all():
                ev0, evec0 = np.linalg.eigh(ref)
                ev = np.clip(c, 0.0, None)[:, None] * \
                    np.clip(ev0, 0.0, None)[None, :]
                std = np.sqrt(ev)
                if dtype is not None:
                    evec0 = evec0.astype(cplx)
                    std = std.astype(rdt)
                return np.broadcast_to(evec0, psd_np.shape), std
    ev, evec = np.linalg.eigh(psd_np)
    std = np.sqrt(np.clip(ev, 0.0, None))
    if dtype is not None:
        return evec.astype(cplx), std.astype(rdt)
    return evec, std


def factor_matrix(evecs) -> np.ndarray:
    """The factor to ship to the device: the single (nc, nc) matrix when
    ``evecs`` is the zero-stride broadcast of a proportional spectrum,
    else the (nw, nc, nc) batch. Never materialises nw copies."""
    ev = np.asarray(evecs)
    if ev.ndim == 3 and ev.strides[0] == 0:
        return np.array(ev[0])
    return np.array(ev)


def mirror_halfspectrum(xi_pos: torch.Tensor, nmd: int,
                        dim: int = -2) -> torch.Tensor:
    """Full nmd-point spectrum from the hlen+1 positive-frequency rows
    along ``dim``: [xi_0 .. xi_{h-1}, conj(xi_h), conj(xi_{h-1}), ..,
    conj(xi_1)]."""
    hlen = nmd // 2
    neg = torch.conj(xi_pos.narrow(dim, 1, hlen).flip(dim))
    return torch.cat([xi_pos.narrow(dim, 0, hlen), neg], dim=dim)


def sample_noise_from_r(r: torch.Tensor, evecs: torch.Tensor,
                        std: torch.Tensor, dt: float,
                        nmd: int) -> torch.Tensor:
    """Real (..., nmd, nc) noise series from standard-normal draws ``r``
    (..., hlen+1, nc): xi(w) = U(w) (r std), mirrored, then
    ``fourier_w2t``. ``evecs`` is one (nc, nc) matrix (proportional
    spectrum) or an (hlen+1, nc, nc) batch; leading dims of ``r`` are
    trajectories."""
    _check_even(nmd)
    x = (r * std).to(evecs.dtype)
    if evecs.ndim == 2:
        xi_pos = x @ evecs.transpose(0, 1)
    else:
        xi_pos = torch.einsum("wij,...wj->...wi", evecs, x)
    xi = mirror_halfspectrum(xi_pos, nmd, dim=-2)
    return torch.real(fourier_w2t(xi, dt, dim=-2)).contiguous()
