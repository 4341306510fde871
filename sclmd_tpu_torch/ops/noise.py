"""Quantum colored-noise synthesis (counterpart of ``sclmd_tpu.ops.noise``).

Setup stays on the host in numpy float64: the half-spectrum PSD batch
(``phonon_psd``) and its one-time eigendecomposition (``noise_factors``;
``phonon_factors`` skips the batch for a proportional friction table).
Sampling runs on torch tensors with a leading trajectory dimension:
draw x std, times the PSD eigenvectors (the half spectrum xi), folded
for the C2R transform (conj(xi) / (nmd dt), frequency axis last), then
the C2R transform itself: ``hfft(xi) / (nmd dt)``, which equals the real
part of ``fourier_w2t`` of the mirrored full spectrum at half the work.
On the card the draw, the product and the fold are kernel K3, the
transform one cuFFT plan, and the series' layout the hand transpose
(``kernels.noise_synth``).

Where the JAX package takes a ``jax.random`` key, the port takes a
``draw``: either a standard-normal tensor of the factors' shape (the
tests inject the numbers the JAX side drew) or a (seed, stream, index)
triple of the port's Philox schedule (``ops.philox``), which gives other
numbers than JAX's threefry.
"""

from __future__ import annotations

import numpy as np
import torch

from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.ops import philox
from sclmd_tpu_torch.ops.functions import (equ_spectrum, flinterp_np,
                                           hermitianize)


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


def _proportional(batch, nw: int, nc: int):
    """The one test for a frequency-proportional spectrum or friction
    table: (c, r) when every row k of ``batch`` (n, ...) is c_k R, R its
    row r of largest norm, to 1e-12 of that norm, with c_k >= -1e-15
    (returned clipped at 0); else None. It runs only for nc >= 8 and
    nw > 4 frequencies, so small baths keep the per-frequency factors."""
    if nc < 8 or nw <= 4:
        return None
    b = batch.reshape(len(batch), -1)
    norms = np.linalg.norm(b, axis=1)
    r = int(np.argmax(norms))
    if not norms[r] > 0:
        return None
    c = (b @ np.conjugate(b[r])).real / float(np.vdot(b[r], b[r]).real)
    resid = np.abs(b - c[:, None] * b[r]).max(axis=1)
    if (resid <= 1e-12 * norms[r]).all() and (c >= -1e-15).all():
        return np.clip(c, 0.0, None), r
    return None


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
    prop = _proportional(psd_np, nw, nc)
    if prop is not None:
        c, r = prop
        ev0, evec0 = np.linalg.eigh(psd_np[r])
        ev = c[:, None] * np.clip(ev0, 0.0, None)[None, :]
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


def phonon_factors(wl, gamma, gwl, T, phcut, classical: bool = False,
                   zpmotion: bool = True, delta: float = 1.0, dtype=None):
    """``noise_factors(phonon_psd(...))`` without the PSD batch where the
    friction table is proportional, Gamma(gwl_k) = c_k G with c_k >= 0
    by ``_proportional``, the test ``noise_factors`` makes of the batch
    (wideband, Debye and scalar-profile baths): the PSD is then
    s(w) herm(G) with s = d equ(w) flinterp(c)(w) >= 0, so one eigh of
    the PSD at its largest frequency (the same matrix, bit for bit, the
    batch would hold there) gives the factors, as ``noise_factors``'
    proportional branch finds them from the batch (to rounding). A
    (nw, nc, nc) batch of 864-wide baths (6 GB) is never made. Other
    tables, and baths narrower than 8, take ``noise_factors``."""
    wl = np.asarray(wl)
    gamma = np.asarray(gamma)
    nc = gamma.shape[-1]
    s = np.zeros(1)
    prop = _proportional(gamma, len(wl), nc)
    if prop is not None:
        s = delta * equ_spectrum(wl, phcut, T, classical, zpmotion) \
            * flinterp_np(wl, np.asarray(gwl), prop[0])
    r = int(np.argmax(s))
    if s[r] <= 0:
        return noise_factors(phonon_psd(wl, gamma, gwl, T, phcut, classical,
                                        zpmotion, delta=delta), dtype=dtype)
    ref = phonon_psd(wl[r:r + 1], gamma, gwl, T, phcut, classical, zpmotion,
                     delta=delta)[0].astype(np.complex128)
    ev0, evec0 = np.linalg.eigh(ref)
    std = np.sqrt((s / s[r])[:, None] * np.clip(ev0, 0.0, None)[None, :])
    if dtype is not None:
        f64 = _is_f64(dtype)
        evec0 = evec0.astype(np.complex128 if f64 else np.complex64)
        std = std.astype(np.float64 if f64 else np.float32)
    return np.broadcast_to(evec0, (len(wl), nc, nc)), std


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


def halfspectrum_from_draw(x: torch.Tensor,
                           evecs: torch.Tensor) -> torch.Tensor:
    """Half spectrum xi(w) = U(w) x(w) of the scaled draw ``x`` (...,
    hlen+1, nc): ``evecs`` one (nc, nc) matrix or an (hlen+1, nc, nc)
    batch. Each trajectory's rows are summed the same way for any number
    of trajectories, so chunked ensembles stay bitwise equal on the CPU:
    one matrix folds into one product of (traj x hlen+1) rows, never
    fewer than four for nmd >= 6 (below four the CPU BLAS takes another
    path); a batch is one batched matrix-vector product per trajectory
    (a broadcast product would copy the batch once per trajectory)."""
    x = x.to(evecs.dtype)
    if evecs.ndim == 2:
        return (evecs @ x.unsqueeze(-1)).squeeze(-1)
    rows = x.reshape((-1,) + x.shape[-2:])
    return torch.stack([(evecs @ xt.unsqueeze(-1)).squeeze(-1)
                        for xt in rows]).reshape(x.shape)


def drop_edge_imag_(xi_pos: torch.Tensor) -> torch.Tensor:
    """Zero, in place, the imaginary parts of the first and last rows
    (w = 0 and nmd/2) of a half spectrum (..., hlen+1, nc): the real
    series does not keep them, and cuFFT's C2R transform (on the card)
    does not drop them. Returns ``xi_pos``."""
    xi_pos[..., 0, :].imag.zero_()
    xi_pos[..., -1, :].imag.zero_()
    return xi_pos


def fold_halfspectrum(xi_pos: torch.Tensor, scale: float) -> torch.Tensor:
    """K3's output convention: conj(xi_pos) scale with the frequency axis
    last, (..., hlen+1, nc) -> (..., nc, hlen+1) contiguous, the input of
    ``series_from_halfspectrum``."""
    return (torch.conj(xi_pos) * scale).transpose(-1, -2).contiguous()


def series_from_halfspectrum(y: torch.Tensor, nmd: int) -> torch.Tensor:
    """Real (..., nmd, nc) series of a folded half spectrum y (..., nc,
    hlen+1) (``fold_halfspectrum``, as K3 writes it): the C2R transform
    along the last axis with no normalisation, which for y = conj(xi) /
    (nmd dt) is ``hfft(xi) / (nmd dt)``, the real part of ``fourier_w2t``
    of ``mirror_halfspectrum(xi)``, then the last two axes swapped. The
    imaginary parts at frequencies 0 and hlen must be zero
    (``drop_edge_imag_``). One cuFFT plan (on a copy: y stays as it was)
    and the hand transpose on the card, ``irfft`` on the CPU."""
    from sclmd_tpu_torch.kernels.noise_synth import c2r_series
    _check_even(nmd)
    return c2r_series(y, nmd)


def synthesize_series(xi_pos: torch.Tensor, dt: float,
                      nmd: int) -> torch.Tensor:
    """Real (..., nmd, nc) series of the half spectrum xi_pos (...,
    hlen+1, nc): its edge rows' imaginary parts dropped, folded, and the
    C2R transform."""
    _check_even(nmd)
    return series_from_halfspectrum(fold_halfspectrum(
        drop_edge_imag_(xi_pos), 1.0 / (nmd * dt)), nmd)


def sample_noise_from_r(r: torch.Tensor, evecs: torch.Tensor,
                        std: torch.Tensor, dt: float,
                        nmd: int) -> torch.Tensor:
    """Real (..., nmd, nc) noise series from standard-normal draws ``r``
    (..., hlen+1, nc): xi(w) = U(w) (r std), then the Hermitian C2R
    transform. ``evecs`` is one (nc, nc) matrix (proportional spectrum) or
    an (hlen+1, nc, nc) batch; leading dims of ``r`` are trajectories."""
    return synthesize_series(halfspectrum_from_draw(r * std, evecs), dt, nmd)


def schedule_noise(evecs: torch.Tensor, std: torch.Tensor, seed: int,
                   stream: int, lo: int, hi: int, dt: float, nmd: int,
                   packed: tuple = None) -> torch.Tensor:
    """(hi-lo, nmd, nc) series of trajectories [lo, hi) of the schedule's
    stream: kernel K3 (``packed``: its operands, ``Factors.packed`` of
    ``kernels.noise_synth``), a cuFFT C2R plan run in place on K3's
    buffer and the hand transpose on the card, the twin on the CPU."""
    from sclmd_tpu_torch.kernels.noise_synth import (c2r_series,
                                                     noise_halfspectrum)
    _check_even(nmd)
    return c2r_series(noise_halfspectrum(
        evecs, std, seed, stream, lo, hi, 1.0 / (nmd * dt), packed=packed),
        nmd, consume=True)


def _normals(draw, shape, device) -> torch.Tensor:
    """Standard normals of ``shape``: an injected tensor as it is, or a
    (seed, stream, index) triple drawn from the Philox schedule (float64,
    as the twin draws)."""
    if torch.is_tensor(draw):
        if tuple(draw.shape) != tuple(shape):
            raise ValueError(f"draw of shape {tuple(draw.shape)}, expected "
                             f"{tuple(shape)}")
        return draw
    seed, stream, index = draw
    n = int(np.prod(shape))
    return philox.normals(seed, stream, index, index + 1, n,
                          device).reshape(shape)


def _factor_tensors(evecs, std):
    """(evecs, std) as tensors on std's device; host factors as
    ``noise_factors`` gives them ship their single matrix when the
    spectrum is proportional."""
    std = torch.as_tensor(np.asarray(std)) if not torch.is_tensor(std) \
        else std
    ev = evecs if torch.is_tensor(evecs) else torch.as_tensor(
        factor_matrix(evecs))
    return ev.to(std.device), std


def halfspectrum_freqs(dt: float, nmd: int, dtype=torch.float32,
                       device="cpu") -> torch.Tensor:
    """Positive-frequency grid w_i = i * dw, i = 0..nmd/2."""
    _check_even(nmd)
    dw = 2.0 * np.pi / dt / nmd
    return dw * torch.arange(nmd // 2 + 1, dtype=dtype, device=device)


def sample_noise(draw, evecs, std, dt: float, nmd: int) -> torch.Tensor:
    """Real (nmd, nc) noise series of one trajectory from the factors
    (``evecs`` as ``noise_factors`` gives them, or the single matrix of a
    proportional spectrum)."""
    _check_even(nmd)
    ev, std = _factor_tensors(evecs, std)
    r = _normals(draw, std.shape, std.device).to(std.dtype)
    return sample_noise_from_r(r, ev, std, dt, nmd)


def sample_noise_np(rng: np.random.Generator, evecs, std, dt: float,
                    nmd: int) -> np.ndarray:
    """Host NumPy sampler (float64): the JAX package's
    ``sample_noise_np``, copied."""
    _check_even(nmd)
    evecs = np.asarray(evecs)
    std = np.asarray(std, np.float64)
    r = rng.standard_normal(std.shape) * std
    xi_pos = np.einsum("wij,wj->wi", evecs.astype(np.complex128), r)
    hlen = nmd // 2
    neg = np.conjugate(xi_pos[1:hlen + 1][::-1])
    xi = np.concatenate([xi_pos[:hlen], neg], axis=0)
    return np.real(np.fft.fft(xi, axis=0) / (nmd * dt))


def sample_from_psd(draw, psd) -> torch.Tensor:
    """Frequency-domain noise xi(w) = U(w) (std(w) r(w)) from the PSD
    batch (nw, nc, nc): r real standard normals, std the square roots of
    the eigenvalues clipped at zero. The eigendecomposition runs on the
    host in numpy float64, as the port's setup does (LAPACK's, the same
    eigenvectors as the JAX package's ``eigh``; MKL's differ in phase)."""
    psd_np = psd.detach().cpu().numpy() if torch.is_tensor(psd) \
        else np.asarray(psd)
    ev, evec = np.linalg.eigh(psd_np)
    rdt = np.float64 if psd_np.dtype == np.complex128 else np.float32
    std = torch.as_tensor(np.sqrt(np.clip(ev, 0.0, None)).astype(rdt))
    r = _normals(draw, std.shape, "cpu").to(std.dtype)
    return halfspectrum_from_draw(r * std, torch.as_tensor(evec))


def synthesize(draw, psd, dt: float, nmd: int) -> torch.Tensor:
    """Real (nmd, nc) series from the half-spectrum PSD batch."""
    _check_even(nmd)
    return synthesize_series(sample_from_psd(draw, psd), dt, nmd)


def enoise(draw, efric, exim, exip, bias, T, ecut, dt, nmd,
           classical: bool = False, zpmotion: bool = True) -> torch.Tensor:
    """Electron colored-noise series (nmd, nc)."""
    rdt = np.asarray(efric).dtype
    wl = halfspectrum_freqs(dt, nmd, dtype=torch.float64).numpy().astype(rdt)
    psd = electron_psd(wl, efric, exim, exip, bias, T, ecut, classical,
                       zpmotion, dt * nmd)
    return synthesize(draw, psd, dt, nmd)


def phnoise(draw, gamma, gwl, T, phcut, dt, nmd, classical: bool = False,
            zpmotion: bool = True) -> torch.Tensor:
    """Phonon colored-noise series (nmd, nc)."""
    rdt = np.asarray(gamma).dtype
    wl = halfspectrum_freqs(dt, nmd, dtype=torch.float64).numpy().astype(rdt)
    psd = phonon_psd(wl, gamma, gwl, T, phcut, classical, zpmotion,
                     dt * nmd)
    return synthesize(draw, psd, dt, nmd)


def enoisew(wl, efric, exim, exip, bias, T, ecut, classical: bool = False,
            zpmotion: bool = True) -> np.ndarray:
    """Electron-bath PSD on an arbitrary grid, no Dirac factor."""
    return electron_psd(wl, efric, exim, exip, bias, T, ecut, classical,
                        zpmotion, delta=1.0)


def phnoisew(gamma, wl, T, phcut, classical: bool = False,
             zpmotion: bool = True) -> np.ndarray:
    """Scalar-gamma phonon noise spectrum equ(w) gamma(w)."""
    return equ_spectrum(np.asarray(wl), phcut, T, classical, zpmotion) * \
        np.asarray(gamma)


def mf(f: torch.Tensor, cats, lens: int) -> torch.Tensor:
    """Scatter a bath-local vector into the full-DOF vector."""
    out = torch.zeros((lens,), dtype=f.dtype, device=f.device)
    out[torch.as_tensor(np.asarray(cats), device=f.device)] = f
    return out


def sample_noise_window(draw, evecs, std, dt: float, nmd: int, t0: int,
                        seg: int, fchunk: int = 2048) -> torch.Tensor:
    """Rows [t0, t0+seg) of the series ``sample_noise`` gives for the same
    draw, without the full (nmd, nc) series: the inverse transform on the
    window's rows as a paired-frequency sum,

        x_k = [Re xi_0 + (-1)^k Re xi_h
               + 2 sum_{m=1}^{h-1} (Re xi_m cos(th k m) + Im xi_m sin(th k m))]
              / (nmd dt),

    th = 2 pi / nmd, h = nmd / 2, over frequency slices of ``fchunk``. The
    phase k m mod nmd is exact: int64 products masked with nmd - 1, so
    ``nmd`` must be a power of two. Plain torch (its kernel, K4, is still
    to be written); leading dims of an injected draw are trajectories."""
    _check_even(nmd)
    if nmd & (nmd - 1):
        raise ValueError(f"sample_noise_window needs power-of-two nmd "
                         f"(got {nmd}) for exact phase wrapping")
    hlen = nmd // 2
    ev, std = _factor_tensors(evecs, std)
    rdt = std.dtype
    shape = tuple(draw.shape) if torch.is_tensor(draw) else tuple(std.shape)
    r = _normals(draw, shape, std.device).to(rdt)
    xi = halfspectrum_from_draw(r * std, ev)
    xr, xim = xi.real.to(rdt), xi.imag.to(rdt)
    ks = int(t0) + torch.arange(seg, dtype=torch.int64, device=std.device)
    theta = 2.0 * np.pi / nmd
    sign = torch.where(ks % 2 == 0, 1.0, -1.0).to(rdt)
    acc = xr[..., :1, :] + sign[:, None] * xr[..., hlen:hlen + 1, :]
    for m0 in range(1, hlen, fchunk):
        m1 = min(m0 + fchunk, hlen)
        ms = torch.arange(m0, m1, dtype=torch.int64, device=std.device)
        ph = theta * ((ks[:, None] * ms[None, :]) & (nmd - 1)).to(rdt)
        acc = acc + 2.0 * (torch.cos(ph) @ xr[..., m0:m1, :]
                           + torch.sin(ph) @ xim[..., m0:m1, :])
    return acc / (nmd * dt)
