"""Phonon baths (counterpart of ``sclmd_tpu.baths``, ``PhBath`` only).

A bath is a small dataclass: host numpy float64 setup data (Gamma
table, PSD noise factors) plus torch tensors for what the hot loop
reads (the memory kernel, and a (traj, nmd, nc) noise batch once
attached). The factory ``phbath`` runs entirely on the host in numpy,
as in the JAX package.

Not ported yet (ROADMAP queue 1): ``EBath``/``ebath``, and the
K00/K01/V01 lead-block mode of ``phbath`` that needs the decimation
self-energy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch.ops import noise as NZ
from sclmd_tpu_torch.ops.functions import flinterp_np


def _contig_start(cats_np: np.ndarray):
    """Start offset if cats is the ascending contiguous range
    [c0, c0+nc), else None."""
    if len(cats_np) == 0:
        return None
    c0 = int(cats_np[0])
    if np.array_equal(cats_np, np.arange(c0, c0 + len(cats_np))):
        return c0
    return None


def gamt(tl, wl, gwl, gam, eta_ad: float = 0.0) -> np.ndarray:
    """Friction kernel K(t) from Gamma(w) by direct cosine sum (numpy):
    K(t) = (2/pi) wmax mean_w[Gamma(w) cos(wt)] over the bath's ``wl``
    grid, with Gamma interpolated from (gwl, gam); ``eta_ad`` != 0 adds
    the artificial damping e^{-eta t} with w/(w -+ i eta) weights."""
    tl = np.asarray(tl)
    wl = np.asarray(wl)
    gw = flinterp_np(wl, np.asarray(gwl), np.asarray(gam))
    nw, nc = gw.shape[0], gw.shape[-1]
    gflat = gw.reshape(nw, nc * nc)
    if eta_ad == 0.0:
        cosm = np.cos(wl[None, :] * tl[:, None])
        kt = 2.0 * (cosm @ gflat) / nw * wl[-1] / np.pi
        return np.real(kt).reshape(tl.shape[0], nc, nc)
    wc = wl.astype(np.result_type(wl.dtype, np.complex64))
    phase_m = (wc / (wc - 1j * eta_ad))[None, :] * \
        np.exp(-1j * wc[None, :] * tl[:, None] - eta_ad * tl[:, None])
    phase_p = (wc / (wc + 1j * eta_ad))[None, :] * \
        np.exp(+1j * wc[None, :] * tl[:, None] - eta_ad * tl[:, None])
    kt = ((phase_m + phase_p) @ gflat.astype(phase_m.dtype)) / nw \
        * wl[-1] / np.pi
    return np.real(kt).reshape(tl.shape[0], nc, nc)


def ggamma(sig, gwl) -> np.ndarray:
    """Friction table Gamma(w) = -Im Sigma(w)/w; the w=0 row is taken
    from the next grid point."""
    sig = np.asarray(sig)
    gwl = np.asarray(gwl, np.float64)
    wsafe = np.where(gwl == 0.0, 1.0, gwl)
    g = -np.imag(sig) / wsafe[:, None, None]
    g_next = np.roll(-np.imag(sig), -1, axis=0) / \
        np.roll(wsafe, -1)[:, None, None]
    return np.where((gwl == 0.0)[:, None, None], g_next, g)


def _kernel_im(kernel: torch.Tensor) -> torch.Tensor:
    """(ml, nc, nc) -> (nc, ml*nc): row a holds K[0][a,:], K[1][a,:], ..."""
    ml, nc = kernel.shape[0], kernel.shape[-1]
    return kernel.permute(1, 0, 2).reshape(nc, ml * nc)


@dataclass
class PhBath:
    """Phonon bath: Debye (local) or memory-kernel (non-Markovian)."""

    cids: np.ndarray                  # (nc,) int64 DOF indices
    T: float
    gamma: np.ndarray                 # (ngw, nc, nc) host float64
    gwl: np.ndarray                   # (ngw,)
    kernel: torch.Tensor              # (ml, nc, nc) K(t) time kernel
    noise: Optional[torch.Tensor]     # (traj, nmd, nc) once attached
    dt: float
    nmd: int
    ml: int
    nw: int
    wmax: float
    local: bool
    eta_ad: float = 0.0
    classical: bool = False
    zpmotion: bool = True
    nevecs: Optional[np.ndarray] = None
    nstd: Optional[np.ndarray] = None
    mode: str = "G"
    # start offset when cids is the contiguous range [cs, cs+nc): the
    # plain path then slices instead of gathering
    cs: Optional[int] = None

    @property
    def nc(self) -> int:
        return int(self.cids.shape[0])

    @property
    def cols(self):
        """Column indexer on the full-DOF axis: a slice when the bath's
        DOFs are contiguous, else an index tensor on the kernel's device."""
        if self.cs is not None:
            return slice(self.cs, self.cs + self.nc)
        return torch.as_tensor(self.cids, dtype=torch.long,
                               device=self.kernel.device)

    @property
    def wl(self):
        return np.array([self.wmax * i / self.nw for i in range(self.nw)])

    def replace(self, **changes) -> "PhBath":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "PhBath":
        return self.replace(
            kernel=self.kernel.to(device),
            noise=None if self.noise is None else self.noise.to(device))

    @property
    def kernel_im(self) -> torch.Tensor:
        return _kernel_im(self.kernel)

    # --- blocked-convolution fast path (md.run_segment_blocked) -----------
    # Per B-step block the convolution splits into (a) a pre-block part
    # over taps j > s, one FFT cross-correlation of the kernel with the
    # history (kernel K2), and (b) an in-block part over taps j <= s
    # against the (B, nc) ring of recent velocities (inside kernel K1).
    def block_tap_kernel(self, block: int) -> torch.Tensor:
        """(nc, (block+1)*nc) kernel slice covering in-block taps
        1..block+1, zero-padded past ml."""
        nc = self.nc
        want = (block + 1) * nc
        avail = self.kernel_im[:, nc:]
        if avail.shape[1] >= want:
            return avail[:, :want].contiguous()
        return torch.nn.functional.pad(avail, (0, want - avail.shape[1]))

    def block_corr(self, hist: torch.Tensor, block: int,
                   khat: torch.Tensor, nfft: int) -> torch.Tensor:
        """Pre-block convolution tails O[s] = sum_{j>=s+1} K[j] v(t0+s-j),
        s = 0..block, from ``hist`` (traj, ml-1, nc) newest-first;
        returns (traj, block+1, nc). See kernels.block_corr."""
        from sclmd_tpu_torch.kernels.block_corr import block_corr
        return block_corr(hist, block, khat, nfft)


def phbath(T, cats, debye, nw, dt, nmd, ml=None, mcof=2.0,
           sig=None, gamma=None, gwl=None,
           K00=None, K01=None, V01=None, eta_ad=0.0,
           classical: bool = False, zpmotion: bool = True,
           dtype=torch.float32, device=None,
           factorize: bool = True) -> PhBath:
    """Build a phonon bath, as ``sclmd_tpu.baths.phbath``.

    Modes: sig + gwl (Gamma = -Im Sigma / w), gamma + gwl (used
    directly), else the local Debye model Gamma = (w_D pi / 6) I. The
    returned bath carries its time-domain kernel on ``device``.
    """
    if K00 is not None and K01 is not None and V01 is not None:
        raise NotImplementedError(
            "phbath: the K00/K01/V01 lead-block mode needs the decimation "
            "self-energy, not ported yet (ROADMAP queue 1 item 9)")
    cats_np = np.asarray(cats, dtype=np.int64)
    nc = int(cats_np.shape[0])
    wmax = float(mcof * debye)
    local = False

    if sig is not None and gwl is not None:
        sig = np.asarray(sig)
        if sig.shape[-1] != nc:
            raise ValueError("phbath: inconsistent cids and sig")
        gwl_np = np.asarray(gwl, np.float64)
        gamma_np = ggamma(sig, gwl_np)
        mode = "Pi"
    elif gamma is not None and gwl is not None:
        gamma_np = np.asarray(gamma, np.float64)
        if gamma_np.shape[-1] != nc:
            raise ValueError("phbath: inconsistent cids and gamma")
        gwl_np = np.asarray(gwl, np.float64)
        mode = "G"
    else:
        phfric = debye * np.pi / 6.0
        gamma_np = (phfric * np.eye(nc))[None]
        gwl_np = np.zeros((1,))
        local = True
        ml = 1
        mode = "debye"

    if ml is None:
        raise ValueError("phbath: memory length ml must be set for "
                         "non-local baths")

    if local:
        kern_np = gamma_np[:1]
    else:
        tl = float(dt) * np.arange(int(ml))
        wl_bath = np.array([wmax * i / int(nw) for i in range(int(nw))])
        kern_np = gamt(tl, wl_bath, gwl_np, gamma_np, float(eta_ad))
        if eta_ad != 0.0:
            # refresh Gamma(w) from the damped kernel
            cosm = np.cos(gwl_np[:, None] * tl[None, :])
            gamma_np = (float(dt) * cosm @
                        kern_np.reshape(int(ml), nc * nc)
                        ).reshape(len(gwl_np), nc, nc)

    nevecs = nstd = None
    if factorize:
        hlen = int(nmd) // 2
        dw = 2.0 * np.pi / dt / nmd
        wlh = dw * np.arange(hlen + 1)
        psd = NZ.phonon_psd(wlh, gamma_np, gwl_np, float(T), wmax,
                            classical, zpmotion,
                            delta=float(dt) * int(nmd))
        nevecs, nstd = NZ.noise_factors(psd, dtype=dtype)

    return PhBath(
        cids=cats_np, cs=_contig_start(cats_np), T=float(T),
        gamma=gamma_np, gwl=gwl_np,
        kernel=torch.as_tensor(np.ascontiguousarray(kern_np), dtype=dtype,
                               device=device),
        noise=None,
        dt=float(dt), nmd=int(nmd), ml=int(ml), nw=int(nw),
        wmax=wmax, local=bool(local), eta_ad=float(eta_ad),
        classical=bool(classical), zpmotion=bool(zpmotion),
        nevecs=nevecs, nstd=nstd, mode=mode,
    )
