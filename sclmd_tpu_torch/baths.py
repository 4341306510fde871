"""Electron and phonon baths (counterpart of ``sclmd_tpu.baths``).

A bath is a small dataclass: host numpy float64 setup data (Gamma
table, PSD noise factors) plus torch tensors for what the hot loop
reads (the memory kernel or the friction matrices, and a (traj, nmd,
nc) noise batch once attached). The factories ``ebath`` and ``phbath``
run entirely on the host in numpy, as in the JAX package.

The per-step force rules of the plain integrator (``step_plan``,
``force_pred``, ``force_corr``) take (traj, nc) rows and are the plain
torch forms of kernels K6 (``kernels.conv_tails``) and K7
(``kernels.bath_force``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch.ops import noise as NZ
from sclmd_tpu_torch.ops.functions import (antisymmetrize, chkShape,
                                           equ_spectrum, flinterp_np,
                                           matvec, symmetrize)
from sclmd_tpu_torch.utils import profiling


def _contig_start(cats_np: np.ndarray):
    """Start offset if cats is the ascending contiguous range
    [c0, c0+nc), else None."""
    if len(cats_np) == 0:
        return None
    c0 = int(cats_np[0])
    if np.array_equal(cats_np, np.arange(c0, c0 + len(cats_np))):
        return c0
    return None


def _cols(cs, cids, device):
    """Column indexer on the full-DOF axis: a slice when the bath's DOFs
    are the contiguous range [cs, cs+nc), else an index tensor."""
    if cs is not None:
        return slice(cs, cs + len(cids))
    return torch.as_tensor(cids, dtype=torch.long, device=device)


@dataclass
class EBath:
    """Markovian electron bath with the current-induced forces: friction
    ``-efric v`` plus, when ``bias_terms``, the wind/renormalisation
    ``bias (exim - zeta1) q`` and Berry ``-bias zeta2 v`` forces."""

    cids: np.ndarray                  # (nc,) int64 DOF indices
    efric: torch.Tensor               # (nc, nc) symmetric friction
    exim: torch.Tensor                # (nc, nc) antisymmetric
    exip: torch.Tensor                # (nc, nc) symmetric
    zeta1: torch.Tensor               # (nc, nc) symmetric renormalisation
    zeta2: torch.Tensor               # (nc, nc) antisymmetric Berry
    T: float
    bias: float                       # mu_L - mu_R
    noise: Optional[torch.Tensor]     # (traj, nmd, nc) once attached
    dt: float
    nmd: int
    wmax: Optional[float] = None
    nw: Optional[int] = None
    classical: bool = False
    zpmotion: bool = True
    # the wind/Berry/renormalisation matrices were supplied: the force
    # rule applies them (else it is the friction alone)
    bias_terms: bool = False
    nevecs: Optional[np.ndarray] = None
    nstd: Optional[np.ndarray] = None
    cs: Optional[int] = None

    @property
    def nc(self) -> int:
        return int(self.cids.shape[0])

    @property
    def ml(self) -> int:
        return 1

    @property
    def kernel(self) -> torch.Tensor:
        return self.efric[None]

    @property
    def cols(self):
        return _cols(self.cs, self.cids, self.efric.device)

    @property
    def wl(self):
        if self.wmax is None or self.nw is None:
            return None
        return np.array([self.wmax * i / self.nw for i in range(self.nw)])

    def replace(self, **changes) -> "EBath":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "EBath":
        mats = {k: getattr(self, k).to(device)
                for k in ("efric", "exim", "exip", "zeta1", "zeta2")}
        return self.replace(
            noise=None if self.noise is None else self.noise.to(device),
            **mats)

    def prepare_noise(self) -> "EBath":
        """Factorise the noise PSD on the host in float64."""
        wl = 2.0 * np.pi / self.dt / self.nmd * np.arange(self.nmd // 2 + 1)
        with profiling.span("setup/bath"):
            f64 = {k: getattr(self, k).double().cpu().numpy()
                   for k in ("efric", "exim", "exip")}
            psd = NZ.electron_psd(wl, f64["efric"], f64["exim"],
                                  f64["exip"], float(self.bias),
                                  float(self.T), self.wmax, self.classical,
                                  self.zpmotion, delta=self.dt * self.nmd)
            evec, std = NZ.noise_factors(psd, dtype=self.efric.dtype)
        return self.replace(nevecs=evec, nstd=std)

    def SetT(self, T) -> "EBath":
        """The bath at temperature ``T``, noise factors refreshed."""
        return self.replace(T=float(T)).prepare_noise()

    def setbias(self, bias) -> "EBath":
        """The bath at ``bias``, noise factors refreshed."""
        return self.replace(bias=float(bias)).prepare_noise()

    def SetMDsteps(self, dt, nmd) -> "EBath":
        """The bath on another MD grid, noise factors refreshed."""
        return self.replace(dt=float(dt), nmd=int(nmd)).prepare_noise()

    # --- per-step interface shared with PhBath (the plain step) ---------
    def step_plan(self, old_c):
        return None

    def _markov_force(self, noise_row, v_c, q_c):
        f = noise_row - matvec(self.efric, v_c)
        if self.bias_terms:
            f = f + self.bias * matvec(self.exim - self.zeta1, q_c) \
                - self.bias * matvec(self.zeta2, v_c)
        return f

    def force_pred(self, noise_row, v_c, q_c, old_c, plan):
        return self._markov_force(noise_row, v_c, q_c)

    def force_corr(self, noise_row, v_c, q_c, p_c, plan):
        return self._markov_force(noise_row, v_c, q_c)


def ebath(cats, T, dt, nmd, wmax=None, nw=None, bias=0.0,
          efric=None, exim=None, exip=None, zeta1=None, zeta2=None,
          classical: bool = False, zpmotion: bool = True,
          dtype=torch.float32, device=None,
          factorize: bool = True) -> EBath:
    """Build an electron bath, as ``sclmd_tpu.baths.ebath``: efric, exip
    and zeta1 are symmetrised, exim and zeta2 antisymmetrised, shapes
    checked against ``cats``. The matrices go to ``device`` (default:
    the CUDA card).

    Noise factors: an unbiased bath with nc >= 8 has S(w) = a(w) efric,
    so ONE eigh of efric gives them (eigenvectors kept as a zero-stride
    broadcast view, one matrix in memory); otherwise the full
    ``electron_psd`` batch is factorised per frequency."""
    device = resolve_device(device)
    cats_np = np.asarray(cats, dtype=np.int64)
    nc = int(cats_np.shape[0])
    if efric is None:
        raise ValueError("ebath: efric is required")
    if chkShape(efric) != nc:
        raise ValueError(f"ebath: efric shape {chkShape(efric)} != "
                         f"len(cats) {nc}")
    for name, m in (("exim", exim), ("exip", exip),
                    ("zeta1", zeta1), ("zeta2", zeta2)):
        if m is not None and chkShape(m) != nc:
            raise ValueError(f"ebath: {name} has wrong dimension")

    def f64(m):
        return np.asarray(m, np.float64)

    z = np.zeros((nc, nc))
    efric_np = symmetrize(f64(efric))
    exim_np = antisymmetrize(f64(exim)) if exim is not None else z
    exip_np = symmetrize(f64(exip)) if exip is not None else z
    zeta1_np = symmetrize(f64(zeta1)) if zeta1 is not None else z
    zeta2_np = antisymmetrize(f64(zeta2)) if zeta2 is not None else z

    bias_active = (exim is not None or zeta1 is not None
                   or zeta2 is not None or exip is not None) \
        and float(bias) != 0.0
    nevecs = nstd = None
    if factorize:
        wlh = 2.0 * np.pi / dt / nmd * np.arange(int(nmd) // 2 + 1)
        with profiling.span("setup/bath"):
            if not bias_active and nc >= 8:
                aw = float(dt) * int(nmd) * equ_spectrum(
                    wlh, wmax, float(T), classical, zpmotion)
                lam0, evec0 = np.linalg.eigh(efric_np)
                std = np.sqrt(np.clip(aw, 0.0, None)[:, None]
                              * np.clip(lam0, 0.0, None)[None, :])
                f64_out = NZ._is_f64(dtype)
                nevecs = np.broadcast_to(
                    evec0.astype(np.complex128 if f64_out else np.complex64),
                    (len(wlh), nc, nc))
                nstd = std.astype(np.float64 if f64_out else np.float32)
            else:
                psd = NZ.electron_psd(wlh, efric_np, exim_np, exip_np,
                                      float(bias), float(T), wmax,
                                      classical, zpmotion,
                                      delta=float(dt) * int(nmd))
                nevecs, nstd = NZ.noise_factors(psd, dtype=dtype)

    def dev(m):
        return torch.as_tensor(m, dtype=dtype, device=device)

    return EBath(
        cids=cats_np, cs=_contig_start(cats_np),
        efric=dev(efric_np), exim=dev(exim_np), exip=dev(exip_np),
        zeta1=dev(zeta1_np), zeta2=dev(zeta2_np),
        T=float(T), bias=float(bias), noise=None,
        dt=float(dt), nmd=int(nmd),
        wmax=None if wmax is None else float(wmax),
        nw=None if nw is None else int(nw),
        classical=bool(classical), zpmotion=bool(zpmotion),
        bias_terms=(exim is not None or zeta1 is not None
                    or zeta2 is not None),
        nevecs=nevecs, nstd=nstd)


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
        return _cols(self.cs, self.cids, self.kernel.device)

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

    # --- the reference's mode predicates: the builder consumes sig/K00
    # (deriving gamma), so they report the recorded build mode; a "K"
    # bath also went through the Sigma -> Gamma derivation, and every
    # built bath carries a Gamma table
    def UseG(self) -> bool:
        return self.gamma is not None and self.gwl is not None

    def UsePi(self) -> bool:
        return self.mode in ("Pi", "K")

    def UseK(self) -> bool:
        return self.mode == "K"

    # --- the plain step (md.run_segment) --------------------------------
    # The step evaluates the bath force three times with histories that
    # share all but the newest one or two taps, so both shared tails
    #   tail_pred = sum_{r=2}^{ml-1} K[r] old[r-1]
    #   tail_corr = sum_{r=2}^{ml-1} K[r] old[r-2]
    # come out of one read of the kernel per step (kernel K6 on the card).
    def step_plan(self, old_c):
        """Shared tails (traj, nc, 2) from the pre-push history ``old_c``
        (traj, ml, nc), newest first; None when ml <= 2."""
        if self.ml <= 2:
            return None
        nc, ml = self.nc, self.ml
        B = torch.stack([old_c[:, 1:ml - 1], old_c[:, 0:ml - 2]], dim=3)
        return self.kernel_im[:, 2 * nc:] @ B.reshape(-1, (ml - 2) * nc, 2)

    def force_pred(self, noise_row, v_c, q_c, old_c, plan):
        """Predictor bath force: history [v, old[0], old[1], ...]."""
        if self.ml == 1:
            return noise_row - matvec(self.kernel[0], v_c)
        conv = matvec(self.kernel[0], v_c) + matvec(self.kernel[1],
                                                    old_c[:, 0])
        if plan is not None:
            conv = conv + plan[..., 0]
        return noise_row - conv * self.dt

    def force_corr(self, noise_row, v_c, q_c, p_c, plan):
        """Corrector bath force: history [v, p, old[0], ...]."""
        if self.ml == 1:
            return noise_row - matvec(self.kernel[0], v_c)
        conv = matvec(self.kernel[0], v_c) + matvec(self.kernel[1], p_c)
        if plan is not None:
            conv = conv + plan[..., 1]
        return noise_row - conv * self.dt

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
           dtype=torch.float32, nwse: int = 400, device=None,
           factorize: bool = True) -> PhBath:
    """Build a phonon bath, as ``sclmd_tpu.baths.phbath``.

    Modes, in the reference's order: K00/K01/V01 lead blocks (Sigma(w)
    on an ``nwse``-point grid up to wmax by the decimation surface
    Green's function on the host,
    ``selfenergy.lead_selfenergy_from_blocks_np``, then as sig; mode
    "K"); sig + gwl (Gamma = -Im Sigma / w); gamma + gwl (used
    directly); else the local Debye model Gamma = (w_D pi / 6) I. The
    returned bath carries its time-domain kernel on ``device`` (default:
    the CUDA card).
    """
    device = resolve_device(device)
    cats_np = np.asarray(cats, dtype=np.int64)
    nc = int(cats_np.shape[0])
    wmax = float(mcof * debye)
    local = False

    lead_blocks = K00 is not None and K01 is not None and V01 is not None
    if lead_blocks:
        from sclmd_tpu_torch.selfenergy import lead_selfenergy_from_blocks_np
        gwl = np.linspace(0.0, wmax, nwse)
        sig = lead_selfenergy_from_blocks_np(
            np.asarray(K00, np.float64), np.asarray(K01, np.float64),
            np.asarray(V01, np.float64), gwl)

    if sig is not None and gwl is not None:
        sig = np.asarray(sig)
        if sig.shape[-1] != nc:
            raise ValueError("phbath: inconsistent cids and sig")
        gwl_np = np.asarray(gwl, np.float64)
        gamma_np = ggamma(sig, gwl_np)
        mode = "K" if lead_blocks else "Pi"
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
        with profiling.span("setup/bath"):
            nevecs, nstd = NZ.phonon_factors(
                wlh, gamma_np, gwl_np, float(T), wmax, classical, zpmotion,
                delta=float(dt) * int(nmd), dtype=dtype)

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
