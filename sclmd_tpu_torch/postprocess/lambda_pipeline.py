"""Current-induced-force (Lambda) pipeline on the card (counterpart of
``sclmd_tpu.postprocess.lambda_pipeline``).

From the electronic structure (H, S, lead self-energies Sigma_L/R(E))
and the e-ph coupling matrices M_k it computes the Lambda correlation
functions

    Lam^{ab}_{kl}(w) = 2 int dE/(4 pi^2)
        Tr[M_k A_a(E + w) M_l A_b(E)] (1 - n_F^a(E + w)) n_F^b(E)
        / n_B(mu_a - mu_b - w)

with their equilibrium/nonequilibrium split, Hilbert partners, the
phonon retarded self-energy Pi^r(w), and the wideband current-induced-
force matrices eta (friction), xim (wind), xip, zeta1 (renormalisation)
and zeta2 (Berry) that ``baths.ebath`` takes.

The heavy linear algebra runs in complex128 on ``device`` (default: the
CUDA card): the batched inverses of ``spectral_functions`` (in fixed
groups of ``negf.SOLVE_GROUP``, the last padded, since the card's
batched LU picks its algorithm by the batch count), the mode fields and
their FFT cross-correlation over the energy axis, block by block of
``mode_chunk``-sized chunks of the time axis, kept on the device with one
read-back per correlation. Occupations (``bose``/``fermi``), the hwcut mask, the
negative-frequency completion (``domapping``), ``pir_from_pira`` and the
bias analysis stay host numpy float64, as in the JAX package. Results do
not depend on ``batch_size`` or ``mode_chunk`` beyond rounding.

Energy grids are "FFT-ordered": [0, dE, ..., Emax-dE, -Emax, ..., -dE]
(``fft_order_grid``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch.ops.functions import bose, fermi, nearest
from sclmd_tpu_torch.utils.profiling import device_sync

SPIN = 2.0   # electron spin degeneracy
C128 = torch.complex128


def _c128(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(C128)


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def batched_inv(a: torch.Tensor) -> torch.Tensor:
    """Inverses of the (b, n, n) batch ``a``, taken in groups of
    ``negf.SOLVE_GROUP`` matrices (the last group padded with copies of
    the last matrix) by ``torch.linalg.inv_ex`` (no error check, no
    read-back). A caller that cuts a longer batch into pieces starting
    at multiples of SOLVE_GROUP gets every matrix's bits whatever the
    pieces."""
    from sclmd_tpu_torch.negf import SOLVE_GROUP

    b = a.shape[0]
    pad = (-b) % SOLVE_GROUP
    if pad:
        a = torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])
    return torch.cat([torch.linalg.inv_ex(a[i:i + SOLVE_GROUP])[0]
                      for i in range(0, a.shape[0], SOLVE_GROUP)])[:b]


def _chunk_of(batch_size: int) -> int:
    """``batch_size`` rounded up to a whole number of solve groups."""
    from sclmd_tpu_torch.negf import SOLVE_GROUP

    return -(-max(int(batch_size), 1) // SOLVE_GROUP) * SOLVE_GROUP


def _dag(x: torch.Tensor) -> torch.Tensor:
    return x.conj().transpose(-1, -2)


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------
def fft_order_grid(emax: float, ne: int) -> np.ndarray:
    """FFT-ordered energy grid with ne (even) points, spacing
    2*emax/ne: [0 .. emax-dE, -emax .. -dE]."""
    ne = int(ne // 2) * 2
    de = 2.0 * emax / ne
    w = de * np.arange(ne)
    return np.where(w >= emax, w - ne * de, w)


def reord(a):
    """FFT order -> monotonic order (numpy)."""
    a = np.asarray(a)
    h = len(a) // 2
    return np.concatenate([a[h:], a[:h]], axis=0)


def trev(a, axis=0):
    """a(t) -> a(-t) on a periodic grid: index 0 fixed, rest reversed
    (a torch tensor, or a numpy array)."""
    if torch.is_tensor(a):
        return torch.roll(torch.flip(a, dims=(axis,)), 1, dims=axis)
    return np.roll(np.flip(a, axis=axis), 1, axis=axis)


# ---------------------------------------------------------------------------
# eigen truncation utilities (host)
# ---------------------------------------------------------------------------
def cutA(A, doscut: float):
    """Low-rank factor W of a PSD spectral matrix: A ~= W^T W^*,
    keeping eigenvalues > doscut * max."""
    A = np.asarray(A)
    ev, Uv = np.linalg.eigh(A)
    order = np.argsort(-ev)
    ev, Uv = ev[order], Uv[:, order].T
    keep = max(int(np.sum(ev > ev.max() * doscut)), 1)
    return np.sqrt(np.clip(ev[:keep, None], 0, None)) * Uv[:keep]


def cutM(A, cut: float):
    """Signed eigen decomposition A ~= W^T diag(e) W^* keeping
    |e| >= cut * max|e|. Returns (e, W)."""
    A = np.asarray(A)
    ev, Uv = np.linalg.eigh(A)
    order = np.argsort(-ev)
    ev, Uv = ev[order], Uv[:, order].T
    keep = np.abs(ev) >= np.abs(ev).max() * cut
    if keep.sum() == 0:
        keep[:2] = True
    return ev[keep], Uv[keep]


# ---------------------------------------------------------------------------
# spectral functions
# ---------------------------------------------------------------------------
def spectral_flops(ne: int, n: int) -> float:
    """Real operations of ``spectral_functions``: per energy one complex
    inverse (8 n^3) and four complex products (8 n^3 each)."""
    return float(ne) * 40.0 * n ** 3


def spectral_functions(H, S, E, SigL, SigR, batch_size: int = 16,
                       device=None, keep_G: bool = True) -> dict:
    """G(E), A_L, A_R, A, sym Re G and the transmission over the grid,
    complex128 tensors on ``device`` (default: the CUDA card).

    G = (E S - H - SigL - SigR)^-1; A_a = G Gamma_a G^dag;
    TR = Tr[A_L Gamma_R]. The matrices of ``batch_size`` energies (rounded
    up to whole solve groups) are built at once and inverted by
    ``batched_inv``. ``keep_G=False`` drops G from the result (the
    pipeline never reads it)."""
    dev = resolve_device(device)
    H, S = _c128(H, dev), _c128(S, dev)
    SigL, SigR = _c128(SigL, dev), _c128(SigR, dev)
    E = _f64(E, dev)
    chunk = _chunk_of(batch_size)
    parts = {k: [] for k in ("G", "AL", "AR", "ReG", "TR")}
    for i0 in range(0, E.shape[0], chunk):
        sl, sr = SigL[i0:i0 + chunk], SigR[i0:i0 + chunk]
        e = E[i0:i0 + chunk].to(C128)[:, None, None]
        g = batched_inv(e * S - H - sl - sr)
        gd = _dag(g)
        gl = 1j * (sl - _dag(sl))
        gr = 1j * (sr - _dag(sr))
        al = g @ gl @ gd
        parts["AL"].append(al)
        parts["AR"].append(g @ gr @ gd)
        parts["ReG"].append((0.5 * (g.real + g.real.transpose(-1, -2)))
                            .to(C128))
        parts["TR"].append((al @ gr).diagonal(dim1=-2, dim2=-1)
                           .sum(-1).real)
        if keep_G:
            parts["G"].append(g)
    out = {k: torch.cat(v) for k, v in parts.items() if v}
    out["A"] = out["AL"] + out["AR"]
    out["ALtr"] = out["AL"].diagonal(dim1=-2, dim2=-1).sum(-1).real
    out["ARtr"] = out["AR"].diagonal(dim1=-2, dim2=-1).sum(-1).real
    return out


# ---------------------------------------------------------------------------
# MAMA products
# ---------------------------------------------------------------------------
def _pair_mask(hw, hwcut: float):
    """(nm, nm) mask: |hw_k - hw_l| <= hwcut and both modes positive
    (host numpy)."""
    hw = np.asarray(hw)
    m = (np.abs(hw[:, None] - hw[None, :]) <= hwcut) \
        & (hw[:, None] >= 0) & (hw[None, :] >= 0)
    return m


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def mama_single(M, Aa, Ab, mask, spin: float = SPIN,
                herm_mode: str = "tril"):
    """(MAaMAb)_{kl} = spin Tr[M_k Aa M_l Ab] with mask + Hermitian fill,
    on the device of ``M`` (a tensor; numpy inputs go to the CPU).

    herm_mode: "tril" fills the upper triangle from the conjugated lower
    one; "sym" uses the linear 0.5 (X + X^dag) (commutes with energy
    integration); None returns the raw trace matrix.
    """
    M = torch.as_tensor(M)
    dev = M.device
    X = torch.einsum("kpq,qr->kpr", M, _c128(Aa, dev))
    Y = torch.einsum("lrs,sp->lrp", M, _c128(Ab, dev))
    out = torch.einsum("kpr,lrp->kl", X, Y)
    out = torch.where(torch.as_tensor(mask, device=dev), out, _zero(out))
    if herm_mode == "tril":
        low = torch.tril(out, -1)
        out = low + low.conj().T + torch.diag(out.diagonal().real
                                              .to(out.dtype))
    elif herm_mode == "sym":
        out = 0.5 * (out + out.conj().T)
    return spin * out


# ---------------------------------------------------------------------------
# FFT cross-correlation over the energy axis
# ---------------------------------------------------------------------------
def _pad_middle(a: torch.Tensor, npad: int, dim: int) -> torch.Tensor:
    """Insert npad zeros at the high-|E| midpoint of an FFT-ordered axis."""
    h = a.shape[dim] // 2
    shape = list(a.shape)
    shape[dim] = npad
    z = torch.zeros(shape, dtype=a.dtype, device=a.device)
    return torch.cat([a.narrow(dim, 0, h), z,
                      a.narrow(dim, h, a.shape[dim] - h)], dim=dim)


def _unpad_middle(a: torch.Tensor, npad: int, dim: int) -> torch.Tensor:
    n = a.shape[dim]
    h = (n - npad) // 2
    return torch.cat([a.narrow(dim, 0, h),
                      a.narrow(dim, h + npad, n - h - npad)], dim=dim)


def _default_pad(ne: int, npad: Optional[int]) -> int:
    return (ne // 2) * 2 if npad is None else npad


def energy_correlation(u, v, npad: Optional[int] = None) -> torch.Tensor:
    """C_{kl}(w) = sum_{E} <u_k(E + w), v_l(E)> for FFT-ordered fields.

    u, v: (nmu, ne, d) / (nmv, ne, d) complex tensors. Computed as
    fft/product/ifft with middle zero-padding to suppress wrap-around;
    returns (nmu, nmv, ne) on their device.
    """
    u, v = torch.as_tensor(u), torch.as_tensor(v)
    npad = _default_pad(u.shape[1], npad)
    ut = torch.fft.fft(_pad_middle(u, npad, 1), dim=1)
    # v(-t): the fft at -t is the unnormalised inverse transform
    vtr = torch.fft.ifft(_pad_middle(v, npad, 1), dim=1, norm="forward")
    prod = torch.einsum("ktd,ltd->klt", ut, vtr)
    # t -> w with 1/N (ifft), giving exactly sum_E u(E + w) v(E)
    return _unpad_middle(torch.fft.ifft(prod, dim=2), npad, 2)


def _weighted(Aw: torch.Tensor, weight) -> torch.Tensor:
    if weight is None:
        return Aw
    return Aw * _f64(weight, Aw.device)[:, None, None]


def _mode_fields(M, Aw, weight=None) -> torch.Tensor:
    """u_k(E) = flatten(M_k @ A(E) * weight(E)): (nm, ne, n^2)."""
    Aw = _weighted(Aw, weight)
    X = torch.einsum("kpq,eqr->kepr", M, Aw)
    nm, ne, n, _ = X.shape
    return X.reshape(nm, ne, n * n)


def _mode_fields_T(M, Aw, weight=None) -> torch.Tensor:
    """v_l(E) = flatten((M_l @ A(E))^T) so <u_k, v_l> = Tr[...]."""
    Aw = _weighted(Aw, weight)
    X = torch.einsum("lrs,esp->lepr", M, Aw)
    nm, ne, n, _ = X.shape
    return X.reshape(nm, ne, n * n)


def _energy_transforms(Aw, weight, npad: int, forward: bool):
    """A(E) w(E) (ne, n, n), zero-padded in the middle of the energy axis
    and taken to time: the plain fft (``forward``), or the unnormalised
    inverse, which is the fft at -t."""
    Ap = _pad_middle(_weighted(Aw, weight), npad, 0)
    if forward:
        return torch.fft.fft(Ap, dim=0)
    return torch.fft.ifft(Ap, dim=0, norm="forward")


def _fields_at(M, At, transposed: bool):
    """The mode fields at the times of ``At`` (tc, n, n): (tc, nm, n^2) of
    flatten(M_k A(t)), or of flatten((M_k A(t))^T) when ``transposed``."""
    if transposed:
        X = torch.einsum("lrs,tsp->tlpr", M, At)
    else:
        X = torch.einsum("kpq,tqr->tkpr", M, At)
    tc, nm, n, _ = X.shape
    return X.reshape(tc, nm, n * n)


def chunked_correlation(M, Aw_u, Aw_v, wu, wv, mode_chunk: int,
                        swapped: bool = False) -> torch.Tensor:
    """C_{kl}(w) = sum_E <u_k(E + w), v_l(E)> of the mode fields u_k =
    M_k A_u w_u and v_l = (M_l A_v w_v)^T, (nm, nm, ne) on the device of
    ``M``: the same sums as ``energy_correlation`` of the fields (padded
    FFT, product, inverse FFT), taken in another order.

    The transform over energy commutes with M_k, so A_u w_u and A_v w_v
    go to time once each ((2 ne, n, n), a transform of n^2 columns, not
    of nm n^2), and each mode's field is built once, at each time, by a
    complex GEMM; the product over n^2 runs per time and the inverse
    transform once, on (2 ne, nm, nm). Times go in chunks of
    ``mode_chunk * 2 ne / nm``, so a chunk's two fields hold as many
    numbers as the JAX package's block of ``mode_chunk`` modes,
    2 * mode_chunk * 2 ne * n^2 complex; every chunk stays on the device.

    ``swapped``: the role-swapped correlation C_vu of the JAX package's
    ``_corr_swapped`` (u_k built as ``_mode_fields_T`` of Aw_v, v_l as
    ``_mode_fields`` of Aw_u).
    """
    M = torch.as_tensor(M)
    nm, ne = M.shape[0], Aw_u.shape[0]
    npad = _default_pad(ne, None)
    N = ne + npad
    if swapped:
        (A1, w1, t1), (A2, w2, t2) = (Aw_v, wv, True), (Aw_u, wu, False)
    else:
        (A1, w1, t1), (A2, w2, t2) = (Aw_u, wu, False), (Aw_v, wv, True)
    U = _energy_transforms(A1, w1, npad, forward=True)
    V = _energy_transforms(A2, w2, npad, forward=False)
    tc = max(1, int(mode_chunk) * N // nm)
    prod = torch.empty((N, nm, nm), dtype=C128, device=M.device)
    for t0 in range(0, N, tc):
        X = _fields_at(M, U[t0:t0 + tc], t1)
        Y = _fields_at(M, V[t0:t0 + tc], t2)
        prod[t0:t0 + tc] = X @ Y.transpose(1, 2)
        del X, Y
    corr = _unpad_middle(torch.fft.ifft(prod, dim=0), npad, 0)
    return corr.permute(1, 2, 0)


def correlation_flops(nm: int, ne: int, n: int) -> float:
    """Real operations of one ``chunked_correlation``: the two fields of
    every mode at every time of the padded axis (N = 2 ne; a complex GEMM,
    8 n^3 per mode and time), the products (8 n^2 per mode pair and
    time), and the transforms (5 N log2 N per length-N transform: n^2
    columns each way, nm^2 back)."""
    N = ne + _default_pad(ne, None)
    fft = 5.0 * N * np.log2(N)
    fields = 2.0 * nm * N * 8.0 * n ** 3
    products = nm * nm * 8.0 * N * n * n
    transforms = (2 * n * n + nm * nm) * fft
    return float(fields + products + transforms)


# ---------------------------------------------------------------------------
# Lambda functions
# ---------------------------------------------------------------------------
CORRELATIONS = ("LL", "RR", "LR", "RL", "equ", "equ_swapped", "nonequ",
                "nonequ_swapped", "hilbert", "hilbert_swapped")


class LambdaPipeline:
    """Orchestrates the Lambda computation for one junction.

    Parameters
    ----------
    H, S : (n, n) device Hamiltonian / overlap (eV).
    E : (ne,) FFT-ordered energy grid (use fft_order_grid).
    SigL, SigR : (ne, n, n) retarded lead self-energies on the grid.
    M : (nm, n, n) e-ph coupling dH/dQ in mass-normalised coordinates
        (Hermitised, * sqrt(2 hw); ``prepare_eph_matrices``).
    hw : (nm,) phonon mode energies (eV).
    Umodes : optional (nm, nph) mode->real-space transform (ReadDynmat).
    device : where the linear algebra runs (default: the CUDA card);
        ``device="cpu"`` for a CPU run.
    mode_chunk : the correlations' memory bound: their time chunks hold
        as many numbers as ``mode_chunk`` modes' fields over the padded
        energy axis (see ``chunked_correlation``); results do not depend
        on it.
    tracer : an optional ``utils.profiling.Tracer``; the spectral
        functions, ``wideband`` and each correlation (``CORRELATIONS``)
        are timed in its sections, with the card synchronised.
    """

    def __init__(self, H, S, E, SigL, SigR, M, hw, Umodes=None,
                 T: float = 0.0, spin: float = SPIN, batch_size: int = 16,
                 device=None, mode_chunk: int = 8, tracer=None):
        self.device = resolve_device(device)
        self.mode_chunk = int(mode_chunk)
        self.tracer = tracer
        self.E = np.asarray(E, dtype=float)
        self.de = float(np.abs(self.E[1] - self.E[0]))
        self.M = _c128(M, self.device)
        self.hw = np.asarray(hw)
        self.Umodes = None if Umodes is None else np.asarray(Umodes)
        self.T = float(T)
        self.spin = spin
        self.n = int(np.shape(H)[0])
        with self._section("spectral_functions"):
            self.sp = spectral_functions(H, S, self.E, SigL, SigR,
                                         batch_size, device=self.device,
                                         keep_G=False)

    def _section(self, name):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.section(name, sync=device_sync)

    def _corr(self, name, Aw_u, Aw_v, wu, wv, swapped=False):
        with self._section(name):
            return chunked_correlation(self.M, Aw_u, Aw_v, wu, wv,
                                       self.mode_chunk, swapped=swapped)

    def _mask(self, hwcut) -> torch.Tensor:
        return torch.as_tensor(_pair_mask(self.hw, hwcut),
                               device=self.device)

    def _A(self, which):
        return {"L": self.sp["AL"], "R": self.sp["AR"],
                "A": self.sp["A"]}[which]

    # -- raw MAMA at chosen energies ---------------------------------------
    def mama(self, w1, w2, a, b, hwcut, herm_mode: str = "tril"):
        """spin Tr[M_k A_a(w1) M_l A_b(w2)] (host numpy)."""
        i1, i2 = nearest(w1, self.E), nearest(w2, self.E)
        return _host(mama_single(self.M, self._A(a)[i1], self._A(b)[i2],
                                 _pair_mask(self.hw, hwcut), self.spin,
                                 herm_mode=herm_mode))

    # -- direct integration (the oracle of lambda_fft) ---------------------
    def lambda_direct(self, w, a, b, mua, mub, dw, maxw, hwcut,
                      herm_mode: str = "tril"):
        nm = len(self.hw)
        if w < 0 or w > maxw:
            return np.zeros((nm, nm), complex)
        lo, hi = min(mua - w, mub), max(mua - w, mub)
        if lo == hi:
            return np.zeros((nm, nm), complex)
        nw = int(np.floor((hi - lo) / dw) + 1)
        wl = [(hi + lo) / 2] if nw == 1 else \
            [lo + (hi - lo) * i / (nw - 1) for i in range(nw)]
        acc = np.mean([self.mama(x + w, x, a, b, hwcut,
                                 herm_mode=herm_mode) for x in wl],
                      axis=0)
        return (mua - mub - w) / 4 / np.pi ** 2 * acc

    # -- FFT Lambda --------------------------------------------------------
    def lambda_fft(self, a, b, mua, mub, hwcut):
        E = self.E
        fa = 1.0 - fermi(E, mua, self.T)
        fb = fermi(E, mub, self.T)
        corr = self._corr(a + b, self._A(a), self._A(b), fa, fb)
        lam = corr.permute(2, 0, 1) * (self.de / (2 * np.pi) ** 2) \
            * self.spin
        # Hermitian structure in mode space + hwcut mask
        lam = torch.where(self._mask(hwcut)[None], lam, _zero(lam))
        lam = 0.5 * (lam + lam.conj().transpose(1, 2))
        # detailed-balance division; the Bose factor is 0/0 where the
        # window is closed, so the denominator is guarded before dividing
        x = mua - mub - E
        keep = torch.as_tensor(x < 0.0, device=self.device)[:, None, None]
        denom = torch.where(keep, _f64(bose(x, self.T),
                                       self.device)[:, None, None], 1.0)
        return _host(torch.where(keep, lam / denom, _zero(lam)))

    # -- equilibrium part --------------------------------------------------
    def equ_lambda_fft(self, hwcut, mu0: float = 0.0):
        f0 = fermi(self.E, mu0, self.T)
        A = self.sp["A"]
        c1 = self._corr("equ", A, A, f0, None)
        # second term u(-t)v(t): sum_E u(E) v(E+w) = C_vu[l,k](w), built
        # from the role-swapped correlation (the f0 weight stays on the
        # u-field, which now sits in the static slot)
        c2 = self._corr("equ_swapped", A, A, f0, None,
                        swapped=True).transpose(0, 1)
        lam = (c1 - c2).permute(2, 0, 1) \
            * (self.de / (2 * np.pi) ** 2) * self.spin
        lam = torch.where(self._mask(hwcut)[None], lam, _zero(lam)).real
        # real symmetric in mode space
        return _host(0.5 * (lam + lam.transpose(1, 2)))

    # -- nonequilibrium part -----------------------------------------------
    def nonequ_lambda_fft(self, hwcut, muL, muR, mu0: float = 0.0):
        E, dev = self.E, self.device
        f0 = fermi(E, mu0, self.T)
        dfL = _f64(fermi(E, muL, self.T) - f0, dev)[:, None, None]
        dfR = _f64(fermi(E, muR, self.T) - f0, dev)[:, None, None]
        # u = M (AL dfL + AR dfR): the weighted combined field, once
        Au = self.sp["AL"] * dfL + self.sp["AR"] * dfR
        A = self.sp["A"]
        pref = (self.de / (2 * np.pi) ** 2) * self.spin
        mask = self._mask(hwcut)[None]

        def pair(name, Av):
            c1 = self._corr(name, Au, Av, None, None).permute(2, 0, 1)
            c2 = self._corr(name + "_swapped", Au, Av, None, None,
                            swapped=True).transpose(0, 1).permute(2, 0, 1)
            return c1, c2

        def t12(x):
            return x.transpose(1, 2)

        c1, c2 = pair("nonequ", A)
        diff, summ = (c1 - c2) * pref, (c1 + c2) * pref
        lam = 0.5 * (diff.real + t12(diff.real)) \
            + 0.5j * (summ.imag - t12(summ.imag))
        lam = torch.where(mask, lam, _zero(lam))

        # Hilbert partner with sym Re G in place of A; H{A} = -2 Re G
        # carries an extra factor 2
        h1, h2 = pair("hilbert", self.sp["ReG"])
        prefH = 2.0 * pref
        diffH, summH = (h1 - h2) * prefH, (h1 + h2) * prefH
        hlam = 0.5 * (summH.real + t12(summH.real)) \
            + 0.5j * (diffH.imag - t12(diffH.imag))
        hlam = torch.where(mask, hlam, _zero(hlam))
        return _host(lam), _host(hlam)

    # -- wideband matrices -------------------------------------------------
    def wideband(self, hwcut, mu0: float = 0.0):
        with self._section("wideband"):
            return self._wideband(hwcut, mu0)

    def _wideband(self, hwcut, mu0):
        MLL = self.mama(mu0, mu0, "L", "L", hwcut)
        MRR = self.mama(mu0, mu0, "R", "R", hwcut)
        MLR = self.mama(mu0, mu0, "L", "R", hwcut)
        MRL = self.mama(mu0, mu0, "R", "L", hwcut)
        eta = np.real(MLL + MRR + MLR + MRL) / 4 / np.pi
        xim = np.imag(MLR) / 2 / np.pi
        xip = np.real(MLR) / 2 / np.pi

        # zeta1 / zeta2 from Tr[M (AL - AR) M ReG] and its dReG/dE
        # variant at mu0
        iw = nearest(mu0, self.E)
        iwp = nearest(self.E[iw] + self.de, self.E)
        iwm = nearest(self.E[iw] - self.de, self.E)
        if iwp == iw or iwm == iw:
            raise ValueError(
                f"wideband: mu0={mu0} sits at the energy-grid edge "
                f"(E[iw]={self.E[iw]:.6g}); the dReG/dE finite "
                "difference needs both neighbors — enlarge emax or "
                "shift mu0")
        denomE = float(self.E[iwp] - self.E[iwm])
        dAm = self.sp["AL"][iw] - self.sp["AR"][iw]
        ReG = self.sp["ReG"][iw]
        dReG = (self.sp["ReG"][iwp] - self.sp["ReG"][iwm]) / denomE
        mask = _pair_mask(self.hw, hwcut)

        Xa = torch.einsum("kpq,qr->kpr", self.M, dAm)
        Yb = torch.einsum("lrs,sp->lrp", self.M, ReG)
        Yc = torch.einsum("lrs,sp->lrp", self.M, dReG)
        z1 = _host(torch.einsum("kpr,lrp->kl", Xa, Yb).real) / np.pi
        z2 = _host(torch.einsum("kpr,lrp->kl", Xa, Yc).imag) / np.pi
        z1 = np.where(mask, z1, 0.0)
        z2 = np.where(mask, z2, 0.0)
        zeta1 = np.tril(z1) + np.tril(z1, -1).T
        zeta2 = np.tril(z2, -1) - np.tril(z2, -1).T   # antisym, zero diag

        out = {"eta": eta, "xim": xim, "xip": xip,
               "zeta1": zeta1, "zeta2": zeta2}
        if self.Umodes is not None:
            Um = self.Umodes
            for k in list(out):
                out[k + "_r"] = Um.T @ out[k] @ Um
        return out

    # -- full Lambda + Pi^r ------------------------------------------------
    def full_lambda(self, hwcut, muL, muR, mu0: float = 0.0):
        LamLL = self.lambda_fft("L", "L", muL, muL, hwcut)
        LamRR = self.lambda_fft("R", "R", muR, muR, hwcut)
        LamLR = self.lambda_fft("L", "R", muL, muR, hwcut)
        LamRL = self.lambda_fft("R", "L", muR, muL, hwcut)
        LamLL, LamRR, LamLR, LamRL = domapping(
            self.E, muL, muR, LamLL, LamRR, LamLR, LamRL)
        LamEqu = self.equ_lambda_fft(hwcut, mu0)
        LamNon, LamHNon = self.nonequ_lambda_fft(hwcut, muL, muR, mu0)
        Lam = LamLL + LamRR + LamLR + LamRL
        Pir = pir_from_pira(self.E, 2.0 * np.pi * 1j * Lam)
        Pir2 = 1j * np.pi * (LamEqu + LamNon - 1j * LamHNon)
        return {"wl": self.E, "LamLL": LamLL, "LamRR": LamRR,
                "LamLR": LamLR, "LamRL": LamRL, "LamEqu": LamEqu,
                "LamNon": LamNon, "LamHNon": LamHNon,
                "Pir": Pir, "Pir2": Pir2, "TR": _host(self.sp["TR"])}

    def write(self, outfile, hwcut, muL, muR, mu0=0.0):
        """Compute everything and write a Lambda bundle (npz or NetCDF)
        readable by ``utils.io.ReadLambda``; returns (full, wideband)."""
        from sclmd_tpu_torch.utils.io import _write_vars
        wb = self.wideband(hwcut, mu0)
        full = self.full_lambda(hwcut, muL, muR, mu0)
        arrays = {"wl": reord(full["wl"]), "muLR": np.array([muL, muR]),
                  "T": np.array([self.T]),
                  "trans": reord(full["TR"]),
                  "AL": reord(_host(self.sp["ALtr"])),
                  "AR": reord(_host(self.sp["ARtr"]))}
        for k in ("LamLL", "LamRR", "LamLR", "LamRL", "LamEqu",
                  "LamNon", "LamHNon", "Pir", "Pir2"):
            v = reord(full[k])
            arrays["Re" + k] = v.real
            arrays["Im" + k] = v.imag
        for k, v in wb.items():
            arrays[k] = v
        _write_vars(outfile, arrays)
        return full, wb

    def flops(self) -> dict:
        """Real operations of ``write`` reckoned from the shapes: the
        spectral functions and the ten correlations."""
        nm, ne = self.M.shape[0], len(self.E)
        return {"spectral_functions": spectral_flops(ne, self.n),
                "correlation": correlation_flops(nm, ne, self.n),
                "correlations": len(CORRELATIONS)}


def domapping(E, fermiL, fermiR, LamLL, LamRR, LamLR, LamRL):
    """Negative-frequency completion by Lam^{ab}(w) = -Lam^{ba}(-w)^T
    (host numpy)."""
    E = np.asarray(E)
    out = [np.array(LamLL), np.array(LamRR),
           np.array(LamLR), np.array(LamRL)]
    for i in range(len(E)):
        ir = nearest(-E[i], E)
        if E[i] < 0:
            out[0][i] = -np.transpose(LamLL[ir])
            out[1][i] = -np.transpose(LamRR[ir])
        if E[i] < fermiL - fermiR:
            out[2][i] = -np.transpose(LamRL[ir])
        if E[i] < fermiR - fermiL:
            out[3][i] = -np.transpose(LamLR[ir])
    return out


def pir_from_pira(E, Pira):
    """Retarded Pi^r from Pi^r - Pi^a: FFT to time, zero negative times,
    halve t=0, FFT back, with exponentially decaying middle padding
    (host numpy)."""
    Pira = np.asarray(Pira)
    nf = len(E)
    npad = (nf // 2) * 2
    nm = Pira.shape[-1]
    # decaying pad rows anchored on the grid-edge values
    pad = np.zeros((npad, nm, nm), complex)
    for i in range(npad // 2):
        pad[i] = np.conjugate(Pira[nf // 2]) * \
            np.exp(-i / (npad / 2 / 10.0))
        pad[npad - 1 - i] = Pira[nf // 2] * np.exp(-(i + 1) /
                                                   (npad / 2 / 10.0))
    Pp = np.concatenate([Pira[: nf // 2], pad, Pira[nf // 2:]], axis=0)
    nfft = nf + npad
    # w -> t in the physics convention f(t) = int dw/2pi X(w) e^{-iwt}
    # (discrete: plain fft); indices >= nfft/2 are then NEGATIVE times.
    # Constants cancel in the round trip.
    tmp = np.fft.fft(Pp, axis=0)
    tmp[nfft // 2:] = 0.0
    tmp[0] *= 0.5
    back = np.fft.ifft(np.real(tmp), axis=0)
    return np.concatenate([back[: nf // 2], back[nf // 2 + npad:]], axis=0)


# ---------------------------------------------------------------------------
# bias-dependent mode analysis (host)
# ---------------------------------------------------------------------------
def eigenanalysis(Vmax, nlen, hw, eta, xim, zeta1, zeta2):
    """Bias-dependent complex phonon modes from the first-order companion
    matrix. Returns (blist, invQ (nlen, nm), nhw (nlen, nm))."""
    hw = np.asarray(hw)
    nm = len(hw)
    dynmat = np.diag(hw ** 2)
    blist = Vmax * np.arange(nlen) / nlen
    invQs = np.zeros((nlen, nm))
    nhws = np.zeros((nlen, nm))
    for j, tb in enumerate(blist):
        tmat = np.zeros((2 * nm, 2 * nm))
        tmat[:nm, :nm] = -eta - tb * zeta2
        tmat[:nm, nm:] = -dynmat + tb * xim - tb * zeta1
        tmat[nm:, :nm] = np.identity(nm)
        evs = np.linalg.eigvals(tmat)
        sel = evs[evs.imag < 0]
        sel = sel[np.argsort(sel.imag)][::-1][:nm] \
            if len(sel) >= nm else np.pad(sel, (0, nm - len(sel)))
        invQs[j, : len(sel)] = np.where(sel.imag != 0,
                                        2 * sel.real / sel.imag, 0.0)
        nhws[j, : len(sel)] = -sel.imag
    return blist, invQs, nhws


def joule_heating(Vmax, nlen, hw, eta, xim, xip, zeta1, zeta2, T=4.2):
    """Bias-induced steady-state phonon occupation:
    n(V) = n_B(hw) + [cof+ + cof-] xip_jj / (2 hw eta_jj), vectorised
    over (bias, mode)."""
    hw = np.asarray(hw, float)
    eta_d = np.diag(np.asarray(eta))
    xip_d = np.diag(np.asarray(xip))
    blist = Vmax * np.arange(nlen) / nlen
    hb = hw[None, :]                                 # (1, nm)
    tb = blist[:, None]                              # (nlen, 1)
    n0 = bose(hw, T)[None, :]
    cofp = (hb + tb) * (bose(hb + tb, T) - n0)
    cofm = (hb - tb) * (bose(hb - tb, T) - n0)
    ok = (hb > 0) & (eta_d[None, :] > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        nph = np.where(
            ok, (cofp + cofm) * xip_d[None, :]
            / np.where(hb > 0, hb, 1.0)
            / np.where(eta_d[None, :] > 0, eta_d[None, :], 1.0) / 2
            + n0, 0.0)
    return blist, nph


def prepare_eph_matrices(Mraw, hw):
    """Hermitise + sqrt(2 hw) normalisation of raw Inelastica He_ph:
    M = sym(M) * sqrt(2 hw) for hw > 0, zero otherwise (host numpy)."""
    Mraw = np.asarray(Mraw)
    hw = np.asarray(hw)
    out = np.zeros_like(Mraw, dtype=complex)
    for i in range(len(hw)):
        h = 0.5 * (Mraw[i] + np.conjugate(Mraw[i].T))
        out[i] = h * np.sqrt(2 * hw[i]) if hw[i] > 0 else 0.0
    return out
