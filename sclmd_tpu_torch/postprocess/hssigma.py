"""Real-space lead self-energy extraction (HSSigma) on the card
(counterpart of ``sclmd_tpu.postprocess.hssigma``).

Given per-k-point device Hamiltonians/overlaps and pivoted lead
self-energies (from a TranSiesta/tbtrans run), produce the k-averaged
REAL-SPACE self-energies consumed by the Lambda pipeline:

    Gbar_x(E)  = sum_k w_k (G_x(E,k) + G_x(E,k)^T)/2    (time reversal)
    Sigma_x(E) = (E + i eta) Sbar - Hbar - Gbar_x(E)^{-1}

for x in {L, R, tot}, plus transmission diagnostics.

``kaverage_extract`` runs in complex128 on ``device`` (default: the CUDA
card), batched over (E, k): the inverses of a chunk of energies go
through ``lambda_pipeline.batched_inv`` in fixed groups, so no result
depends on ``batch_size``. File ingestion from sisl/TSHS and netCDF4 is
gated; arrays go in/out via ``sclmd_tpu_torch.utils.io`` (npz or NetCDF).
"""

from __future__ import annotations

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch.postprocess.lambda_pipeline import (
    C128, _c128, _chunk_of, _dag, _f64, _host, batched_inv)


def expand_pivoted_sigma(SFE, pivot, n: int):
    """Scatter a pivoted (np, np) self-energy block into the full
    (n, n) orbital space (hssigma.py:233-241). ``pivot`` holds the full-
    space orbital index of each pivoted row. Batched over leading axes.
    """
    SFE = np.asarray(SFE)
    pivot = np.asarray(pivot, dtype=np.int64)
    out_shape = SFE.shape[:-2] + (n, n)
    out = np.zeros(out_shape, dtype=complex)
    out[..., pivot[:, None], pivot[None, :]] = SFE
    return out


def kaverage_extract(Hk, Sk, SigLk, SigRk, E, wk, eta: float = 1e-4,
                     batch_size: int = 8, device=None):
    """k-averaged real-space self-energies over an energy grid.

    Parameters
    ----------
    Hk, Sk : (nk, n, n) device Hamiltonian/overlap per k-point (eV).
    SigLk, SigRk : (ne, nk, n, n) lead self-energies per energy/k.
    E : (ne,) energies (eV); wk : (nk,) k weights (sum to 1).
    eta : imaginary broadening (eV) — NOT included in the input SFE.
    batch_size : energies whose (E, k) matrices are built at once
        (rounded up to whole solve groups); the results do not depend
        on it.
    device : where it runs (default: the CUDA card).

    Returns dict (host numpy) with Hbar, Sbar, SigmaL, SigmaR, SigmaTOT
    (ne, n, n), and transmissions T_k (ne, nk), T_rs (ne) computed from
    the real-space matrices.
    """
    dev = resolve_device(device)
    Hk, Sk = _c128(Hk, dev), _c128(Sk, dev)
    SigLk, SigRk = _c128(SigLk, dev), _c128(SigRk, dev)
    E = _f64(E, dev)
    wk = _f64(wk, dev).to(C128)
    nk, n = Hk.shape[0], Hk.shape[-1]

    def trs_sum(Xk):
        """sum_k w_k (X_k + X_k^T)/2 over the k axis (the one before the
        matrix axes)."""
        return torch.einsum("k,...kij->...ij", wk,
                            0.5 * (Xk + Xk.transpose(-1, -2)))

    def inv(a):
        return batched_inv(a.reshape(-1, n, n)).reshape(a.shape)

    Hbar = trs_sum(Hk)
    Sbar = trs_sum(Sk)
    parts = {k: [] for k in ("SigmaL", "SigmaR", "SigmaTOT", "T_k", "T_rs")}
    chunk = _chunk_of(batch_size)
    for i0 in range(0, E.shape[0], chunk):
        sl, sr = SigLk[i0:i0 + chunk], SigRk[i0:i0 + chunk]
        z = (E[i0:i0 + chunk] + 1j * eta).to(C128)
        base = z[:, None, None, None] * Sk - Hk         # (ce, nk, n, n)
        G, GL, GR = inv(base - sl - sr), inv(base - sl), inv(base - sr)
        gamL = 1j * (sl - _dag(sl))
        gamR = 1j * (sr - _dag(sr))
        Tk = (gamR @ G @ gamL @ _dag(G)).diagonal(dim1=-2, dim2=-1) \
            .sum(-1).real
        HSsum = z[:, None, None] * Sbar - Hbar           # (ce, n, n)
        SigTOT = HSsum - inv(trs_sum(G))
        SigL = HSsum - inv(trs_sum(GL))
        SigR = HSsum - inv(trs_sum(GR))
        # real-space transmission check
        gL = 1j * (SigL - _dag(SigL))
        gR = 1j * (SigR - _dag(SigR))
        Grs = inv(HSsum - SigL - SigR)
        Trs = (gR @ Grs @ gL @ _dag(Grs)).diagonal(dim1=-2, dim2=-1) \
            .sum(-1).real
        for k, v in (("SigmaL", SigL), ("SigmaR", SigR),
                     ("SigmaTOT", SigTOT), ("T_k", Tk), ("T_rs", Trs)):
            parts[k].append(v)
    out = {k: _host(torch.cat(v)) for k, v in parts.items()}
    out["Hbar"], out["Sbar"] = _host(Hbar), _host(Sbar)
    return out


def write_hssigma_mean(outfile, E, result, eta: float = 1e-4,
                       kpts=None):
    """Write an HSSigmaMEAN bundle consumable by the Lambda pipeline
    (readHS variable names, lambda.py:1542-1612)."""
    from sclmd_tpu_torch.utils.io import _write_vars
    arrays = {
        "ReE": np.asarray(E), "ImE": np.full(len(E), eta),
        "ReH": result["Hbar"].real, "ImH": result["Hbar"].imag,
        "ReS": result["Sbar"].real, "ImS": result["Sbar"].imag,
        "ReSigmaL": result["SigmaL"].real,
        "ImSigmaL": result["SigmaL"].imag,
        "ReSigmaR": result["SigmaR"].real,
        "ImSigmaR": result["SigmaR"].imag,
        "ReSigmaTOT": result["SigmaTOT"].real,
        "ImSigmaTOT": result["SigmaTOT"].imag,
        "Trans": result["T_rs"],
    }
    if kpts is not None:
        arrays["kpts"] = np.asarray(kpts)
    _write_vars(outfile, arrays)


# ---------------------------------------------------------------------------
# File-to-file ingestion: the reference's RunName workflow
# (hssigma.py:12-17, 134-418): <RunName>.TBT.SE.nc + <RunName>.TSHS
# -> HSSigmaMEAN + Trans.realspace.dat.
# ---------------------------------------------------------------------------
_RY_EV = 13.6058  # Rydberg -> eV (hssigma.py:21)


def read_tbt_se(filename):
    """Read a tbtrans TBT.SE.nc bundle (hssigma.py:47-123).

    Returns a dict with the pivoted lead self-energies converted to eV
    (SigL/SigR: (ne, nk, np, np) complex), 0-based pivots, the device
    orbital window [iod1, iod2), energies in eV, and k-points/weights.

    Backends: netCDF4 when available (real tbtrans output, with its
    Left/Right groups); otherwise an npz bundle of the same name with
    the group variables flattened to ``Left_pivot``,
    ``Left_ReSelfEnergy``, ... (the documented converter: open the .nc
    once where netCDF4 exists and np.savez the listed variables).
    """
    import os
    try:
        from netCDF4 import Dataset  # gated: optional
        have_nc = os.path.exists(filename)
    except ImportError:
        have_nc = False
    if have_nc:
        nc = Dataset(filename)
        try:
            def _var(name):
                return np.asarray(nc.variables[name][:])

            def _gvar(g, name):
                return np.asarray(nc.groups[g].variables[name][:])
        finally:
            pass
    else:
        fn = filename if os.path.exists(filename) \
            else os.path.splitext(filename)[0] + ".npz"
        if not os.path.exists(fn):
            raise FileNotFoundError(
                f"neither netCDF4+{filename} nor its npz bundle {fn} "
                "available (see read_tbt_se docstring)")
        d = np.load(fn)
        nc = None

        def _var(name):
            return np.asarray(d[name])

        def _gvar(g, name):
            return np.asarray(d[f"{g}_{name}"])

    try:
        pvl = _gvar("Left", "pivot") - 1
        pvr = _gvar("Right", "pivot") - 1

        # stored (nk, ne, np, np) per the reference's rSL[ikpt, ien]
        def _sig(g):
            re = _gvar(g, "ReSelfEnergy")
            im = _gvar(g, "ImSelfEnergy")
            return (re + 1j * im).transpose(1, 0, 2, 3) * _RY_EV
        SigL = _sig("Left")
        SigR = _sig("Right")
        lasto = _var("lasto")
        a_dev = np.sort(_var("a_dev"))
        kpts = _var("kpt")
        wkpts = _var("wkpt")
        ens = _var("E") * _RY_EV
    finally:
        if nc is not None:
            nc.close()
    iad1, iad2 = a_dev[0] - 1, a_dev[-1] - 1
    iod1 = int(lasto[iad1 - 1]) if iad1 > 0 else 0
    iod2 = int(lasto[iad2])
    return {"pvl": pvl, "pvr": pvr, "SigL": SigL, "SigR": SigR,
            "lasto": lasto, "a_dev": a_dev, "iod1": iod1, "iod2": iod2,
            "kpts": kpts, "wkpts": wkpts, "E": ens}


def read_device_hs(runname, kpts, iod1: int, iod2: int):
    """Device-window H(k), S(k) in eV: sisl-gated TSHS reader with an
    npz fallback.

    With sisl installed, reads <runname>.TSHS and
    Fourier-transforms per k (hssigma.py:42-45, 148-156). Otherwise
    falls back to <runname>.HSk.npz holding dense Hk/Sk (nk, n, n) —
    produced elsewhere by the one-liner documented here::

        import sisl, numpy as np
        H = sisl.Hamiltonian.read(runname + ".TSHS")
        np.savez(runname + ".HSk.npz",
                 Hk=np.stack([H.Hk(k).toarray() for k in kpts]),
                 Sk=np.stack([H.Sk(k).toarray() for k in kpts]))
    """
    try:
        import sisl  # gated: optional
        H = sisl.Hamiltonian.read(runname + ".TSHS")
        Hk = np.stack([np.asarray(H.Hk(k).todense()) for k in kpts])
        Sk = np.stack([np.asarray(H.Sk(k).todense()) for k in kpts])
    except ImportError:
        import os
        fn = runname + ".HSk.npz"
        if not os.path.exists(fn):
            raise FileNotFoundError(
                f"sisl is unavailable and {fn} not found — convert the "
                "TSHS once with sisl (see read_device_hs docstring)")
        d = np.load(fn)
        Hk, Sk = np.asarray(d["Hk"]), np.asarray(d["Sk"])
    return Hk[:, iod1:iod2, iod1:iod2], Sk[:, iod1:iod2, iod1:iod2]


def read_xv(filename):
    """Minimal Siesta .XV reader (cell in Bohr -> Ang, species numbers,
    positions) — replaces the reference's Inelastica MakeGeom dependency
    (hssigma.py:33-38) for the geometry metadata."""
    bohr = 0.529177
    with open(filename) as fh:
        cell = np.array([[float(x) for x in fh.readline().split()[:3]]
                         for _ in range(3)]) * bohr
        na = int(fh.readline().split()[0])
        snr, anr, xyz = [], [], []
        for _ in range(na):
            parts = fh.readline().split()
            snr.append(int(parts[0]))
            anr.append(int(parts[1]))
            xyz.append([float(x) * bohr for x in parts[2:5]])
    return {"cell": cell, "snr": np.array(snr), "anr": np.array(anr),
            "xyz": np.array(xyz)}


def hssigma_main(runname, eta: float = 1e-4, batch_size: int = 8,
                 out_mean=None, trans_file="Trans.realspace.dat",
                 device=None):
    """The reference script's RunName workflow, file to file
    (hssigma.py:134-418): read <runname>.TBT.SE.nc (+ TSHS or HSk.npz),
    expand the pivoted self-energies into the device window, k-average
    with time-reversal symmetry, back-extract real-space Sigma_L/R/TOT,
    and write HSSigmaMEAN (npz or .nc by extension) plus the
    transmission diagnostic.

    Returns the kaverage_extract result dict.
    """
    se = read_tbt_se(runname + ".TBT.SE.nc")
    Hk, Sk = read_device_hs(runname, se["kpts"], se["iod1"], se["iod2"])
    n_full = int(se["lasto"][-1])
    iod1, iod2 = se["iod1"], se["iod2"]

    def expand(Sig, pv):
        full = expand_pivoted_sigma(Sig, pv, n_full)
        return full[..., iod1:iod2, iod1:iod2]

    SigLk = expand(se["SigL"], se["pvl"])
    SigRk = expand(se["SigR"], se["pvr"])
    result = kaverage_extract(Hk, Sk, SigLk, SigRk, se["E"],
                              se["wkpts"], eta=eta,
                              batch_size=batch_size, device=device)
    out_mean = out_mean or (runname + ".HSSigmaMEAN.npz")
    write_hssigma_mean(out_mean, se["E"], result, eta=eta,
                       kpts=se["kpts"])
    if trans_file:
        with open(trans_file, "w") as ft:
            ft.write("# Transmission using real-space self-energy\n")
            ft.write("# energy  T(k-avg)  T(realspace)\n")
            for i, e in enumerate(se["E"]):
                tk = float(np.dot(se["wkpts"], result["T_k"][i]))
                ft.write("%.8f %.8e %.8e\n" % (e, tk,
                                               float(result["T_rs"][i])))
    return result


def read_hssigma_mean(filename):
    """Read an HSSigmaMEAN bundle into (E, H, S, SigL, SigR) with the
    FFT-order rearrangement of readHS (lambda.py:1593-1610)."""
    from sclmd_tpu_torch.ops.functions import nearest
    from sclmd_tpu_torch.utils.io import _open_vars
    v = _open_vars(filename)
    En = np.asarray(v["ReE"])
    H = v["ReH"] + 1j * v.get("ImH", 0.0 * v["ReH"])
    S = v["ReS"] + 1j * v.get("ImS", 0.0 * v["ReS"])
    Sig1 = v["ReSigmaL"] + 1j * v["ImSigmaL"]
    Sig2 = v["ReSigmaR"] + 1j * v["ImSigmaR"]
    dw = En[1] - En[0]
    nw = int(len(En) / 2) * 2
    E = np.zeros(nw)
    S1 = np.zeros((nw,) + Sig1.shape[1:], complex)
    S2 = np.zeros((nw,) + Sig2.shape[1:], complex)
    for i in range(nw):
        w = dw * i
        if w >= dw * nw / 2:
            w = w - nw * dw
        iw = nearest(w, En)
        E[i] = w
        S1[i] = Sig1[iw]
        S2[i] = Sig2[iw]
    return E, H, S, S1, S2
