"""Readers and writers of electron-phonon structure artifacts
(counterpart of ``sclmd_tpu.utils.io``; host numpy only).

The upstream DFT artifacts (dynamical matrices, lead self-energies, the
wideband e-ph matrices eta/xim/xip/zeta1/zeta2, Lambda(w) bundles) are
NetCDF files. Every reader takes NetCDF where the ``netCDF4`` package is
installed and otherwise the ``.npz`` layout with the same variable names;
the files are byte-compatible with the JAX package's, so a file written
by either package is read by the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from sclmd_tpu_torch.ops.functions import nearest

try:
    import netCDF4  # type: ignore
    HAVE_NETCDF = True
except ImportError:   # pragma: no cover - netCDF4 is optional
    netCDF4 = None
    HAVE_NETCDF = False


def _open_vars(filename):
    """Return a dict-like of arrays from .npz or NetCDF."""
    if filename.endswith(".npz") or not HAVE_NETCDF:
        data = np.load(filename)
        return {k: np.asarray(data[k]) for k in data.files}
    ds = netCDF4.Dataset(filename, "r")
    out = {k: np.asarray(ds.variables[k]) for k in ds.variables}
    ds.close()
    return out


def _write_vars(filename, arrays: dict, units: Optional[dict] = None):
    """Write arrays to .npz, or NetCDF when asked for and available."""
    if filename.endswith(".nc") and HAVE_NETCDF:
        ds = netCDF4.Dataset(filename, "w")
        for k, v in arrays.items():
            v = np.asarray(v)
            dims = []
            for ax, nlen in enumerate(v.shape):
                dname = f"{k}_d{ax}"
                ds.createDimension(dname, nlen)
                dims.append(dname)
            var = ds.createVariable(k, "d", tuple(dims))
            var[:] = v
            if units and k in units:
                var.units = units[k]
        ds.close()
        return
    if filename.endswith(".nc"):
        filename = filename[:-3] + ".npz"
    np.savez(filename, **{k: np.asarray(v) for k, v in arrays.items()})


def Write2NetCDFFile(file, var, varLabel, dimensions, units=None,
                     description=None):
    """Write one variable into an OPEN netCDF4 Dataset (md.py:749-757).

    Reference-named helper; requires netCDF4 (the npz backend of
    ``_write_vars`` is the persistence path without it).
    """
    if not HAVE_NETCDF:
        raise RuntimeError("netCDF4 is not installed; use the npz "
                           "backend (_write_vars)")
    tmp = file.createVariable(varLabel, "d", dimensions, zlib=True)
    tmp[:] = var
    if units:
        tmp.units = units
    if description:
        tmp.description = description


def ReadNetCDFVar(file, var):
    """Read one variable from a NetCDF (or npz fallback) file by name
    (md.py:759-764)."""
    return _open_vars(file)[var]


# ---------------------------------------------------------------------------
# EPH files: dynamical matrix + self-energies + friction matrices
# ---------------------------------------------------------------------------
@dataclass
class EPHData:
    """Container mirroring the reference's ``eph`` attribute bag
    (myio.py:80-135)."""
    filename: str = ""
    wl: np.ndarray = None
    hw: np.ndarray = None
    U: np.ndarray = None
    DynMat: np.ndarray = None
    SigL: np.ndarray = None
    SigR: np.ndarray = None
    efric: np.ndarray = None
    xim: np.ndarray = None
    xip: np.ndarray = None
    zeta1: Optional[np.ndarray] = None
    zeta2: Optional[np.ndarray] = None


def ReadEPHNCFile(filename) -> EPHData:
    """Read dynamical matrix, lead self-energies and friction matrices
    (myio.py:80-106)."""
    v = _open_vars(filename)
    return EPHData(
        filename=filename, wl=v["Wlist"], hw=v["hw"], U=v["U"],
        DynMat=v["DynMat"],
        SigL=v["ReSigL"] + 1j * v["ImSigL"],
        SigR=v["ReSigR"] + 1j * v["ImSigR"],
        efric=v["Friction"], xim=v["NC"], xip=v["NCP"],
    )


def ReadNewEPHNCFile(filename) -> EPHData:
    """As ReadEPHNCFile plus zeta1/zeta2 (myio.py:109-135)."""
    eph = ReadEPHNCFile(filename)
    v = _open_vars(filename)
    eph.zeta1 = v["zeta1"]
    eph.zeta2 = v["zeta2"]
    return eph


def WriteEPHNCfile(filename, wl, hw, U, DynMat, SigL, SigR, Friction,
                   NC, NCP, zeta1, zeta2):
    """Write the harmonic-analysis bundle (myio.py:138-171)."""
    SigL = np.asarray(SigL)
    SigR = np.asarray(SigR)
    _write_vars(filename, {
        "Wlist": wl, "hw": hw, "U": U, "DynMat": DynMat,
        "ReSigL": SigL.real, "ImSigL": SigL.imag,
        "ReSigR": SigR.real, "ImSigR": SigR.imag,
        "Friction": Friction, "NC": NC, "NCP": NCP,
        "zeta1": zeta1, "zeta2": zeta2,
    }, units={"Wlist": "eV", "hw": "eV", "DynMat": "eV**2"})


def ReadSig(filename) -> EPHData:
    """Read just the lead self-energies (myio.py:300-316)."""
    v = _open_vars(filename)
    out = EPHData(filename=filename, wl=v["Wlist"])
    out.SigL = v["ReSigL"] + 1j * v["ImSigL"]
    out.SigR = v["ReSigR"] + 1j * v["ImSigR"]
    return out


# ---------------------------------------------------------------------------
# MD geometry files
# ---------------------------------------------------------------------------
@dataclass
class MDGeometry:
    filename: str = ""
    cell: np.ndarray = None
    xyz: np.ndarray = None
    dynatom: np.ndarray = None
    atomlist: np.ndarray = None


def ReadMDNCFile(filename) -> MDGeometry:
    """Read unit cell + geometry (myio.py:192-211)."""
    v = _open_vars(filename)
    return MDGeometry(filename=filename, cell=v["UnitCell"], xyz=v["XYZ"],
                      dynatom=v["DynamicAtoms"], atomlist=v["AtomList"])


def ord2idx(order):
    """Atom order (1-based) -> DOF index list (myio.py:291-297)."""
    order = np.asarray(order, dtype=np.int64)
    return (3 * (order[:, None] - 1) + np.arange(3)[None, :]).reshape(-1)


def reordxyz(anr, xyz, ord):
    """Reorder an atom list block (myio.py:64-77)."""
    old = sorted(ord)
    nl = list(range(old[0] - 1)) + [i - 1 for i in ord] + \
        list(range(old[-1], len(xyz)))
    if len(nl) != len(anr):
        raise ValueError("reordxyz: length error")
    return [anr[i] for i in nl], [xyz[i] for i in nl]


def read_lammps_data(filename, md2ang=None):
    """Read a LAMMPS data file (the reference's workload inputs, e.g.
    examples/structure.data) into driver-ready pieces.

    Supports the ``atomic`` (id type x y z) and ``full``
    (id mol type q x y z) Atoms styles; element names resolve from the
    Masses section via the atomic-mass table. Returns a dict with
    ``axyz`` ([[el, x, y, z], ...] sorted by atom id — feed directly to
    any driver or ``md(axyz=...)``), ``cell`` (3, 3), ``els``,
    ``masses``, ``types``.
    """
    from sclmd_tpu_torch.units import get_atomname
    masses = {}
    box = {}
    atoms = []
    natoms = None
    section = None
    style = None
    with open(filename) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            comment = raw.split("#", 1)[1].strip() if "#" in raw else ""
            if not line:
                continue
            low = line.lower()
            if low.endswith("atoms") and natoms is None and \
                    line.split()[0].isdigit():
                natoms = int(line.split()[0])
                continue
            if "xlo" in low or "ylo" in low or "zlo" in low:
                parts = line.split()
                box[parts[2][0]] = (float(parts[0]), float(parts[1]))
                continue
            if low == "masses":
                section = "masses"
                continue
            if low == "atoms":
                section = "atoms"
                style = comment.lower() or "atomic"
                continue
            if low in ("velocities", "bonds", "angles", "dihedrals",
                       "impropers", "pair coeffs", "bond coeffs"):
                section = None
                continue
            if section == "masses":
                parts = line.split()
                masses[int(parts[0])] = float(parts[1])
            elif section == "atoms":
                parts = line.split()
                if style.startswith("full"):
                    aid, typ = int(parts[0]), int(parts[2])
                    x, y, z = map(float, parts[4:7])
                elif style.startswith("charge"):
                    aid, typ = int(parts[0]), int(parts[1])
                    x, y, z = map(float, parts[3:6])
                else:  # atomic / molecular-ish fallback by column count
                    aid, typ = int(parts[0]), int(parts[1])
                    x, y, z = map(float, parts[2:5])
                atoms.append((aid, typ, x, y, z))
    if natoms is not None and len(atoms) != natoms:
        raise ValueError(f"{filename}: header says {natoms} atoms, "
                         f"parsed {len(atoms)}")
    atoms.sort()
    types = np.array([a[1] for a in atoms])
    els = [get_atomname(masses[t]) or f"type{t}" for t in types]
    axyz = [[els[i], a[2], a[3], a[4]] for i, a in enumerate(atoms)]
    cell = np.diag([box[ax][1] - box[ax][0] for ax in ("x", "y", "z")]) \
        if len(box) == 3 else None
    return {"axyz": axyz, "cell": cell, "els": els,
            "masses": np.array([masses[t] for t in types]),
            "types": types}


def cutlayers(xyz, nalayer, nl, nr, anr=None, snr=None, pbc=None,
              ord=None):
    """Cut ``nl`` leading and ``nr`` trailing layers off a layered
    structure for MD (myio.py:12-61 — dead commented-out code in the
    reference; resurrected here array-based: the Inelastica ``Geom``
    object becomes plain arrays).

    xyz : (na, 3) positions, layer-ordered along z.
    nalayer : atoms per layer; nl/nr : layers removed from the two ends.
    anr/snr : optional per-atom labels that travel with the atoms.
    pbc : optional (3, 3) cell — its z-extent shrinks by the removed
        length, as in the reference.
    ord : optional 1-based atom reordering applied first (reordxyz).

    Returns a dict with keys xyz, anr, snr, pbc (absent inputs -> None).
    """
    xyz = np.asarray(xyz, dtype=float)
    na = len(xyz)
    anr = None if anr is None else list(anr)
    snr = None if snr is None else list(snr)
    if ord is not None:
        if anr is None:
            anr = list(range(1, na + 1))
        anr, xyz = reordxyz(anr, list(xyz), ord)
        xyz = np.asarray(xyz, dtype=float)
        if snr is not None:
            _, snr = reordxyz(list(range(len(snr))), snr, ord)
    nal, nar = nl * nalayer, nr * nalayer
    if nal + nar >= na:
        raise ValueError(
            f"cutlayers: cutting {nal}+{nar} atoms from {na}")
    olen = xyz[:, 2].max() - xyz[:, 2].min()
    keep = slice(nal, na - nar)
    nxyz = xyz[keep]
    nlen = nxyz[:, 2].max() - nxyz[:, 2].min()
    npbc = None
    if pbc is not None:
        npbc = np.array(pbc, dtype=float)
        npbc[2][2] = npbc[2][2] - (olen - nlen)
    return {
        "xyz": nxyz,
        "anr": None if anr is None else anr[keep.start:keep.stop],
        "snr": None if snr is None else snr[keep.start:keep.stop],
        "pbc": npbc,
    }


def ReadDynmat(filename, order=None):
    """Phonon-run eigendata -> real-space dynamical matrix
    (myio.py:214-253): D = U^T diag(hw^2) U, symmetrised; columns
    reordered when ``order`` (1-based atom order) is given."""
    v = _open_vars(filename)
    hw = np.asarray(v["hw"])
    fullU = np.asarray(v["U"])
    nlen = len(fullU)
    if "DynamicAtoms" in v:
        dyn_atoms = np.asarray(v["DynamicAtoms"])
        idF = int(dyn_atoms[0]) - 1
        idL = int(dyn_atoms[-1])
        U = np.zeros((nlen, nlen))
        for ii in range(nlen):
            U[ii] = np.asarray(fullU[ii][idF:idL]).flatten()
    else:
        U = fullU
    if order is not None:
        if 3 * len(order) != len(hw):
            raise ValueError("ReadDynmat: length of order error")
        idx = ord2idx(order)
        U = U[:, idx]
    dyn = U.T @ np.diag(hw ** 2) @ U
    return 0.5 * (dyn + dyn.T), U, hw


# ---------------------------------------------------------------------------
# Lambda files: wideband current-induced-force matrices
# ---------------------------------------------------------------------------
def ReadwbLambda(filename, order=None):
    """Wideband eta/xim/xip/zeta1/zeta2 matrices (myio.py:319-336);
    bias is zero by construction for the wideband file."""
    v = _open_vars(filename)
    return (0.0, v["eta"], v["xim"], v["xip"], v["zeta1"], v["zeta2"])


def ReadLambda(filename, w0, order=None):
    """Extract the wideband matrices from a full Lambda(w) file at the
    energy point nearest w0 (myio.py:339-366):

        eta   = -sym(Im Pi^r)/w          zeta2 = -asym(Im Pi^r)/(w V)
        xim   = -asym(Re Pi^r)/V         zeta1 =  sym(Re Pi^r)/V
        xip   = -pi sym(Re Lam_LR)/w
    """
    v = _open_vars(filename)
    wl = np.asarray(v["wl"])
    mus = np.asarray(v["muLR"])
    bias = float(mus[0] - mus[1])
    idx = nearest(w0, wl)
    w00 = float(wl[idx])

    eta0 = np.asarray(v["ImPir2"][idx])
    eta = -(eta0 + eta0.T) / 2 / w00
    zeta2 = -(eta0 - eta0.T) / 2 / w00 / bias
    xim0 = np.asarray(v["RePir2"][idx])
    xim = -(xim0 - xim0.T) / 2 / bias
    zeta1 = (xim0 + xim0.T) / 2 / bias
    xip = np.asarray(v["ReLamLR"][idx])
    xip = -np.pi * (xip + xip.T) / 2 / w00
    return bias, eta, xim, xip, zeta1, zeta2


def WriteLambda(filename, wl, muLR, ImPir2, RePir2, ReLamLR):
    """Write a Lambda(w) bundle consumable by ReadLambda."""
    _write_vars(filename, {"wl": wl, "muLR": muLR, "ImPir2": ImPir2,
                           "RePir2": RePir2, "ReLamLR": ReLamLR})


def WritewbLambda(filename, eta, xim, xip, zeta1, zeta2):
    """Write the wideband matrices consumable by ReadwbLambda."""
    _write_vars(filename, {"eta": eta, "xim": xim, "xip": xip,
                           "zeta1": zeta1, "zeta2": zeta2})
