"""Parity of the port's artifact readers and writers
(``sclmd_tpu_torch.utils.io``) with the JAX package's, on the npz backend.

Every reader and writer of each package reads the files the other wrote:
the same keys and equal arrays (the files are byte-compatible). A
wbLambda bundle feeding the port's biased ``ebath`` gives the matrices
and noise factors of the JAX ``ebath`` built from the same file (float64,
within 1e-12 of the largest magnitude).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu.utils import io as JIO

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch.utils import io as TIO

PACKAGES = {"jax": JIO, "torch": TIO}
PAIRS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]


def _npz_equal(a, b):
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        np.testing.assert_array_equal(da[k], db[k])


def _eph_args(rng, nw=5, nph=6, ns=4):
    wl = np.linspace(0, 1, nw)
    hw = rng.random(nph)
    U = rng.normal(size=(nph, nph))
    dyn = rng.normal(size=(nph, nph))
    sigl = rng.normal(size=(nw, ns, ns)) + 1j * rng.normal(size=(nw, ns, ns))
    sigr = rng.normal(size=(nw, ns, ns)) + 1j * rng.normal(size=(nw, ns, ns))
    mats = [rng.normal(size=(nph, nph)) for _ in range(5)]
    return (wl, hw, U, dyn, sigl, sigr, *mats)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_eph_files_cross_read(tmp_path, rng, writer, reader):
    args = _eph_args(rng)
    path = str(tmp_path / "eph.npz")
    PACKAGES[writer].WriteEPHNCfile(path, *args)
    R = PACKAGES[reader]
    eph = R.ReadNewEPHNCFile(path)
    wl, hw, U, dyn, sigl, sigr, fr, nc, ncp, z1, z2 = args
    for got, want in ((eph.wl, wl), (eph.hw, hw), (eph.U, U),
                      (eph.DynMat, dyn), (eph.SigL, sigl), (eph.SigR, sigr),
                      (eph.efric, fr), (eph.xim, nc), (eph.xip, ncp),
                      (eph.zeta1, z1), (eph.zeta2, z2)):
        np.testing.assert_array_equal(got, want)
    old = R.ReadEPHNCFile(path)
    assert old.zeta1 is None and old.zeta2 is None
    np.testing.assert_array_equal(old.efric, fr)
    sig = R.ReadSig(path)
    np.testing.assert_array_equal(sig.SigL, sigl)
    np.testing.assert_array_equal(sig.SigR, sigr)
    np.testing.assert_array_equal(R.ReadNetCDFVar(path, "NCP"), ncp)


def test_writers_write_the_same_bytes(tmp_path, rng):
    args = _eph_args(rng)
    mats = [rng.normal(size=(4, 4)) for _ in range(5)]
    wl = np.linspace(-1, 1, 7)
    lam = [rng.normal(size=(7, 4, 4)) for _ in range(3)]
    for name, fn, fargs in (
            ("eph", "WriteEPHNCfile", args),
            ("wb", "WritewbLambda", mats),
            ("lam", "WriteLambda", (wl, np.array([0.3, -0.3]), *lam))):
        paths = [str(tmp_path / f"{name}_{p}.npz") for p in PACKAGES]
        for p, path in zip(PACKAGES, paths):
            getattr(PACKAGES[p], fn)(path, *fargs)
        _npz_equal(*paths)


def test_nc_name_falls_back_to_npz(tmp_path, rng):
    a = {"x": rng.normal(size=(3, 2)), "y": np.arange(4.0)}
    for p, mod in PACKAGES.items():
        mod._write_vars(str(tmp_path / f"v_{p}.nc"), a)
    assert os.path.exists(tmp_path / "v_torch.npz")
    _npz_equal(tmp_path / "v_jax.npz", tmp_path / "v_torch.npz")
    got = TIO._open_vars(str(tmp_path / "v_jax.npz"))
    np.testing.assert_array_equal(got["x"], a["x"])
    assert TIO.HAVE_NETCDF == JIO.HAVE_NETCDF
    if not TIO.HAVE_NETCDF:
        with pytest.raises(RuntimeError, match="netCDF4"):
            TIO.Write2NetCDFFile(None, a["x"], "x", ("d0", "d1"))


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_md_geometry_file(tmp_path, rng, writer, reader):
    arrays = {"UnitCell": np.eye(3) * 5.0, "XYZ": rng.normal(size=(4, 3)),
              "DynamicAtoms": np.array([2, 3]),
              "AtomList": np.array([1, 2, 3, 4])}
    path = str(tmp_path / "md.npz")
    PACKAGES[writer]._write_vars(path, arrays)
    g = PACKAGES[reader].ReadMDNCFile(path)
    for got, key in ((g.cell, "UnitCell"), (g.xyz, "XYZ"),
                     (g.dynatom, "DynamicAtoms"), (g.atomlist, "AtomList")):
        np.testing.assert_array_equal(got, arrays[key])


def test_ord2idx_and_reordxyz():
    np.testing.assert_array_equal(TIO.ord2idx([2, 1]), JIO.ord2idx([2, 1]))
    anr = ["C", "H", "O", "N", "S"]
    xyz = [[float(i), 0.0, 0.0] for i in range(5)]
    for order in ([3, 2], [2, 4, 3]):
        assert TIO.reordxyz(anr, xyz, order) == JIO.reordxyz(anr, xyz, order)
    with pytest.raises(ValueError, match="length"):
        TIO.reordxyz(anr[:3], xyz, [2, 4, 3, 5, 1, 6])


def _lammps_file(path, style, natoms_header=None):
    rows = [(1, 1, 0.0, 0.0, 0.0), (3, 2, 1.1, 0.0, 0.0),
            (2, 1, 0.0, 1.4, 0.0)]
    n = natoms_header or len(rows)
    lines = ["LAMMPS data file", "", f"{n} atoms", "2 atom types", "",
             "0.0 10.0 xlo xhi", "-1.0 9.0 ylo yhi", "0.0 20.0 zlo zhi",
             "", "Masses", "", "1 12.011", "2 1.008", "",
             f"Atoms # {style}", ""]
    for aid, typ, x, y, z in rows:
        if style == "full":
            lines.append(f"{aid} 1 {typ} 0.0 {x} {y} {z}")
        elif style == "charge":
            lines.append(f"{aid} {typ} 0.0 {x} {y} {z}")
        else:
            lines.append(f"{aid} {typ} {x} {y} {z}")
    lines += ["", "Velocities", "", "1 0 0 0"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("style", ["atomic", "full", "charge"])
def test_read_lammps_data(tmp_path, style):
    path = str(tmp_path / f"{style}.data")
    _lammps_file(path, style)
    got, want = TIO.read_lammps_data(path), JIO.read_lammps_data(path)
    assert got["axyz"] == want["axyz"] and got["els"] == want["els"]
    assert got["els"] == ["C", "C", "H"]
    assert got["axyz"][1][1:] == [0.0, 1.4, 0.0]
    for k in ("cell", "masses", "types"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(np.diag(got["cell"]), [10.0, 10.0, 20.0])


def test_read_lammps_data_count_mismatch(tmp_path):
    path = str(tmp_path / "bad.data")
    _lammps_file(path, "atomic", natoms_header=4)
    for mod in PACKAGES.values():
        with pytest.raises(ValueError, match="header says 4 atoms"):
            mod.read_lammps_data(path)


def test_cutlayers(rng):
    na, nal = 12, 2
    xyz = np.column_stack([rng.normal(size=na), rng.normal(size=na),
                           np.repeat(np.arange(na // nal), nal) * 1.5])
    pbc = np.diag([5.0, 5.0, 30.0])
    kw = dict(anr=[f"a{i}" for i in range(na)], snr=list(range(na)),
              pbc=pbc)
    for order in (None, [3, 2, 4]):
        got = TIO.cutlayers(xyz, nal, 1, 2, ord=order, **kw)
        want = JIO.cutlayers(xyz, nal, 1, 2, ord=order, **kw)
        np.testing.assert_array_equal(got["xyz"], want["xyz"])
        np.testing.assert_array_equal(got["pbc"], want["pbc"])
        assert got["anr"] == want["anr"] and got["snr"] == want["snr"]
    assert TIO.cutlayers(xyz, nal, 1, 1)["anr"] is None
    with pytest.raises(ValueError, match="cutlayers"):
        TIO.cutlayers(xyz, nal, 3, 3)


@pytest.mark.parametrize("dynamic_atoms", [False, True])
def test_read_dynmat(tmp_path, rng, dynamic_atoms):
    nph = 6
    hw = np.abs(rng.random(nph)) + 0.1
    q, _ = np.linalg.qr(rng.normal(size=(nph, nph)))
    arrays = {"hw": hw, "U": q.T}
    if dynamic_atoms:
        # modes over 4 atoms of which atoms 2-3 are dynamic
        full = np.zeros((nph, 4, 3))
        full[:, 1:3] = q.T.reshape(nph, 2, 3)
        arrays = {"hw": hw, "U": full, "DynamicAtoms": np.array([2, 3])}
    path = str(tmp_path / "dyn.npz")
    JIO._write_vars(path, arrays)
    for order in (None, [2, 1]):
        dyn, U2, hw2 = TIO.ReadDynmat(path, order=order)
        jdyn, jU2, _ = JIO.ReadDynmat(path, order=order)
        np.testing.assert_array_equal(dyn, jdyn)
        np.testing.assert_array_equal(U2, jU2)
    dyn, U2, _ = TIO.ReadDynmat(path)
    want = q @ np.diag(hw ** 2) @ q.T
    np.testing.assert_allclose(dyn, want, atol=1e-12)
    with pytest.raises(ValueError, match="order"):
        TIO.ReadDynmat(path, order=[1])


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_lambda_files(tmp_path, rng, writer, reader):
    n = 4
    mats = [rng.normal(size=(n, n)) for _ in range(5)]
    wbp = str(tmp_path / "wb.npz")
    PACKAGES[writer].WritewbLambda(wbp, *mats)
    got = PACKAGES[reader].ReadwbLambda(wbp)
    assert got[0] == 0.0
    for g, m in zip(got[1:], mats):
        np.testing.assert_array_equal(g, m)

    wl = np.linspace(-1.0, 1.0, 9)
    lam = [rng.normal(size=(9, n, n)) for _ in range(3)]
    lp = str(tmp_path / "lam.npz")
    PACKAGES[writer].WriteLambda(lp, wl, np.array([0.3, -0.2]), *lam)
    for w0 in (0.26, -0.7):
        got = PACKAGES[reader].ReadLambda(lp, w0)
        want = JIO.ReadLambda(lp, w0)
        assert got[0] == want[0] == pytest.approx(0.5)
        for g, m in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, m)


def test_wblambda_feeds_the_biased_ebath(tmp_path, rng):
    """One wbLambda bundle, both packages' biased ebath: the same
    (symmetrised) matrices and the same per-frequency noise factors."""
    nc = 5
    a = rng.normal(size=(nc, nc))
    eta = a @ a.T * 1e-3 + np.eye(nc) * 2e-3
    others = [rng.normal(size=(nc, nc)) * 1e-4 for _ in range(4)]
    path = str(tmp_path / "wbLambda.npz")
    TIO.WritewbLambda(path, eta, *others)
    _, e, xim, xip, z1, z2 = TIO.ReadwbLambda(path)
    kw = dict(wmax=1.0, nw=500, bias=0.5, efric=e, exim=xim, exip=xip,
              zeta1=z1, zeta2=z2)
    cats, T, dt, nmd = range(3, 3 + nc), 300.0, 0.38, 64
    tb = TB.ebath(cats, T, dt, nmd, dtype=torch.float64, device="cpu", **kw)
    _, e, xim, xip, z1, z2 = JIO.ReadwbLambda(path)
    jb = JB.ebath(cats, T, dt, nmd, dtype=jnp.float64, **dict(
        kw, efric=e, exim=xim, exip=xip, zeta1=z1, zeta2=z2))
    assert tb.bias_terms and jb.bias_terms
    for k in ("efric", "exim", "exip", "zeta1", "zeta2"):
        want = np.asarray(getattr(jb, k))
        np.testing.assert_allclose(getattr(tb, k).numpy(), want,
                                   rtol=0, atol=1e-12 * np.abs(want).max())
    tstd, jstd = np.asarray(tb.nstd), np.asarray(jb.nstd)
    np.testing.assert_allclose(tstd, jstd, rtol=0,
                               atol=1e-10 * np.abs(jstd).max())
    # the factors themselves are defined up to a phase per eigenvector:
    # compare the PSD they rebuild
    def psd(ev, sd):
        ev = np.asarray(ev)
        return np.einsum("wij,wj,wkj->wik", ev, np.asarray(sd) ** 2,
                         ev.conj())
    want = psd(jb.nevecs, jstd)
    np.testing.assert_allclose(psd(tb.nevecs, tstd), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
