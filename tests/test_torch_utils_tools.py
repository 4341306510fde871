"""The port's post-processing tools (``sclmd_tpu_torch.utils.tools``) on
the port's own outputs, against the JAX package's tools on the same
files: equal arrays and byte-equal output files.

The kappa files come from the port's ``RunEnsemble`` on the CPU (a small
chain, three electron baths, six trajectories); the .ani frames and the
deltaforce records from its ``md.Run`` with ``SaveTraj`` and
``CompareForce``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from sclmd_tpu.utils import tools as JT

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.md import md
from sclmd_tpu_torch.models.harmonic import chain_dynmat
from sclmd_tpu_torch.utils import tools as TT

NTRAJ, NMD, T = 6, 64, 300.0


def _chain_runner(outdir, na=6):
    nph = 3 * na
    dyn = np.asarray(chain_dynmat(nph, 0.04))
    axyz = [["C", 1.4 * i, 0.0, 0.0] for i in range(na)]
    r = md(0.5, NMD, T, axyz=axyz, dyn=dyn, dtype=torch.float64,
           outdir=outdir, device="cpu", nstop=2, seed=5)
    eta = np.eye(3) * 0.01
    for cats, tt in (((0, 1, 2), T * 1.05), ((nph - 3, nph - 2, nph - 1),
                                              T * 0.95), ((6, 7, 8), T)):
        r.AddBath(TB.ebath(cats, tt, r.dt, NMD, wmax=1.0, nw=200,
                           efric=eta, dtype=torch.float64, device="cpu"))
    return r


@pytest.fixture(scope="module")
def kappa_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kappa")
    means = _chain_runner(str(d)).RunEnsemble(NTRAJ, nsteps=NMD)
    return str(d), means


def _copy(src, dst):
    os.makedirs(dst)
    for f in os.listdir(src):
        if f.startswith("kappa."):
            shutil.copy(os.path.join(src, f), dst)
    return dst


def _same_files(a, b, names):
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_kappa_table_reads_the_run(kappa_dir):
    d, means = kappa_dir
    temp, kb = TT._read_kappa_table(d, bathnum=3)
    jtemp, jkb = JT._read_kappa_table(d, bathnum=3)
    assert temp == jtemp == T
    np.testing.assert_array_equal(kb, jkb)
    assert kb.shape == (3, NTRAJ)
    # the files hold the means in nW to the printed %f precision
    np.testing.assert_allclose(kb, means.T * U.CURCOF, rtol=0, atol=5e-7)


@pytest.mark.parametrize("bathnum,dlist", [(2, 1), (3, 0), (3, 2)])
def test_calhf_same_as_jax(kappa_dir, tmp_path, bathnum, dlist):
    d, _ = kappa_dir
    a = _copy(d, str(tmp_path / "port"))
    b = _copy(d, str(tmp_path / "jax"))
    got = TT.calHF(dlist=dlist, bathnum=bathnum, workdir=a)
    want = JT.calHF(dlist=dlist, bathnum=bathnum, workdir=b)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (bathnum, NTRAJ - dlist)
    _same_files(a, b, ["heatflux.300.dat"])


@pytest.mark.parametrize("bathnum,L,A", [(2, None, None), (3, None, None),
                                         (2, 12.0, 4.0), (3, 12.0, 4.0)])
def test_caltc_same_as_jax(kappa_dir, tmp_path, bathnum, L, A):
    d, means = kappa_dir
    a = _copy(d, str(tmp_path / "port"))
    b = _copy(d, str(tmp_path / "jax"))
    got = TT.calTC(0.1, dlist=1, bathnum=bathnum, L=L, A=A, workdir=a)
    want = JT.calTC(0.1, dlist=1, bathnum=bathnum, L=L, A=A, workdir=b)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    names = ["thermalconductance.300.dat", "heatflux-between-baths.300.dat"]
    if L is not None:
        names.append("thermalconductivity.300.dat")
    _same_files(a, b, names)
    # against the run's own currents (nW), to the files' precision
    j = means[1:] * U.CURCOF
    flux = (j[:, 0] - j[:, 1]) / 2 if bathnum == 2 \
        else -(j[:, 0] + j[:, 1] - j[:, 2]) / 4
    assert got["flux"][0] == pytest.approx(flux.mean(), abs=1e-6)


def test_kappa_reader_errors(kappa_dir, tmp_path):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for mod in (TT, JT):
        with pytest.raises(FileNotFoundError, match="bath0.run0"):
            mod.calHF(workdir=empty)
    d, _ = kappa_dir
    part = _copy(d, str(tmp_path / "part"))
    os.remove(os.path.join(part, "kappa.300.bath2.run3.dat"))
    msgs = []
    for mod in (TT, JT):
        with pytest.raises(FileNotFoundError) as e:
            mod.calTC(0.1, bathnum=3, workdir=part)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[0].endswith("bath2.run3.dat")
    for mod in (TT, JT):     # a fourth bath: no files, raised first
        with pytest.raises(FileNotFoundError, match="bath3.run0"):
            mod.calTC(0.1, bathnum=4, workdir=d)


def test_kappa_reader_takes_the_first_match_in_listing_order(tmp_path):
    """Two names that the pattern kappa.300*.bath1.run0.dat matches: the
    one-listing reader picks the glob reader's file; bath01 matches no
    pattern."""
    for name, v in (("kappa.300.bath0.run0.dat", 1.0),
                    ("kappa.3000.bath1.run0.dat", 7.0),
                    ("kappa.300.bath1.run0.dat", -1.0),
                    ("kappa.300.bath01.run0.dat", 9.0)):
        (tmp_path / name).write_text(f"0 300.0    {v} \n")
    got = TT._read_kappa_table(str(tmp_path), 2)
    want = JT._read_kappa_table(str(tmp_path), 2)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """md.Run of a 4-atom Morse chain with SaveTraj and CompareForce."""
    from sclmd_tpu_torch.models.pair import PairDriver

    d = str(tmp_path_factory.mktemp("traj"))
    axyz = [["C", 1.5 * i, 0.0, 0.0] for i in range(4)]
    drv = PairDriver(axyz, kind="morse",
                     params=dict(D=2.0, alpha=1.8, r0=1.5), cutoff=4.0,
                     dtype=torch.float64, device="cpu")
    r = md(0.5, NMD, T, axyz=axyz, dyn=np.asarray(drv.dynmat()),
           dtype=torch.float64, outdir=d, device="cpu", nstop=2, seed=3)
    r.AddPotential(drv)
    r.AddBath(TB.ebath(range(12), T, r.dt, NMD, wmax=1.0, nw=200,
                       efric=np.eye(12) * 0.01, dtype=torch.float64,
                       device="cpu"))
    r.SaveTraj(8)
    r.CompareForce(drv)
    r.Run()
    return d, axyz


def test_trajectory_tools_same_as_jax(run_dir, tmp_path):
    d, axyz = run_dir
    files = sorted(f for f in os.listdir(d) if f.endswith(".ani"))
    assert files == ["trajectories.300.run0.ani", "trajectories.300.run1.ani"]
    got, want = TT.read_ani(os.path.join(d, files[0])), \
        JT.read_ani(os.path.join(d, files[0]))
    assert got[0] == want[0] == ["C"] * 4
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].shape == (NMD // 8, 4, 3) and got[2] is not None
    np.testing.assert_allclose(got[1][0], [a[1:] for a in axyz], atol=0.5)

    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    for w in (a, b):
        os.makedirs(w)
        for f in files:
            shutil.copy(os.path.join(d, f), w)
    np.testing.assert_array_equal(TT.dumpavetraj(files, workdir=a),
                                  JT.dumpavetraj(files, workdir=b))
    ref = np.array([x[1:] for x in axyz])
    for g, w in zip(TT.dumpdisp(ref, files, index=(1, 2), workdir=a),
                    JT.dumpdisp(ref, files, index=(1, 2), workdir=b)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        TT.dumpke(0.5, files, [12.0], workdir=a),
        JT.dumpke(0.5, files, [12.0], workdir=b))
    _same_files(a, b, ["avestructure.dat", "dispstructure.1.dat",
                       "dispstructure.2.dat", "kineticenergy.dat",
                       "kineticenergyaverage.dat"])


def test_avdf_on_compareforce_records(run_dir, tmp_path):
    d, _ = run_dir
    recs = ["deltaforce.run0.npy", "deltaforce.run1.npy"]
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    for w in (a, b):
        os.makedirs(w)
        for f in recs:
            shutil.copy(os.path.join(d, f), w)
    for use_abs in (False, True):
        TT.avdf(recs, use_abs=use_abs, workdir=a)
        JT.avdf(recs, use_abs=use_abs, workdir=b)
        _same_files(a, b, [f"deltaforce-{k}{i}.dat" for k in
                           ("mean", "deviation") for i in (0, 1)])
    rec = np.load(os.path.join(d, recs[0]))
    assert rec.shape[0] == NMD and np.isfinite(rec).all()


def test_eff_same_as_jax(tmp_path, rng):
    n = 6
    a = rng.normal(size=(n, n))
    d = (a + a.T) / 2      # indefinite
    for w in ("port", "jax"):
        os.makedirs(tmp_path / w)
        np.savetxt(tmp_path / w / "dynmat.dat", d)
    got = TT.eff("dynmat.dat", workdir=str(tmp_path / "port"))
    want = JT.eff("dynmat.dat", workdir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(got, want)
    assert (np.linalg.eigvalsh(got) >= -1e-10).all()
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"),
                ["moddynmat.dat"])


def test_reexports_and_gates(tmp_path):
    assert TT.get_atomname(12.011) == "C"
    assert TT.get_atommass("Au") == pytest.approx(JT.get_atommass("Au"))
    try:
        import dpdata  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="dpdata"):
            TT.predeepmd("x", "vasp/outcar")
    pytest.importorskip("matplotlib")
    (tmp_path / "lcurve.out").write_text(
        "step loss_e loss_f\n0 1.0 2.0\n10 0.5 1.0\n")
    assert os.path.exists(TT.visualtrain("lcurve.out",
                                         workdir=str(tmp_path)))
