"""Parity of the port's HSSigma extraction
(``sclmd_tpu_torch.postprocess.hssigma``, complex128 torch on the CPU)
with the JAX package's (jax on the CPU in float64): ``kaverage_extract``
within 1e-10 of the largest magnitude of each output, the readers on npz
bundles equal, and the file-to-file ``hssigma_main`` workflow giving the
same bundle (within 1e-10) and the same transmission table.
"""

import os

import numpy as np
import pytest

from sclmd_tpu.postprocess import hssigma as JH

from sclmd_tpu_torch.postprocess import hssigma as TH

TOL = 1e-10
CPU = "cpu"


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale


def _model(rng, n=5, nk=3, ne=6):
    E = np.linspace(-1.0, 1.0, ne)
    ks = np.linspace(0, np.pi, nk, endpoint=False)
    wk = np.full(nk, 1.0 / nk)
    h0 = rng.normal(size=(n, n))
    h0 = (h0 + h0.T) / 2
    t = rng.normal(size=(n, n)) * 0.2
    Hk = np.array([h0 + np.cos(k) * (t + t.T) / 2 + 1j * np.sin(k)
                   * (t - t.T) / 2 for k in ks])
    Sk = np.broadcast_to(np.eye(n, dtype=complex), (nk, n, n)).copy()
    SigLk = np.zeros((ne, nk, n, n), complex)
    SigRk = np.zeros((ne, nk, n, n), complex)
    SigLk[:, :, 0, 0] = -0.3j * (1 + 0.1 * rng.random((ne, nk)))
    SigRk[:, :, -1, -1] = -0.3j * (1 + 0.1 * rng.random((ne, nk)))
    SigLk[:, :, 0, 1] = SigLk[:, :, 1, 0] = 0.05 * rng.normal(size=(ne, nk))
    return E, wk, Hk, Sk, SigLk, SigRk


@pytest.mark.parametrize("n,nk,ne", [(5, 3, 6), (8, 4, 40), (6, 1, 33)])
def test_kaverage_extract_against_jax(rng, n, nk, ne):
    E, wk, Hk, Sk, SL, SR = _model(rng, n=n, nk=nk, ne=ne)
    want = JH.kaverage_extract(Hk, Sk, SL, SR, E, wk, eta=1e-3)
    got = TH.kaverage_extract(Hk, Sk, SL, SR, E, wk, eta=1e-3, device=CPU)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])


def test_kaverage_does_not_depend_on_batch_size(rng):
    E, wk, Hk, Sk, SL, SR = _model(rng, n=6, nk=3, ne=70)
    ref = TH.kaverage_extract(Hk, Sk, SL, SR, E, wk, batch_size=1,
                              device=CPU)
    for bs in (5, 64, 70):
        got = TH.kaverage_extract(Hk, Sk, SL, SR, E, wk, batch_size=bs,
                                  device=CPU)
        for k in ref:
            close(got[k], ref[k], 1e-12)


def test_expand_pivoted_sigma(rng):
    sfe = rng.normal(size=(3, 2, 2)) + 1j * rng.normal(size=(3, 2, 2))
    np.testing.assert_array_equal(TH.expand_pivoted_sigma(sfe, [3, 1], 5),
                                  JH.expand_pivoted_sigma(sfe, [3, 1], 5))


def _write_run(rng, tmp_path, runname="Dev"):
    """A tbtrans-like run as npz bundles: 4 atoms x 2 orbitals, atoms 2-3
    the device (tests/test_hssigma.py's layout)."""
    nk, ne, norb, na = 2, 3, 2, 4
    lasto = np.arange(1, na + 1) * norb
    n_full = na * norb
    npv = 2
    sig = rng.normal(size=(nk, ne, npv, npv)) * 0.05
    sigi = -np.abs(rng.normal(size=(nk, ne, npv, npv))) * 0.05
    kpts = np.zeros((nk, 3))
    kpts[1, 0] = 0.5
    np.savez(tmp_path / f"{runname}.TBT.SE.npz",
             Left_pivot=np.array([3, 4]), Right_pivot=np.array([5, 6]),
             Left_ReSelfEnergy=sig, Left_ImSelfEnergy=sigi,
             Right_ReSelfEnergy=sig[::-1], Right_ImSelfEnergy=sigi,
             lasto=lasto, a_dev=np.array([2, 3]), kpt=kpts,
             wkpt=np.full(nk, 0.5), E=np.linspace(-0.05, 0.05, ne))
    h0 = rng.normal(size=(n_full, n_full))
    h0 = (h0 + h0.T) / 2
    Hk = np.stack([h0 + 0.1 * ik * np.eye(n_full)
                   for ik in range(nk)]).astype(complex)
    Sk = np.broadcast_to(np.eye(n_full, dtype=complex),
                         (nk, n_full, n_full)).copy()
    np.savez(tmp_path / f"{runname}.HSk.npz", Hk=Hk, Sk=Sk)
    return runname


def test_readers_on_npz_bundles(rng, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    runname = _write_run(rng, tmp_path)
    got = TH.read_tbt_se(runname + ".TBT.SE.nc")
    want = JH.read_tbt_se(runname + ".TBT.SE.nc")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["iod1"], got["iod2"]) == (2, 6)
    for a, b in zip(TH.read_device_hs(runname, got["kpts"], 2, 6),
                    JH.read_device_hs(runname, got["kpts"], 2, 6)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        TH.read_tbt_se("Missing.TBT.SE.nc")
    with pytest.raises(FileNotFoundError):
        TH.read_device_hs("Missing", got["kpts"], 0, 2)


def test_hssigma_main_end_to_end(rng, tmp_path, monkeypatch):
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
        _write_run(np.random.default_rng(5), tmp_path / d)
    monkeypatch.chdir(tmp_path / "port")
    got = TH.hssigma_main("Dev", eta=1e-3, device=CPU)
    monkeypatch.chdir(tmp_path / "jax")
    want = JH.hssigma_main("Dev", eta=1e-3)
    for k in want:
        close(got[k], want[k])
    assert got["SigmaL"].shape[-2:] == (4, 4)
    bt = np.load(tmp_path / "port" / "Dev.HSSigmaMEAN.npz")
    bj = np.load(tmp_path / "jax" / "Dev.HSSigmaMEAN.npz")
    assert sorted(bt.files) == sorted(bj.files)
    for k in bj.files:
        close(bt[k], bj[k])
    tt = np.loadtxt(tmp_path / "port" / "Trans.realspace.dat")
    tj = np.loadtxt(tmp_path / "jax" / "Trans.realspace.dat")
    close(tt, tj, 1e-8)          # the table's %.8e
    path = str(tmp_path / "port" / "Dev.HSSigmaMEAN.npz")
    for a, b in zip(TH.read_hssigma_mean(path), JH.read_hssigma_mean(path)):
        np.testing.assert_array_equal(a, b)


def test_write_hssigma_mean_same_bundle(rng, tmp_path):
    E, wk, Hk, Sk, SL, SR = _model(rng)
    res = TH.kaverage_extract(Hk, Sk, SL, SR, E, wk, device=CPU)
    kpts = np.zeros((3, 3))
    TH.write_hssigma_mean(str(tmp_path / "t.npz"), E, res, kpts=kpts)
    JH.write_hssigma_mean(str(tmp_path / "j.npz"), E, res, kpts=kpts)
    a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_read_xv(tmp_path):
    text = ("  10.0 0.0 0.0\n  0.0 10.0 0.0\n  0.0 0.0 10.0\n"
            "  2\n"
            "  1  6  0.0 0.0 0.0  0.0 0.0 0.0\n"
            "  2  1  2.0 0.5 0.0  0.0 0.0 0.0\n")
    (tmp_path / "Dev.XV").write_text(text)
    got, want = TH.read_xv(str(tmp_path / "Dev.XV")), \
        JH.read_xv(str(tmp_path / "Dev.XV"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
