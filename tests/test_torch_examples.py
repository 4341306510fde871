"""The port's examples (``sclmd_tpu_torch.examples``) run in-process at
``--quick --device cpu`` in a temporary directory, and their
deterministic outputs agree with the JAX package's functions on the same
inputs: rundp's stage-1 wbLambda bundle, the transmissions, conductances
and DOS of runnegf/runsig, and current_induced/runnegf's power spectra
(within 1e-10 of the largest magnitude; the decimation at w > 0 only,
since w = 0 is ill-conditioned in the reference itself).
"""

import os

import numpy as np
import pytest
import torch

from sclmd_tpu import negf as JN
from sclmd_tpu import selfenergy as JS
from sclmd_tpu.postprocess import lambda_pipeline as JL

from sclmd_tpu_torch.examples import compareforce, runeam, runmd, runnegf
from sclmd_tpu_torch.examples import runsig
from sclmd_tpu_torch.examples.current_induced import rundp
from sclmd_tpu_torch.examples.current_induced import runnegf as ci_runnegf

QUICK = ["--quick", "--device", "cpu"]
TOL = 1e-10


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    """Each example in its own directory, on one CPU thread: torch's MKL
    batched complex LU hangs at two or four threads on runeam's
    192-wide NEGF sweep (ROADMAP trap "MKL threads"), and another test
    file in the same worker may have set two."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(threads)


def test_rundp(in_tmp):
    out = rundp.main(QUICK)
    # stage 1 against the JAX pipeline's numpy backend, same model
    want = JL.LambdaPipeline(*rundp.model()).wideband(rundp.HWCUT)
    bundle = np.load(in_tmp / "wbLambda.npz")
    assert sorted(bundle.files) == sorted(want)
    for k in want:
        close(bundle[k], want[k])
    # three baths' heat flux from one quick run (dlist 0)
    assert out["heatflux"].shape == (3, 1)
    assert np.isfinite(out["heatflux"]).all()
    assert (in_tmp / "heatflux.300.dat").exists()


def test_current_induced_runnegf(in_tmp):
    out = ci_runnegf.main(QUICK)
    from sclmd_tpu_torch import units as U
    from sclmd_tpu_torch.models.harmonic import chain_dynmat
    n = 30
    d = np.asarray(chain_dynmat(n, 0.04)) / U.RPC ** 2
    b = JN.bpt(d, 0.5, 0.1, [list(range(6)), list(range(n - 6, n))],
               num=400)
    b.gettm()
    assert out["kappa"] == pytest.approx(b.thermalconductance(300.0, 0.1),
                                         rel=TOL)
    close(out["ps_eq"], b.getps(300.0, 0.5, 200))
    nb = 6
    b.setbias(0.6, bdamp=np.eye(nb) * 0.05, chiplus=np.eye(nb) * 0.02,
              chiminus=np.zeros((nb, nb)), dofatomofbias=range(12, 18))
    close(out["ps_bias"], b.getps(300.0, 0.5, 200, atomlist=range(12, 18)))
    assert (in_tmp / "powerspectrum.biascenter.300.0.dat").exists()


def test_runnegf(in_tmp):
    out = runnegf.main(QUICK)
    b = JN.bpt(out["dynmat_ps2"], 0.25, 0.1, out["atomofbath"],
               out["atomfixed"], num=500)
    close(out["tm"], b.gettm())
    for temp, kappa in out["kappa"].items():
        assert kappa == pytest.approx(b.thermalconductance(temp, 0.1),
                                      rel=TOL)
    close(out["ps"], b.getps(300.0, 0.25, 200))
    assert (in_tmp / "transmission.dat").exists()


def test_runsig(in_tmp):
    out = runsig.main(QUICK)
    s = JS.sig(out["dynmat_ps2"], 0.12, out["g0"], out["g1"], num=400,
               eta=0.164e-3)
    s.getse("L")
    s.getse("R")
    s.gettm()
    close(out["dos"][1:], s.dos[1:])
    close(out["tm"][1:], s.tmnumber[1:])


def test_runmd(in_tmp):
    out = runmd.main(QUICK)
    assert set(out) == {"conductance", "flux"}
    assert np.isfinite(out["conductance"]).all()
    assert len(os.listdir(in_tmp)) > 4
    assert (in_tmp / "heatflux.300.dat").exists()


def test_compareforce(in_tmp):
    out = compareforce.main(QUICK)
    assert np.isfinite(out["deviation"]).all()
    assert (in_tmp / "deltaforce-mean1.dat").exists()


def test_runeam(in_tmp):
    out = runeam.main(QUICK)
    assert np.isfinite(out["conductance"]).all()
    assert out["negf"] > 0.0


def test_dynmat_twice_on_a_float32_driver():
    """A float32 driver's float64 Hessian twice (runeam takes it for the
    runner and again for the NEGF): the constants cached by the first
    call's transform must not break the second."""
    from sclmd_tpu_torch.models.eam import (EAMDriver, SUTTON_CHEN_PARAMS,
                                            fcc_cell)
    a0 = SUTTON_CHEN_PARAMS["Cu"]["a"]
    pos, _ = fcc_cell(1, 1, 2, a0)
    drv = EAMDriver([["Cu"] + list(p) for p in pos], rcut=0.9 * a0,
                    dtype=torch.float32, device="cpu")
    first = drv.dynmat()
    np.testing.assert_array_equal(drv.dynmat().numpy(), first.numpy())


def test_examples_parse_the_common_options():
    from sclmd_tpu_torch.examples import parse_args
    a = parse_args(["--quick", "--device", "cpu", "--data", "x.data",
                    "--ensemble", "8"], "doc", data=True, ensemble=True)
    assert (a.quick, a.device, a.data, a.ensemble) == (True, "cpu",
                                                       "x.data", 8)
    assert parse_args([], "doc").device is None
    with pytest.raises(SystemExit):
        parse_args(["--data", "x"], "doc")
