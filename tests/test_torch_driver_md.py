"""The port's integrator and runner with a force driver against the JAX
package, on the CPU in float64.

``run_segment`` with a C/H driver's ``force_fn`` takes the same injected
noise and initial state as ``sclmd_tpu.md.run_segment``; both evaluate
the same step in float64 and differ in summation order, amplified over
the run: rtol 1e-9, atol 1e-12. ``RunEnsemble`` draws from the port's own
generators, so runner tests hold the port against itself (chunking, the
harmonic driver against ``dyn``) and check the files it writes.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu import md as JMD
from sclmd_tpu.models import hydrocarbon as JH

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.convert import (from_jax_bath, from_jax_driver,
                                     from_jax_system)
from sclmd_tpu_torch.models import hydrocarbon as TH
from sclmd_tpu_torch.models.harmonic import HarmonicDriver, chain_dynmat
from sclmd_tpu_torch.models.tersoff import graphene_ribbon

torch.set_num_threads(2)

RTOL, ATOL = 1e-9, 1e-12
DT, NMD = 0.4, 48


def junction():
    """A small hydrogen-terminated ribbon: 12 C and 8 H."""
    return TH.terminate_with_h(
        [["C", *row] for row in graphene_ribbon(3, 2)])


def benzene():
    axyz = []
    for r, el in ((1.40, "C"), (2.49, "H")):
        for k in range(6):
            th = np.pi / 3 * k
            axyz.append([el, r * np.cos(th), r * np.sin(th), 0.0])
    return axyz


def _jax_baths(nph):
    eta = np.eye(6) / 80.0
    return [JB.ebath(cats, tb, DT, NMD, wmax=1.0, efric=eta,
                     dtype=jnp.float64, factorize=False)
            for cats, tb in ((range(6), 330.0), (range(nph - 6, nph), 270.0))]


@pytest.mark.parametrize("compare", [False, True],
                         ids=["force_fn", "force_fn_and_cf"])
def test_run_segment_with_driver_matches_jax(compare):
    """Two electron baths, constrained DOFs, the C/H force as force_fn
    (and, for ``cf``, as the compared driver beside the Hessian's force)."""
    axyz = junction()
    jd = JH.CHDriver(axyz)
    td = from_jax_driver(jd, device="cpu")
    nph = 3 * len(axyz)
    dyn = np.asarray(jd.dynmat())
    mask = np.ones(nph)
    mask[[6, 7, 8]] = 0.0
    jsys = JMD.GLESystem(
        dyn=jnp.asarray(dyn), baths=tuple(_jax_baths(nph)),
        mask=jnp.asarray(mask), dt=DT, nph=nph, ml=1, nmd=NMD,
        force_fn=jd.force_jax, savep=True, savef=True,
        cf_fn=jd.force_jax if compare else None)
    rng = np.random.default_rng(20)
    ntraj, nsteps = 2, 40
    noises = [0.02 * rng.standard_normal((ntraj, NMD, 6)) for _ in range(2)]
    p0 = 0.05 * rng.standard_normal((ntraj, nph)) * mask
    q0 = 0.05 * rng.standard_normal((ntraj, nph)) * mask

    tsys = from_jax_system(jsys, device="cpu", driver=td,
                           cf_driver=td if compare else None)
    tsys = tsys.replace(baths=tuple(
        b.replace(noise=torch.as_tensor(n))
        for b, n in zip(tsys.baths, noises)))
    assert not TMD.blocked_supports(tsys)
    st = TMD.initial_state(tsys, ntraj).replace(p=torch.as_tensor(p0),
                                                q=torch.as_tensor(q0))
    tfin, tys = TMD.run_segment(tsys, st, nsteps)
    for k in range(ntraj):
        sk = jsys.replace(baths=tuple(
            b.replace(noise=jnp.asarray(n[k]))
            for b, n in zip(jsys.baths, noises)))
        js = JMD.initial_state(sk, dtype=jnp.float64).replace(
            p=jnp.asarray(p0[k]), q=jnp.asarray(q0[k]))
        jfin, jys = JMD.run_segment(sk, js, nsteps)
        for name in ("p", "q"):
            np.testing.assert_allclose(getattr(tfin, name)[k].numpy(),
                                       np.asarray(getattr(jfin, name)),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        for name, v in jys.items():
            if v is not None:
                np.testing.assert_allclose(tys[name][k].numpy(),
                                           np.asarray(v), rtol=RTOL,
                                           atol=ATOL, err_msg=name)
        assert set(tys) == {n for n, v in jys.items() if v is not None}
    assert ("cf" in tys) == compare


def test_from_jax_system_needs_the_driver():
    axyz = benzene()
    jd = JH.CHDriver(axyz)
    jsys = JMD.GLESystem(dyn=None, baths=(), mask=jnp.ones(36), dt=DT,
                         nph=36, ml=1, nmd=NMD, force_fn=jd.force_jax)
    with pytest.raises(ValueError, match="driver"):
        from_jax_system(jsys, device="cpu")
    tsys = from_jax_system(jsys, device="cpu",
                           driver=from_jax_driver(jd, device="cpu"))
    assert tsys.dyn is None and tsys.force_fn is not None


def _ch_runner(outdir, axyz=None, nmd=64, seed=3, **kw):
    axyz = axyz or benzene()
    drv = TH.CHDriver(axyz, device="cpu")
    n = 3 * len(axyz)
    r = TMD.md(DT, nmd, 300.0, axyz=axyz, dyn=drv.dynmat().numpy(), nstop=1,
               dtype=torch.float64, outdir=str(outdir), device="cpu",
               seed=seed, **kw)
    r.AddPotential(drv)
    eta = np.eye(6) / 80.0
    for cats, tb in ((range(6), 330.0), (range(n - 6, n), 270.0)):
        r.AddBath(TB.ebath(cats, tb, DT, nmd, wmax=1.0, efric=eta,
                           dtype=torch.float64, device="cpu"))
    return r, drv


def test_ch_ensemble_runs(tmp_path):
    """CHDriver + RunEnsemble: the flagship's combination, small."""
    r, drv = _ch_runner(tmp_path)
    system = r._build_system()
    assert system.force_fn is not None and not TMD.blocked_supports(system)
    means = r.RunEnsemble(3)
    assert means.shape == (3, 2) and np.isfinite(means).all()
    names = set(os.listdir(tmp_path))
    assert {f"kappa.300.bath{i}.run{j}.dat" for i in (0, 1)
            for j in range(3)} <= names


def test_ensemble_with_driver_takes_the_plain_step(tmp_path, monkeypatch):
    """A block that divides the run does not send a driver system to the
    blocked integrator."""
    r, _ = _ch_runner(tmp_path, block=16)
    called = []
    monkeypatch.setattr(TMD, "run_segment_blocked",
                        lambda *a, **k: called.append(1))
    means = r.RunEnsemble(2, block=16)
    assert not called and np.isfinite(means).all()


def test_chunk_invariance_with_driver(tmp_path):
    means = {}
    for chunk in (5, 2, 1):
        d = tmp_path / f"c{chunk}"
        d.mkdir()
        means[chunk] = _ch_runner(d)[0].RunEnsemble(5, chunk=chunk)
    # the autograd twin sums a batch's energies before the backward pass,
    # so a chunk's gradients are each member's own to rounding
    np.testing.assert_allclose(means[2], means[5], rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(means[1], means[5], rtol=1e-9, atol=1e-15)


def test_auto_chunk_counts_nothing_for_a_driver(tmp_path):
    from sclmd_tpu_torch.parallel.ensemble import (auto_chunk,
                                                   estimate_traj_bytes)
    r, _ = _ch_runner(tmp_path)
    with_driver = r._build_system()
    without = with_driver.replace(force_fn=None)
    assert estimate_traj_bytes(with_driver, 64) == \
        estimate_traj_bytes(without, 64)
    assert auto_chunk(with_driver, 1000, 64, None, budget_bytes=10 ** 6) == \
        auto_chunk(without, 1000, 64, None, budget_bytes=10 ** 6)


def test_run_with_driver_and_compare_force(tmp_path):
    """``Run`` with AddPotential and CompareForce: the deltaforce file is
    (driver force + dyn q) / conv at every step's start."""
    r, drv = _ch_runner(tmp_path, nmd=32)
    r.CompareForce(drv)
    r.Saveq()
    r.Run()
    names = set(os.listdir(tmp_path))
    assert {"MD0.npz", "deltaforce.run0.npy", "kappa.300.bath0.run0.dat",
            "kappa.300.bath1.run0.dat"} <= names
    ck = np.load(tmp_path / "MD0.npz")
    df = np.load(tmp_path / "deltaforce.run0.npy")
    assert df.shape == (32, 36) and "cf" not in ck
    qs = torch.as_tensor(ck["qs"])
    want = (drv.force_torch(qs) + qs @ r.dyn.T).numpy() / drv.conv
    np.testing.assert_allclose(df, want, rtol=1e-9, atol=1e-12)
    # anharmonic remainder: small against the force itself
    assert np.abs(df).max() < np.abs(drv.force_torch(qs).numpy()
                                     / drv.conv).max()


def test_harmonic_driver_through_add_potential(tmp_path):
    """``HarmonicDriver`` as the potential gives the ``dyn`` run: the
    same draws, -dyn q by another product (rounding only)."""
    nph = 12
    dyn = chain_dynmat(nph, 0.05).numpy()
    axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(4)]
    means = []
    for use_driver in (False, True):
        d = tmp_path / str(use_driver)
        d.mkdir()
        r = TMD.md(DT, 64, 300.0, axyz=axyz, dyn=dyn, dtype=torch.float64,
                   outdir=str(d), device="cpu", seed=5)
        if use_driver:
            r.AddPotential(HarmonicDriver(dyn, axyz, dtype=torch.float64,
                                          device="cpu"))
        eta = np.eye(3) / 80.0
        for cats, tb in ((range(3), 330.0), (range(9, 12), 270.0)):
            r.AddBath(TB.ebath(cats, tb, DT, 64, wmax=1.0, efric=eta,
                               dtype=torch.float64, device="cpu"))
        means.append(r.RunEnsemble(3))
    np.testing.assert_allclose(means[1], means[0], rtol=1e-10, atol=1e-16)


def test_callable_force_is_picked_when_no_force_torch(tmp_path):
    class Plain:
        def force(self, q):
            return -0.05 * q

    r = TMD.md(DT, 16, 300.0, axyz=[["C", 0.0, 0.0, 0.0]],
               dtype=torch.float64, outdir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="no driver, no md"):
        r._build_system()
    r.AddPotential(Plain())
    system = r._build_system()
    q = torch.ones((2, 3), dtype=torch.float64)
    assert torch.equal(system.potential_force(q), -0.05 * q)
    # without dyn the start is the zero state, as in the JAX runner
    assert not r.initialise(system).p.any()


def test_set_syslist(tmp_path):
    axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(4)]
    r = TMD.md(DT, 16, 300.0, axyz=axyz, dtype=torch.float64,
               outdir=str(tmp_path), device="cpu")
    assert r.nph == 12
    r.SetSyslist([1, 2])
    assert (r.na, r.nph) == (2, 6) and list(r.syslist) == [1, 2]
    j = JMD.md(DT, 16, 300.0, axyz=axyz, outdir=str(tmp_path))
    j.SetSyslist([1, 2])
    assert (j.na, j.nph) == (r.na, r.nph)
    with pytest.raises(ValueError, match="larger than total"):
        r.SetSyslist(range(5))
