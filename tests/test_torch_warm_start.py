"""The port's periodic warm start and antithetic estimator against the JAX
package (CPU float64): the one-step Jacobian, the periodic point through
the port's own integrator, the steady-state mode temperatures and
``RunEnsemble(steady_init=True)``, and ``antithetic_run`` against the
draw-independent exact attractor currents."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu import md as JMD
from sclmd_tpu.models.harmonic import chain_dynmat

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.convert import from_jax_system
from sclmd_tpu_torch.parallel import ensemble as TE

torch.set_num_threads(2)

NAT, DT = 4, 0.4
NPH = 3 * NAT
ETA = np.eye(3) / 30.0


def _jax_system(nmd=128, key=jax.random.PRNGKey(0)):
    """TestPeriodicWarmStart's chain: two electron baths at 330 / 270 K,
    the first DOF fixed, noise drawn by JAX."""
    dyn = np.asarray(chain_dynmat(NPH, 0.05))
    ks = jax.random.split(key, 2)
    baths = [JB.ebath(cats, T, DT, nmd, wmax=1.0, efric=ETA,
                      dtype=jnp.float64).gnoi(k).replace(nevecs=None,
                                                         nstd=None)
             for cats, T, k in ((range(3), 330.0, ks[0]),
                                (range(9, 12), 270.0, ks[1]))]
    mask = np.ones(NPH)
    mask[:1] = 0.0
    return JMD.GLESystem(dyn=jnp.asarray(dyn), baths=tuple(baths),
                         mask=jnp.asarray(mask), dt=DT, nph=NPH, ml=1,
                         nmd=nmd)


def _port_system(jsys):
    """The same system in the port, each bath with its (1, nmd, nc) noise."""
    s = from_jax_system(jsys, device="cpu")
    return s.replace(baths=tuple(
        b.replace(noise=torch.as_tensor(np.array(jb.noise))[None])
        for b, jb in zip(s.baths, jsys.baths)))


def test_jacobian_matches_jax():
    jsys = _jax_system()
    A = TMD.gle_step_jacobian(_port_system(jsys))
    want = JMD.gle_step_jacobian(jsys)
    assert A.shape == want.shape == (4 * NPH, 4 * NPH)
    np.testing.assert_allclose(A, want, rtol=0, atol=1e-10)


def test_jacobian_matches_integrator():
    """A x equals one zero-noise step of the port's integrator from x."""
    system = _port_system(_jax_system())
    A = TMD.gle_step_jacobian(system)
    x = np.random.default_rng(5).normal(size=A.shape[0])
    zsys = system.replace(baths=tuple(
        b.replace(noise=torch.zeros_like(b.noise)) for b in system.baths))
    new, _ = TMD.run_segment(zsys, TMD.state_unravel(x, system), 1)
    np.testing.assert_allclose(TMD.state_ravel(new)[0], A @ x, rtol=1e-10,
                               atol=1e-12)


def test_state_ravel_round_trip_and_order():
    """[p, q, phis, qhis], as the JAX package ravels a state."""
    jsys = _jax_system()
    system = _port_system(jsys)
    x = np.random.default_rng(2).normal(size=(3, 4 * NPH))
    st = TMD.state_unravel(x, system)
    np.testing.assert_array_equal(TMD.state_ravel(st), x)
    jst = JMD.state_unravel(x, jsys, dtype=jnp.float64)
    for k in ("p", "q", "phis", "qhis"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jst, k)))


def test_fixed_point_is_periodic():
    """One noise period from the attractor point returns to it, through
    the port's integrator."""
    system = _port_system(_jax_system())
    nmd = system.nmd
    fin1, _ = TMD.run_segment(system, TMD.initial_state(system, 1), nmd)
    A = TMD.gle_step_jacobian(system)
    x0 = TMD.periodic_fixed_point(A, TMD.state_ravel(fin1)[0], nmd)
    fin2, _ = TMD.run_segment(system, TMD.state_unravel(x0, system), nmd)
    np.testing.assert_allclose(TMD.state_ravel(fin2)[0], x0, rtol=0,
                               atol=1e-9 * np.abs(x0).max())


@pytest.mark.parametrize("device", [None, "cpu"])
def test_batched_fixed_point_and_solver(device):
    """Batched solves equal single ones and the solver's; the
    pseudo-inverse solve equals the JAX package's least-squares solve;
    the period power is the JAX package's."""
    jsys = _jax_system()
    A = TMD.gle_step_jacobian(_port_system(jsys))
    P = TMD.period_power(A, jsys.nmd, device=device)
    np.testing.assert_allclose(P, JMD.period_power(A, jsys.nmd), rtol=1e-9,
                               atol=1e-12)
    x1 = np.random.default_rng(7).normal(size=(3, A.shape[0]))
    xb = TMD.periodic_fixed_point(A, x1, jsys.nmd, power=P)
    solve = TMD.fixed_point_solver(P)
    for i in range(3):
        xi = TMD.periodic_fixed_point(A, x1[i], jsys.nmd)
        np.testing.assert_allclose(xb[i], xi, rtol=1e-12)
        np.testing.assert_allclose(solve(x1[i]), xi, rtol=1e-8,
                                   atol=1e-10 * np.abs(xi).max())
    np.testing.assert_allclose(solve(x1), xb, rtol=1e-8,
                               atol=1e-10 * np.abs(xb).max())
    np.testing.assert_allclose(
        xb, JMD.periodic_fixed_point(A, x1, jsys.nmd), rtol=1e-12)


def _runners(outdir, temps=(330.0, 270.0), pkg="torch", seed=3, nmd=128):
    dyn = np.asarray(chain_dynmat(NPH, 0.05))
    axyz = [["C", 1.0 * i, 0.0, 0.0] for i in range(NAT)]
    if pkg == "torch":
        r = TMD.md(DT, nmd, 300.0, axyz=axyz, dyn=dyn, dtype=torch.float64,
                   seed=seed, outdir=str(outdir), device="cpu")
        mk = lambda cats, T: TB.ebath(cats, T, DT, nmd, wmax=1.0, efric=ETA,
                                      dtype=torch.float64, device="cpu")
    else:
        r = JMD.md(DT, nmd, 300.0, axyz=axyz, dyn=dyn, dtype=jnp.float64,
                   seed=seed, outdir=str(outdir))
        mk = lambda cats, T: JB.ebath(cats, T, DT, nmd, wmax=1.0, efric=ETA,
                                      dtype=jnp.float64)
    for cats, T in zip((range(3), range(9, 12)), temps):
        r.AddBath(mk(cats, T))
    return r


def test_steady_mode_temps_match_jax(tmp_path):
    rt = _runners(tmp_path / "t")
    rj = _runners(tmp_path / "j", pkg="jax")
    got = TMD.steady_mode_temps(rt.U, rt.baths, rt.T, hw=rt.hw)
    want = JMD.steady_mode_temps(np.asarray(rj.U), rj.baths, rj.T,
                                 hw=np.asarray(rj.hw))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got.min() < 300.0 < got.max()
    eq = _runners(tmp_path / "e", temps=(300.0, 300.0))
    assert np.array_equal(TMD.steady_mode_temps(eq.U, eq.baths, eq.T),
                          np.full(NPH, 300.0))


def test_steady_init_equal_temps_matches_uniform(tmp_path):
    """Equal bath temperatures: the steady start is bitwise the uniform
    one (same seed, same draws)."""
    for d in ("u", "s"):
        (tmp_path / d).mkdir()
    temps = (300.0, 300.0)
    m_uniform = _runners(tmp_path / "u", temps).RunEnsemble(3)
    m_steady = _runners(tmp_path / "s", temps).RunEnsemble(
        3, steady_init=True)
    np.testing.assert_array_equal(m_steady, m_uniform)


def test_steady_init_starts_at_mode_temps(tmp_path, monkeypatch):
    """Unequal temperatures: the thermal start receives the JAX package's
    per-mode temperatures."""
    seen = []
    real = TMD.md._thermal_start

    def spy(self, T):
        seen.append(np.asarray(T))
        return real(self, T)

    monkeypatch.setattr(TMD.md, "_thermal_start", spy)
    r = _runners(tmp_path)
    means = r.RunEnsemble(2, steady_init=True)
    assert np.isfinite(means).all()
    rj = _runners(tmp_path, pkg="jax")
    want = JMD.steady_mode_temps(np.asarray(rj.U), rj.baths, rj.T,
                                 hw=np.asarray(rj.hw))
    np.testing.assert_allclose(seen[-1], want, rtol=1e-12)


def test_antithetic_warm_start_matches_exact_attractor(tmp_path):
    """The warm-started antithetic mean lies within 3.5 standard errors
    of the exact attractor current (``attractor_expected_currents``,
    which depends on no draw)."""
    from sclmd_tpu.ops.exact_gle import attractor_expected_currents
    nmd, ntraj = 64, 48
    TL, TR = 330.0, 270.0

    def build(Ta, Tb):
        return _runners(tmp_path, temps=(Ta, Tb), nmd=nmd)

    j = TE.antithetic_run(build, TL, TR, ntraj, seed=5, chunk=20)
    assert j.shape == (ntraj,) and np.isfinite(j).all()
    exact = []
    for temps in ((TL, TR), (TR, TL)):
        rj = _runners(tmp_path, temps=temps, pkg="jax", nmd=nmd)
        sysj = rj._build_system().replace(baths=tuple(rj.baths))
        c = attractor_expected_currents(sysj, method="dense")
        exact.append((c[0] - c[1]) / 2)
    j_exact = (exact[0] - exact[1]) / 2
    sem = j.std() / np.sqrt(ntraj)
    assert abs(j.mean() - j_exact) <= 3.5 * sem, (j.mean(), j_exact, sem)
    # chunking changes the solver's rounding only
    j2 = TE.antithetic_run(build, TL, TR, ntraj, seed=5, chunk=ntraj)
    np.testing.assert_allclose(j2, j, rtol=1e-6, atol=1e-9 * abs(j).max())


def test_antithetic_cold_path_and_checks(tmp_path):
    def build(Ta, Tb):
        return _runners(tmp_path, temps=(Ta, Tb), nmd=64)

    j = TE.antithetic_run(build, 330.0, 270.0, 4, warm_start=False)
    assert j.shape == (4,) and np.isfinite(j).all()
    with pytest.raises(ValueError, match="nsteps == nmd"):
        TE.antithetic_run(build, 330.0, 270.0, 4, nsteps=32)
    with pytest.raises(ValueError, match="out of range"):
        TE.antithetic_run(build, 330.0, 270.0, 4, pair=(0, 2))
