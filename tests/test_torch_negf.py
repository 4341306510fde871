"""Parity of the port's NEGF stack (``sclmd_tpu_torch.negf``,
``sclmd_tpu_torch.selfenergy``) and the lead-block phonon bath with the
JAX package, on the CPU in float64.

Both packages take the same numpy inputs. Tolerances: T(w), Sigma(w), G
and power spectra within 1e-10 of the largest magnitude of the compared
quantity; currents and conductances within 1e-10 relative; decimation
counts exact for each frequency. The classes mirror tests/test_negf.py
(its sharded class aside: a mesh raises in the port).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu import negf as JN
from sclmd_tpu import selfenergy as JS
from sclmd_tpu import units as U

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import negf as TN
from sclmd_tpu_torch import selfenergy as TS

torch.set_num_threads(2)

TOL = 1e-10
CPU = "cpu"


def close(got, want, tol=TOL):
    """max |got - want| <= tol * max |want| (complex compared as is)."""
    got = np.asarray(TS.host(got))
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def rel(got, want, tol=TOL):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * abs(want), (got, want)


def chain(n, k=0.1, grounded=False):
    """Dynamical matrix of a free 1-D chain (eV^2); ``grounded`` adds the
    bulk onsite at both ends."""
    d = np.zeros((n, n))
    for i in range(n - 1):
        d[i, i] += k
        d[i + 1, i + 1] += k
        d[i, i + 1] -= k
        d[i + 1, i] -= k
    if grounded:
        d[0, 0] += k
        d[-1, -1] += k
    return d


def chain_blocks(k=0.1, n=1):
    """Principal-layer blocks of a 1D chain with n sites/layer, spring k."""
    K00 = np.zeros((n, n))
    for i in range(n):
        K00[i, i] = 2 * k
        if i + 1 < n:
            K00[i, i + 1] = -k
            K00[i + 1, i] = -k
    K01 = np.zeros((n, n))
    K01[-1, 0] = -k
    return K00, K01


def jax_sgf_batch(ws, e, s, alpha, eta):
    """The JAX package's decimation over a grid: vmapped while_loop."""
    return jax.vmap(lambda w: JS.surface_gf(w, jnp.asarray(e),
                                            jnp.asarray(s),
                                            jnp.asarray(alpha), eta=eta))(
        jnp.asarray(ws))


def both_bpt(d_ev2, bath, **kw):
    args = (d_ev2 / U.RPC ** 2, 0.7, 20.0, bath)
    return JN.bpt(*args, **kw), TN.bpt(*args, device=CPU, **kw)


def biased_pair(n=8):
    pair = both_bpt(chain(n), [[0], [n - 1]], num=5)
    nb = 2
    for b in pair:
        b.setbias(0.05, bdamp=np.eye(nb) * 0.02,
                  chiplus=np.eye(nb) * 0.01, chiminus=np.eye(nb) * 0.005,
                  dofatomofbias=[3, 4])
    return pair


# ---------------------------------------------------------------------------
class TestSurfaceGF:
    @pytest.mark.parametrize("n,eta", [(1, 1e-4), (2, 1e-4), (3, 1e-3)])
    def test_grid_matches_jax(self, n, eta):
        """One batched port call over a grid in and out of the band
        against the JAX package's vmapped while_loop: G, niter and the
        flag for each frequency."""
        K00, K01 = chain_blocks(0.1, n)
        ws = np.array([0.0, 0.05, 0.3, 0.55, 0.62, 1.0])
        gj, itj, cj = jax_sgf_batch(ws, K00, K00, K01, eta)
        gt, itt, ct = TS.surface_gf(ws, K00, K00, K01, eta=eta, device=CPU)
        close(gt, np.asarray(gj))
        np.testing.assert_array_equal(itt.numpy(), np.asarray(itj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))

    @pytest.mark.parametrize("omega", [0.05, 0.3, 0.55])
    def test_matches_brute_force_chain(self, omega):
        from tests.test_negf import brute_surface_gf
        k, eta = 0.1, 1e-4
        K00, K01 = chain_blocks(k)
        g, niter, conv = TS.surface_gf(omega, K00, K00, K01, eta=eta,
                                       device=CPU)
        assert g.shape == (1, 1) and niter.ndim == 0 and bool(conv)
        np.testing.assert_allclose(complex(g[0, 0]),
                                   brute_surface_gf(omega, k, eta), rtol=2e-3)

    def test_frozen_carry(self):
        """A grid mixing frequencies that converge in a few iterations
        (outside the band) with slow ones (at the band edge): each
        frequency's niter is JAX's, and its G has the bits it has in a
        batch of the same size where every entry is that frequency (a
        frequency that kept iterating after converging would not)."""
        K00, K01 = chain_blocks(0.1, 2)
        ws = np.array([2.0, 0.6, 1.5, 0.3, 0.631, 3.0])
        eta = 1e-5
        g, it, conv = TS.surface_gf(ws, K00, K00, K01, eta=eta, device=CPU)
        _, itj, _ = jax_sgf_batch(ws, K00, K00, K01, eta)
        np.testing.assert_array_equal(it.numpy(), np.asarray(itj))
        assert len(set(it.tolist())) >= 3, it
        assert bool(conv.all())
        for i, w in enumerate(ws):
            gi, iti, _ = TS.surface_gf(np.full(len(ws), w), K00, K00, K01,
                                       eta=eta, device=CPU)
            assert int(iti[0]) == int(it[i])
            assert torch.equal(gi[0], g[i]), (w, int(it[i]))

    def test_not_converged_reports(self):
        """A cap below what a frequency needs: converged False, niter at
        the cap, as the JAX package reports it."""
        K00, K01 = chain_blocks(0.1)
        ws = np.array([0.3, 2.0])
        _, it, conv = TS.surface_gf(ws, K00, K00, K01, eta=1e-6, max_iter=3,
                                    device=CPU)
        _, itj, cj = jax.vmap(lambda w: JS.surface_gf(
            w, jnp.asarray(K00), jnp.asarray(K00), jnp.asarray(K01),
            eta=1e-6, max_iter=3))(jnp.asarray(ws))
        np.testing.assert_array_equal(it.numpy(), np.asarray(itj))
        np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
        assert not bool(conv[0])

    def test_lead_selfenergy_from_blocks(self):
        k = 0.1
        K00, K01 = chain_blocks(k, 2)
        V01 = np.array([[-k, 0.0], [0.0, -0.5 * k]])
        wl = np.array([0.0, 0.1, 0.3, 0.5, 0.9])
        want = np.asarray(JS.lead_selfenergy_from_blocks(K00, K01, V01, wl,
                                                         eta=1e-4))
        got = TS.lead_selfenergy_from_blocks(K00, K01, V01, wl, eta=1e-4,
                                             device=CPU)
        close(got, want)
        se_np = TS.lead_selfenergy_from_blocks_np(K00, K01, V01, wl,
                                                  eta=1e-4)
        np.testing.assert_array_equal(
            se_np, JS.lead_selfenergy_from_blocks_np(K00, K01, V01, wl,
                                                     eta=1e-4))
        close(se_np, want)

    @pytest.mark.parametrize("omega", [0.1, 0.3, 0.55])
    def test_surface_gf_np(self, omega):
        """The host twin against the JAX package's twin (the same bits)
        and its device function."""
        K00 = np.array([[0.2]])
        K01 = np.array([[-0.1]])
        g_n = TS.surface_gf_np(omega, K00, K00, K01)
        np.testing.assert_array_equal(g_n,
                                      JS.surface_gf_np(omega, K00, K00, K01))
        g_j, _, _ = JS.surface_gf(jnp.asarray(omega), jnp.asarray(K00),
                                  jnp.asarray(K00), jnp.asarray(K01))
        np.testing.assert_allclose(g_n, np.asarray(g_j), rtol=1e-8)


# ---------------------------------------------------------------------------
def both_sig(num=40, eta=1e-3, **kw):
    d = chain(16, 0.1, grounded=True) / U.RPC ** 2
    args = (d, 0.9 * 2 * np.sqrt(0.1), list(range(8, 10)),
            list(range(10, 12)))
    return (JS.sig(*args, num=num, eta=eta, **kw),
            TS.sig(*args, num=num, eta=eta, device=CPU, **kw))


class TestSigClass:
    def test_transmission(self):
        js, ts = both_sig()
        tj, tt = js.gettm(), ts.gettm()
        np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
        close(tt[:, 1], tj[:, 1])
        band = (tt[:, 0] * U.RPC > 0.15) & (tt[:, 0] * U.RPC
                                            < 2 * np.sqrt(0.1) * 0.85)
        assert np.allclose(tt[band, 1], 1.0, atol=0.08)

    @pytest.mark.parametrize("direction", ["L", "R"])
    def test_getse_dos_and_niter(self, direction):
        js, ts = both_sig(num=30)
        close(ts.getse(direction), js.getse(direction))
        close(ts.dos, js.dos)
        assert (ts.dos[:, 1] > -1e-8).all() and ts.dos[:, 1].max() > 0
        s, e, alpha = js._blocks(direction)
        _, itj, _ = jax_sgf_batch(js.ep, e, s, alpha, js.eta)
        np.testing.assert_array_equal(ts.niter[direction], np.asarray(itj))

    @pytest.mark.parametrize("direction", ["L", "R"])
    def test_per_omega(self, direction):
        js, ts = both_sig()
        w = 0.3 / U.RPC
        close(ts.sgf(w, direction), np.asarray(js.sgf(w, direction)))
        close(ts.selfenergy(w, direction),
              np.asarray(js.selfenergy(w, direction)))
        close(ts.retargf(w), np.asarray(js.retargf(w)))
        rel(ts.tm(w), js.tm(w))
        pi = ts.selfenergy(w, direction)
        close(ts.gamma(pi), np.asarray(js.gamma(jnp.asarray(pi.numpy()))))

    def test_bad_direction_raises(self):
        _, ts = both_sig(num=4)
        with pytest.raises(ValueError, match="direction"):
            ts.selfenergy(0.1, "X")
        with pytest.raises(ValueError, match="direction"):
            ts.getse("X")

    def test_not_converged_raises(self):
        _, ts = both_sig(num=4, eta=0.0)
        with pytest.raises(ValueError, match="increase eta"):
            ts.getse("L")

    def test_from_file_and_written_files(self, tmp_path, monkeypatch):
        """A dynmat.dat-style file in, the JAX package's files out."""
        d = chain(18, 0.1, grounded=True) / U.RPC ** 2
        np.savetxt(tmp_path / "dyn.dat", d.reshape(-1, 3))
        monkeypatch.chdir(tmp_path)
        ts = TS.sig(None, 0.6, range(8, 10), range(10, 12),
                    dynmatfile=str(tmp_path / "dyn.dat"), num=10, eta=1e-3,
                    write_files=True, device=CPU)
        ts.getse("L")
        ts.gettm()
        for f in ("omegas.dat", "eigvecs.dat", "falsefrequencies.dat",
                  "densityofstates_L.dat", "transmission.dat"):
            assert (tmp_path / f).is_file(), f
        js = JS.sig(d, 0.6, range(8, 10), range(10, 12), num=10, eta=1e-3)
        js.gettm()
        close(np.loadtxt(tmp_path / "transmission.dat")[:, 1],
              js.tmnumber[:, 1])

    def test_from_driver(self):
        """A port driver's float64 Hessian (a CPU tensor, eV^2) as input:
        the graphene strip of examples/runsig.py, two principal layers of
        four atoms, against the JAX package on the same matrix. At w = 0
        (w + i eta)^2 = -eta^2 is real and the strip's layer block is
        indefinite: the decimation there is ill-conditioned in the
        reference itself (its device function and its numpy twin differ
        by 41 %), so the bar holds at w > 0 and w = 0 is held finite."""
        from sclmd_tpu_torch.models.tersoff import (TersoffDriver,
                                                    graphene_ribbon)
        x = graphene_ribbon(8, 2)
        drv = TersoffDriver([["C", *row] for row in x], dtype=torch.float64,
                            device=CPU)
        lay = 3 * (drv.number // 4)
        g0 = list(range(lay, lay + 12))
        g1 = list(range(lay + 12, lay + 24))
        ts = TS.sig(drv, 0.12, g0, g1, num=24, eta=0.164e-3, device=CPU)
        js = JS.sig(drv.dynmat().numpy() / U.RPC ** 2, 0.12, g0, g1, num=24,
                    eta=0.164e-3)
        np.testing.assert_array_equal(ts.K01, js.K01)
        for direction in ("L", "R"):
            se = ts.getse(direction)
            close(se[1:], js.getse(direction)[1:])
            assert np.isfinite(se[0]).all()
            s, e, alpha = js._blocks(direction)
            _, itj, _ = jax_sgf_batch(js.ep, e, s, alpha, js.eta)
            np.testing.assert_array_equal(ts.niter[direction][1:],
                                          np.asarray(itj)[1:])
        close(ts.gettm()[1:, 1], js.gettm()[1:, 1])


# ---------------------------------------------------------------------------
class TestBPT:
    @pytest.mark.parametrize("n,bath,fixed", [
        (10, [[0, 1], [8, 9]], ([], [])),
        (12, [[1, 2], [9, 10]], ([0], [11])),
        (12, [[2, 3], [8, 9]], ([0, 1], [10, 11])),
    ])
    def test_tm_matches_jax(self, n, bath, fixed):
        """The Caroli sweep, w = 0 included (a free chain's singular
        matrix there: 0, no raise), with and without fixed DOFs."""
        jb, tb = both_bpt(chain(n), bath, dofatomfixed=fixed, num=25)
        assert tb.nd == jb.nd
        tj, tt = jb.gettm(), tb.gettm()
        np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
        assert tt[0, 1] == tj[0, 1] == 0.0
        close(tt[:, 1], tj[:, 1])
        rel(tb.tm(0.3 / U.RPC), jb.tm(0.3 / U.RPC))

    def test_singular_at_zero(self):
        """w = 0 of a free chain: the solves take a singular matrix, and
        T, the power spectrum and the lead current come back 0 there."""
        jb, tb = both_bpt(chain(10), [[0, 1], [8, 9]], num=10)
        assert tb.tm(0.0) == 0.0
        ps = tb._ps_batch(np.array([0.0, 0.1]), 300.0, range(10))
        assert float(ps[0]) == 0.0 and np.isfinite(ps.numpy()).all()
        g = tb.retargf(0.0)
        assert g.shape == (10, 10)

    def test_batch_sizes_same_bits(self):
        """Chunking is free: batch sizes 1, 7 and 32 give the same bits."""
        outs = []
        for bs in (1, 7, 32):
            _, tb = both_bpt(chain(10), [[0, 1], [8, 9]], num=37,
                             batch_size=bs)
            outs.append((tb.gettm().copy(), tb.getps(300.0, 0.6, 13).copy()))
        for tm, ps in outs[1:]:
            np.testing.assert_array_equal(tm, outs[0][0])
            np.testing.assert_array_equal(ps, outs[0][1])

    def test_thermal_current_and_conductance(self):
        jb, tb = both_bpt(chain(10), [[0, 1], [8, 9]], num=200)
        jb.gettm()
        tb.gettm()
        T, delta = 300.0, 0.1
        for fn, args in (("thermalcurrent", (T, delta)),
                         ("thermalcurrent", (T, 0.05)),
                         ("thermalconductance", (T, delta)),
                         ("thermalconductivity", (T, delta, 20.0, 4.0))):
            rel(getattr(tb, fn)(*args), getattr(jb, fn)(*args))
        w_ev = tb.tmnumber[:, 0] * U.RPC
        TL, TR = T * (1 + delta / 2), T * (1 - delta / 2)
        j_t = TN.landauer_current_natural(w_ev, tb.tmnumber[:, 1], TL, TR)
        j_j = JN.landauer_current_natural(w_ev, jb.tmnumber[:, 1], TL, TR)
        assert j_t.dtype == torch.float64
        rel(j_t, j_j)
        # bpt's eV*ps Landauer integral == natural units * CURCOF
        np.testing.assert_allclose(float(j_t) * U.CURCOF,
                                   tb.thermalcurrent(T, delta), rtol=1e-3)
        assert tb.thermalconductivity(300.0, 0.1, L=20.0, A=4.0) == \
            pytest.approx(tb.thermalconductance(300.0, 0.1) * 20.0 / 4.0 * 10)

    @pytest.mark.parametrize("omegalist", [None, [0.05, 0.01, 0.3]])
    def test_equilibrium_power_spectrum(self, omegalist):
        jb, tb = both_bpt(chain(6), [[0], [5]], num=10)
        pj = jb.getps(300.0, 0.6, 20, omegalist=omegalist)
        pt = tb.getps(300.0, 0.6, 20, omegalist=omegalist)
        np.testing.assert_array_equal(pt[:, 0], pj[:, 0])
        close(pt[:, 1], pj[:, 1])
        assert (pt[1:, 1] > -1e-10).all()
        rel(tb.ps(0.2 / U.RPC, 300.0, [1, 2]), jb.ps(0.2 / U.RPC, 300.0,
                                                     [1, 2]))

    @pytest.mark.parametrize("chiminus", [0.0, 0.005])
    def test_bias_power_spectrum(self, chiminus):
        jb, tb = both_bpt(chain(6), [[0], [5]], num=10)
        nb = 2
        for b in (jb, tb):
            b.setbias(0.05, bdamp=np.eye(nb) * 0.02,
                      chiplus=np.eye(nb) * 0.01,
                      chiminus=np.eye(nb) * chiminus, dofatomofbias=[2, 3])
        pj, pt = jb.getps(300.0, 0.6, 15), tb.getps(300.0, 0.6, 15)
        assert np.isfinite(pt[:, 1]).all()
        close(pt[:, 1], pj[:, 1])
        pj = jb.getps(300.0, 0.6, 15, atomlist=[1, 2, 4])
        pt = tb.getps(300.0, 0.6, 15, atomlist=[1, 2, 4])
        close(pt[:, 1], pj[:, 1])

    def test_bias_parameters_checked(self):
        _, tb = both_bpt(chain(6), [[0], [5]], num=4)
        with pytest.raises(ValueError, match="Bias parameters"):
            tb.setbias(0.05, bdamp=np.eye(2), chiplus=np.eye(2),
                       chiminus=np.eye(2), dofatomofbias=[2])

    def test_bath_overlapping_fixed_raises(self):
        tb = TN.bpt(chain(6) / U.RPC ** 2, 0.7, 20.0, [[0], [5]],
                    dofatomfixed=([0], []), num=4, device=CPU)
        with pytest.raises(ValueError, match="overlap fixed"):
            tb.gettm()

    def test_from_file(self, tmp_path):
        d = chain(6) / U.RPC ** 2
        np.savetxt(tmp_path / "dyn.dat", d.reshape(-1, 3))
        tb = TN.bpt(None, 0.7, 20.0, [[0], [5]], num=8, device=CPU,
                    dynmatfile=str(tmp_path / "dyn.dat"))
        jb = JN.bpt(d, 0.7, 20.0, [[0], [5]], num=8)
        close(tb.gettm()[:, 1], jb.gettm()[:, 1])

    @pytest.mark.parametrize("name", ["gettm", "getps", "getse"])
    def test_mesh_raises(self, name):
        _, tb = both_bpt(chain(6), [[0], [5]], num=4)
        _, ts = both_sig(num=4)
        call = {"gettm": lambda: tb.gettm(mesh=object()),
                "getps": lambda: tb.getps(300.0, 0.6, 5, mesh=object()),
                "getse": lambda: ts.getse("L", mesh=object())}[name]
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            call()

    def test_advangf_is_dagger_of_retargf(self):
        jb, tb = both_bpt(chain(6), [[0], [5]], num=5)
        w = 0.3 / U.RPC
        gr, ga = tb.retargf(w), tb.advangf(w)
        np.testing.assert_allclose(ga.numpy(), gr.numpy().conj().T,
                                   rtol=1e-10)
        close(gr, np.asarray(jb.retargf(w)))
        close(ga, np.asarray(jb.advangf(w)))
        close(tb.gamma(gr), np.asarray(jb.gamma(jnp.asarray(gr.numpy()))))

    def test_from_driver_object(self):
        """bpt from a port driver (``.dynmat()`` a CPU tensor in eV^2,
        symbols in ``.els``): masses and positions flow through; an
        SW-silicon slab's transmission against the JAX package on the
        same matrix, masses and positions."""
        from sclmd_tpu_torch.models.sw import SWDriver, diamond_cell
        pos, cell = diamond_cell(1, 1, 2)
        axyz = [["Si"] + list(p) for p in pos]
        drv = SWDriver(axyz, cell=cell, dtype=torch.float64, device=CPU)
        n = 3 * len(axyz)
        bath = [list(range(6)), list(range(n - 6, n))]
        tb = TN.bpt(drv, 0.09, 1.0, bath, num=12, device=CPU)
        assert tb.els is not None and len(tb.els) == n
        np.testing.assert_array_equal(
            tb.els, np.repeat([U.AtomicMassTable["Si"]] * len(axyz), 3))
        np.testing.assert_array_equal(tb.xyz, drv.xyz)
        jb = JN.bpt(drv.dynmat().numpy() / U.RPC ** 2, 0.09, 1.0, bath,
                    num=12, els=tb.els, xyz=tb.xyz)
        tm = tb.gettm()
        assert tm.shape == (13, 2)
        assert np.isfinite(tm).all() and (tm[:, 1] > -1e-10).all()
        assert tm[:, 1].max() > 0.05
        close(tm[:, 1], jb.gettm()[:, 1])
        assert tb.thermalconductance(300.0, 0.1) > 0
        rel(tb.thermalconductance(300.0, 0.1),
            jb.thermalconductance(300.0, 0.1))


# ---------------------------------------------------------------------------
class TestLesserGreater:
    def test_meir_wingreen_equals_landauer(self):
        jb, tb = both_bpt(chain(10), [[0, 1], [8, 9]], num=400)
        T, delta = 300.0, 0.2
        TL, TR = T * (1 + delta / 2), T * (1 - delta / 2)
        ws = np.linspace(0, tb.maxomega, tb.intnum + 1)[1:]
        tm = tb._tm_batch(ws).numpy()
        close(tm, np.asarray(jb._tm_batch(jnp.asarray(ws))))
        occ = (tb.bosedist(ws, TL) - tb.bosedist(ws, TR)).numpy()
        j_landauer = float(np.trapezoid(
            tb.rpc * ws / (2 * np.pi) * tm * occ, ws)) * 1.60217662e2
        j_l = tb.leadthermalcurrent(TL, TR, lead="L")
        j_r = tb.leadthermalcurrent(TL, TR, lead="R")
        rel(j_l, jb.leadthermalcurrent(TL, TR, lead="L"))
        rel(j_r, jb.leadthermalcurrent(TL, TR, lead="R"))
        np.testing.assert_allclose(j_l, j_landauer, rtol=1e-8)
        np.testing.assert_allclose(j_r, -j_l, rtol=1e-6)

    def test_equilibrium_current_vanishes(self):
        jb, tb = both_bpt(chain(8), [[0], [7]], num=100)
        j = tb.leadthermalcurrent(300.0, 300.0, lead="L")
        assert abs(j) < 1e-10
        assert abs(j - jb.leadthermalcurrent(300.0, 300.0, lead="L")) < 1e-12

    @pytest.mark.parametrize("T", [0.0, 1e-40, 300.0])
    def test_bosedist_guards(self, T):
        """The overflow guards: T ~ 0, w = 0 (the int32 ceiling), and a
        tiny w/T, against the JAX package."""
        jb, tb = both_bpt(chain(4), [[0], [3]], num=4)
        w = np.array([0.0, 1e-35, 1e-3, 0.2, 5.0])
        got, want = tb.bosedist(w, T).numpy(), np.asarray(jb.bosedist(w, T))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)


# ---------------------------------------------------------------------------
class TestWriteVSim:
    def test_same_file_as_jax(self, tmp_path):
        k, damp = 0.1, 20.0
        nat = 3
        n = 3 * nat
        els = np.repeat([12.011] * nat, 3)
        xyz = np.arange(n, dtype=float)
        kw = dict(num=5, els=els, xyz=xyz, boxlo=[0.0, 0.0, 0.0],
                  boxhi=[10.0, 11.0, 12.0])
        d = chain(n, k) / U.RPC ** 2
        JN.bpt(d, 0.7, damp, [[0], [n - 1]], **kw).write_v_sim(
            str(tmp_path / "jax.ascii"))
        TN.bpt(d, 0.7, damp, [[0], [n - 1]], device=CPU, **kw).write_v_sim(
            str(tmp_path / "torch.ascii"))
        text = (tmp_path / "torch.ascii").read_text()
        assert text == (tmp_path / "jax.ascii").read_text()
        lines = text.splitlines()
        assert lines[0] == "# Generated file for v_sim 3.7"
        assert lines[3].split()[-1] == "C"
        assert len([ln for ln in lines if ln.startswith("#metaData")]) == n

    def test_missing_metadata_raises(self):
        tb = TN.bpt(np.eye(6) * 0.1 / U.RPC ** 2, 0.7, 20.0, [[0], [5]],
                    num=5, device=CPU)
        with pytest.raises(ValueError, match="write_v_sim"):
            tb.write_v_sim("nowhere.ascii")


# ---------------------------------------------------------------------------
class TestReferenceSelfEnergyMethods:
    @pytest.mark.parametrize("name", [
        "retarselfenergy", "advanselfenergy", "kselfenergy",
        "lessselfenergy", "greatselfenergy", "lessgf", "greatgf",
        "retarbiasselfenergy", "advanbiasselfenergy", "kbiasselfenergy",
        "lessbiasselfenergy", "greatbiasselfenergy", "lessbiasgf",
        "greatbiasgf"])
    def test_matches_jax(self, name):
        jb, tb = biased_pair()
        w, T = 0.3 / U.RPC, 300.0
        bias = "bias" in name
        dof = tb.dofatomofbias if bias else tb.dofatomofbath[0]
        args = (w, dof) if name.endswith(("retarselfenergy",
                                          "advanselfenergy")) or \
            name in ("retarbiasselfenergy", "advanbiasselfenergy") \
            else (w, T, dof)
        close(getattr(tb, name)(*args), np.asarray(getattr(jb, name)(*args)))

    def test_totalk_and_internals(self):
        jb, tb = biased_pair()
        w, T = 0.3 / U.RPC, 300.0
        close(tb.totalkselfenergy(w, T), jb.totalkselfenergy(w, T))
        ws = np.array([0.0, w, 2 * w])
        close(tb._bias_block(torch.as_tensor(ws)),
              np.asarray(jb._bias_block(jnp.asarray(ws))))
        dt, bt = tb.totalkselfenergy_diag_parts(ws, T)
        dj, bj = jb.totalkselfenergy_diag_parts(jnp.asarray(ws), T)
        close(dt, np.asarray(dj))
        close(bt, np.asarray(bj))
        sel = np.asarray(tb._bathsel(tb.dofatomofbias))
        se = tb.retarbiasselfenergy(w, tb.dofatomofbias)
        np.testing.assert_allclose(
            se[np.ix_(sel, sel)],
            tb._bias_block(torch.tensor([w], dtype=torch.float64))[0]
            .numpy(), rtol=1e-12)

    def test_unbiased_returns_zero(self):
        _, tb = both_bpt(np.eye(6) * 0.1, [[0], [5]], num=5)
        assert tb.retarbiasselfenergy(0.1, []) == 0
        assert tb.kbiasselfenergy(0.1, 300.0, []) == 0
        assert tb.advanbiasselfenergy(0.1, []) == 0
        assert tb.lessbiasgf(0.1, 300.0, [1, 2]).shape == (2, 2)
        assert tb.totalkselfenergy_diag_parts([0.1], 300.0)[1] is None

    def test_biasthermalcurrent(self):
        _, b0 = both_bpt(chain(8), [[0], [7]], num=40)
        assert b0.biasthermalcurrent(300.0, [3, 4]) == 0.0
        jb, tb = biased_pair()
        rel(tb.biasthermalcurrent(300.0, tb.dofatomofbias, num=40),
            jb.biasthermalcurrent(300.0, jb.dofatomofbias, num=40))
        tb.bias = 0.0
        tb.biasgamma = tb.biasgamma * 0.0
        tb.chiminus = tb.chiminus * 0.0
        assert abs(tb.biasthermalcurrent(300.0, tb.dofatomofbias,
                                         num=40)) < 1e-12


# ---------------------------------------------------------------------------
def _lead_bath_pair(T=300.0, cats=(0,), classical=False):
    k = 0.04
    K00, K01, V01 = np.array([[2 * k]]), np.array([[-k]]), np.array([[-k]])
    kw = dict(T=T, cats=list(cats), debye=np.sqrt(k), nw=400,
              dt=0.25 / 0.658, nmd=256, ml=32, K00=K00, K01=K01, V01=V01,
              mcof=2.2, classical=classical, nwse=120)
    return (JB.phbath(dtype=jnp.float64, **kw),
            TB.phbath(dtype=torch.float64, device=CPU, **kw))


class TestLeadBlockBath:
    @pytest.mark.parametrize("classical", [False, True])
    def test_phbath_lead_blocks_match_jax(self, classical):
        """The K00/K01/V01 mode: the decimated Sigma on nwse points, the
        Gamma table, the kernel and the noise factors (as the PSD they
        rebuild) against the JAX package's bath."""
        jb, tb = _lead_bath_pair(classical=classical)
        assert tb.mode == jb.mode == "K"
        assert tb.gwl.shape == (120,)
        np.testing.assert_array_equal(tb.gwl, np.asarray(jb.gwl))
        close(tb.gamma, np.asarray(jb.gamma))
        close(tb.kernel, np.asarray(jb.kernel))
        rec = [np.einsum("wij,wj,wkj->wik", np.asarray(b.nevecs),
                         np.asarray(b.nstd) ** 2,
                         np.asarray(b.nevecs).conj()) for b in (tb, jb)]
        close(rec[0], rec[1])

    def test_lead_blocks_wide_system(self):
        """Two system DOFs on a two-site lead layer."""
        k = 0.04
        K00, K01 = chain_blocks(k, 2)
        V01 = np.array([[-k, 0.0], [0.0, -0.3 * k]])
        kw = dict(T=250.0, cats=[3, 4], debye=0.2, nw=64, dt=0.4, nmd=128,
                  ml=16, K00=K00, K01=K01, V01=V01, nwse=50)
        jb = JB.phbath(dtype=jnp.float64, **kw)
        tb = TB.phbath(dtype=torch.float64, device=CPU, **kw)
        close(tb.gamma, np.asarray(jb.gamma))
        close(tb.kernel, np.asarray(jb.kernel))

    @pytest.mark.parametrize("mode", ["gamma", "sig", "debye", "K"])
    def test_mode_predicates(self, mode):
        """UseG/UsePi/UseK report the build mode, as the JAX package's."""
        gwl = np.linspace(0.0, 0.6, 8)
        kw = dict(T=300.0, cats=[0, 1], debye=0.3, nw=16, dt=0.4, nmd=64,
                  ml=9)
        if mode == "gamma":
            kw.update(gamma=np.array([np.eye(2) * 0.02] * 8), gwl=gwl)
        elif mode == "sig":
            kw.update(sig=-1j * gwl[:, None, None] * np.eye(2) * 0.02,
                      gwl=gwl)
        elif mode == "K":
            K00, K01 = chain_blocks(0.04, 2)
            kw.update(K00=K00, K01=K01, V01=-0.04 * np.eye(2), nwse=40)
        jb = JB.phbath(dtype=jnp.float64, **kw)
        tb = TB.phbath(dtype=torch.float64, device=CPU, **kw)
        assert tb.mode == jb.mode
        for pred in ("UseG", "UsePi", "UseK"):
            assert getattr(tb, pred)() == getattr(jb, pred)(), pred
        want = {"gamma": (True, False, False), "sig": (True, True, False),
                "debye": (True, False, False), "K": (True, True, True)}
        assert (tb.UseG(), tb.UsePi(), tb.UseK()) == want[mode]
