"""Parity of the port's plain GLE step with the JAX package.

The same junction, the same injected noise and the same initial state
go through ``sclmd_tpu.md.run_segment`` (one trajectory at a time, or
``jax.vmap``) and ``sclmd_tpu_torch.md.run_segment`` (the batch at once,
through the plain twins of kernels K6 and K7 on the CPU), in float64.

Tolerance rtol 1e-9, atol 1e-12: both sides compute the same terms in
float64 but sum them in another order (XLA's dots against torch's
batched matmuls), so they agree to float64 rounding amplified over the
run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu import md as JMD
from sclmd_tpu.models.harmonic import chain_dynmat as j_chain_dynmat

from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.convert import from_jax_bath, from_jax_system
from sclmd_tpu_torch.kernels import bath_force as K7
from sclmd_tpu_torch.kernels import conv_tails as K6

torch.set_num_threads(2)

RTOL, ATOL = 1e-9, 1e-12
DT = 0.4
GWL = np.linspace(0.0, 0.6, 16)


def _mats(nc, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(nc, nc)) * 0.05
    return (a @ a.T + 0.02 * np.eye(nc),
            *(0.02 * rng.normal(size=(nc, nc)) for _ in range(3)))


def _bath(kind, cats, nmd, ml=None, T=300.0, seed=0):
    """A JAX bath of ``kind``: "phonon" (memory kernel of ``ml`` taps),
    "local" (Debye, ml 1), "electron" or "biased" (electron bath with
    exim, zeta1 and zeta2 at a bias)."""
    nc = len(cats)
    if kind == "phonon":
        gam = np.array([np.eye(nc) * 0.02 * np.exp(-(w / 0.3) ** 2)
                        for w in GWL])
        return JB.phbath(T, cats, 0.3, 32, DT, nmd, ml=ml, gamma=gam,
                         gwl=GWL, dtype=jnp.float64, factorize=False)
    if kind == "local":
        return JB.phbath(T, cats, 0.2, 32, DT, nmd, dtype=jnp.float64,
                         factorize=False)
    efric, exim, zeta1, zeta2 = _mats(nc, seed)
    if kind == "electron":
        return JB.ebath(cats, T, DT, nmd, wmax=1.0, efric=efric,
                        dtype=jnp.float64, factorize=False)
    return JB.ebath(cats, T, DT, nmd, wmax=1.0, bias=0.3, efric=efric,
                    exim=exim, zeta1=zeta1, zeta2=zeta2, dtype=jnp.float64,
                    factorize=False)


def _jax_system(nph, nmd, baths, mask=None, **flags):
    m = jnp.ones(nph) if mask is None else jnp.asarray(mask)
    return JMD.GLESystem(dyn=jnp.asarray(j_chain_dynmat(nph, 0.05)),
                         baths=tuple(baths), mask=m, dt=DT, nph=nph,
                         ml=max([b.ml for b in baths], default=1), nmd=nmd,
                         unconstrained=mask is None, **flags)


def _inputs(jsys, ntraj, seed):
    """Per-bath (traj, nmd, nc) noise, and (traj, nph) p0 and q0."""
    rng = np.random.default_rng(seed)
    noises = [0.02 * rng.standard_normal((ntraj, jsys.nmd, b.nc))
              for b in jsys.baths]
    p0 = 0.05 * rng.standard_normal((ntraj, jsys.nph))
    q0 = 0.05 * rng.standard_normal((ntraj, jsys.nph))
    return noises, p0, q0


def _with_noise(jsys, noises):
    return jsys.replace(baths=tuple(
        b.replace(noise=jnp.asarray(n)) for b, n in zip(jsys.baths, noises)))


def _torch_run(jsys, noises, p0, q0, nsteps, t0, phis=None):
    tsys = from_jax_system(jsys, device="cpu")
    tsys = tsys.replace(baths=tuple(
        b.replace(noise=torch.as_tensor(n)) for b, n in
        zip(tsys.baths, noises)))
    st = TMD.initial_state(tsys, p0.shape[0], dtype=torch.float64).replace(
        p=torch.as_tensor(p0), q=torch.as_tensor(q0))
    if phis is not None:
        st = st.replace(phis=torch.as_tensor(phis))
    return TMD.run_segment(tsys, st, nsteps, t0=t0)


def _jax_one(jsys, noises, p0, q0, k, nsteps, t0, phis=None):
    sk = _with_noise(jsys, [n[k] for n in noises])
    st = JMD.initial_state(sk, dtype=jnp.float64).replace(
        p=jnp.asarray(p0[k]), q=jnp.asarray(q0[k]))
    if phis is not None:
        st = st.replace(phis=jnp.asarray(phis[k]))
    return JMD.run_segment(sk, st, nsteps, t0=t0)


def _assert_traj(tfin, tys, k, jfin, jys):
    for name in ("p", "q", "phis", "qhis"):
        np.testing.assert_allclose(getattr(tfin, name)[k].numpy(),
                                   np.asarray(getattr(jfin, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert int(tfin.t[k]) == int(jfin.t)
    for name, v in jys.items():
        if v is None:
            continue
        np.testing.assert_allclose(tys[name][k].numpy(), np.asarray(v),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert set(tys) == {k for k, v in jys.items() if v is not None}


def _check(jsys, ntraj, nsteps, t0=0, seed=0, history=False):
    noises, p0, q0 = _inputs(jsys, ntraj, seed)
    phis = None
    if history:
        rng = np.random.default_rng(seed + 100)
        phis = 0.05 * rng.standard_normal((ntraj, jsys.ml, jsys.nph))
    tfin, tys = _torch_run(jsys, noises, p0, q0, nsteps, t0, phis)
    for k in range(ntraj):
        jfin, jys = _jax_one(jsys, noises, p0, q0, k, nsteps, t0, phis)
        _assert_traj(tfin, tys, k, jfin, jys)
    return tfin, tys


NPH, NMD = 18, 64


@pytest.mark.parametrize("ml", [1, 2, 4, 12])
def test_phonon_memory_lengths(ml):
    """ml 1 (local rule), 2 (no tails), 4 and 12 (tails active), two
    baths of different widths, one of them non-contiguous."""
    kind = "local" if ml == 1 else "phonon"
    jsys = _jax_system(NPH, NMD, [
        _bath(kind, range(4), NMD, ml=ml, T=330.0),
        _bath(kind, [17, 15, 16], NMD, ml=ml, T=270.0)])
    _check(jsys, 2, 40, seed=ml, history=True)


def test_unbiased_electron_bath():
    jsys = _jax_system(NPH, NMD, [_bath("electron", range(5), NMD, seed=1),
                                  _bath("electron", range(13, 18), NMD,
                                        T=250.0, seed=2)])
    _check(jsys, 2, 40, seed=3)


def test_biased_electron_bath():
    """exim, zeta1 and zeta2 at a bias: wind, renormalisation and Berry
    forces."""
    jsys = _jax_system(NPH, NMD, [_bath("biased", range(5), NMD, seed=4),
                                  _bath("biased", [9, 3, 12], NMD, seed=5)])
    assert all(b.bias_terms for b in jsys.baths)
    _check(jsys, 2, 40, seed=6)


def test_mixed_baths_with_mask_and_outputs():
    """All bath kinds together, constrained DOFs, and every per-step
    output (ps, qs, fbaths, f)."""
    mask = np.ones(NPH)
    mask[[0, 8, 17]] = 0.0
    jsys = _jax_system(NPH, NMD, [
        _bath("phonon", range(1, 5), NMD, ml=9),
        _bath("biased", range(13, 17), NMD, seed=7),
        _bath("local", [5, 7], NMD),
        _bath("electron", [10, 11], NMD, seed=8)],
        mask=mask, savep=True, saveq=True, savef=True)
    tfin, tys = _check(jsys, 2, 30, seed=9, history=True)
    assert tys["fbaths"].shape == (2, 30, 4, NPH)
    assert not tfin.p[:, [0, 8, 17]].any() and not tfin.q[:, [0, 8, 17]].any()


def test_offset_start():
    jsys = _jax_system(NPH, NMD, [_bath("phonon", range(4), NMD, ml=6),
                                  _bath("electron", range(14, 18), NMD)])
    _check(jsys, 2, 24, t0=37, seed=10, history=True)


def test_wrap_past_nmd():
    """nsteps > nmd: the noise rows wrap around (t mod nmd)."""
    nmd = 16
    jsys = _jax_system(NPH, nmd, [_bath("phonon", range(4), nmd, ml=5),
                                  _bath("biased", range(14, 18), nmd)])
    _check(jsys, 1, 45, t0=5, seed=11)


def test_batch_matches_jax_vmap():
    jsys = _jax_system(NPH, NMD, [_bath("phonon", range(4), NMD, ml=7),
                                  _bath("electron", range(14, 18), NMD)],
                       savep=True)
    ntraj, nsteps = 3, 32
    noises, p0, q0 = _inputs(jsys, ntraj, 12)

    def one(nz, p, q):
        sk = _with_noise(jsys, nz)
        st = JMD.initial_state(sk, dtype=jnp.float64).replace(p=p, q=q)
        return JMD.run_segment(sk, st, nsteps)

    jfin, jys = jax.vmap(one)([jnp.asarray(n) for n in noises],
                              jnp.asarray(p0), jnp.asarray(q0))
    tfin, tys = _torch_run(jsys, noises, p0, q0, nsteps, 0)
    for k in range(ntraj):
        _assert_traj(tfin, tys, k, jax.tree.map(lambda x: x[k], jfin),
                     {n: v[k] for n, v in jys.items()})


def test_segments_chain():
    """Two segments through the ring's end-of-segment history equal one."""
    jsys = _jax_system(NPH, NMD, [_bath("phonon", range(4), NMD, ml=11),
                                  _bath("local", range(15, 18), NMD)])
    noises, p0, q0 = _inputs(jsys, 2, 13)
    full, _ = _torch_run(jsys, noises, p0, q0, 30, 3)
    mid, _ = _torch_run(jsys, noises, p0, q0, 17, 3)
    tsys = from_jax_system(jsys, device="cpu").replace(baths=tuple(
        b.replace(noise=torch.as_tensor(n)) for b, n in
        zip(from_jax_system(jsys, device="cpu").baths, noises)))
    two, _ = TMD.run_segment(tsys, mid, 13, t0=20)
    for name in ("p", "q", "phis", "qhis"):
        torch.testing.assert_close(getattr(two, name), getattr(full, name),
                                   rtol=1e-12, atol=1e-14)


def test_zero_steps_returns_state():
    jsys = _jax_system(NPH, NMD, [_bath("electron", range(4), NMD)])
    noises, p0, q0 = _inputs(jsys, 2, 14)
    fin, ys = _torch_run(jsys, noises, p0, q0, 0, 0)
    assert ys["etot"].shape == (2, 0) and ys["cur"].shape == (2, 0, 1)
    np.testing.assert_array_equal(fin.p.numpy(), p0)


# --- the kernels' plain twins against the JAX force rules --------------------
@pytest.mark.parametrize("ml", [3, 12])
def test_conv_tails_twin_matches_step_plan(ml):
    """K6's twin reads the history out of a ring at any head (step s of a
    segment: head -s mod mlr), as ``PhBath.step_plan`` reads the
    newest-first history."""
    jb = _bath("phonon", [2, 0, 5, 4], NMD, ml=ml)
    tb = from_jax_bath(jb, device="cpu")
    rng = np.random.default_rng(ml)
    mlr = ml + 3
    ntraj, head = 3, 5
    ring = rng.normal(size=(ntraj, mlr, 8))
    step = (-head) % mlr + 2 * mlr
    got = K6.conv_tails_plan(torch.as_tensor(ring), [tb])(step)[0]
    assert got.shape == (ntraj, 4, 2)
    for k in range(ntraj):
        old = ring[k][(head + np.arange(mlr)) % mlr][:ml][:, jb.cids]
        want = np.asarray(jb.step_plan(jnp.asarray(old)))
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-12,
                                   atol=1e-14)
    assert K6.tail_baths([tb, from_jax_bath(_bath("phonon", [1], NMD, ml=2),
                                            device="cpu"), tb]) == [0, 2]


@pytest.mark.parametrize("kind,ml", [("phonon", 2), ("phonon", 6),
                                     ("local", 1), ("electron", 1),
                                     ("biased", 1)])
def test_bath_force_twin_matches_force_rules(kind, ml):
    """K7's twin (predictor, corrector and last corrector) against the
    JAX ``force_pred``/``force_corr`` (``_markov_force``) and the
    Verlet arithmetic around them."""
    nph, nmd, ntraj = 10, 16, 3
    cats = [7, 1, 3, 4]
    jb = _bath(kind, cats, nmd, ml=ml, seed=15)
    rng = np.random.default_rng(16)
    noise = rng.normal(size=(ntraj, nmd, 4))
    tb = from_jax_bath(jb, device="cpu").replace(noise=torch.as_tensor(noise))
    mlr = max(ml, 2)
    p, q, pf, pf2, x = (rng.normal(size=(ntraj, nph)) for _ in range(5))
    ring = rng.normal(size=(ntraj, mlr, nph))
    tail = rng.normal(size=(ntraj, 4, 2)) if ml > 2 else None
    mask = np.ones(nph)
    mask[[3, 9]] = 0.0
    # step s of a segment starting at t0: ring head -s mod mlr = 1, push
    # row 0, noise rows t0 + s = 5 and 6
    head, row, s = 1, 5, mlr - 1
    force = K7.BathForce([tb], ntraj, nph, nmd, DT, "cpu", t0=row - s)
    cur = torch.zeros((ntraj, s + 1, 1), dtype=torch.float64)
    etot = torch.zeros((ntraj, s + 1), dtype=torch.float64)
    ps, qs = (torch.zeros((ntraj, s + 1, nph), dtype=torch.float64)
              for _ in range(2))
    fbs = [torch.zeros((ntraj, 4), dtype=torch.float64)]
    ring_t = torch.as_tensor(ring.copy())
    tails = [None if tail is None else torch.as_tensor(tail)]
    pthalf, qtt = force.pred(torch.as_tensor(p), torch.as_tensor(q),
                             torch.as_tensor(pf), ring_t, s, tails, cur,
                             etot, fbs, ps=ps, qs=qs)
    pc, none = force.corr(torch.as_tensor(x), qtt, torch.as_tensor(pf2),
                          torch.as_tensor(p), pthalf, tails, s)
    f_out = torch.zeros((ntraj, nph), dtype=torch.float64)
    pl, ql = force.corr(torch.as_tensor(x), qtt, torch.as_tensor(pf2),
                        torch.as_tensor(p), pthalf, tails, s,
                        mask=torch.as_tensor(mask), f_out=f_out)
    assert none is None
    np.testing.assert_array_equal(ps[:, s].numpy(), p)
    np.testing.assert_array_equal(qs[:, s].numpy(), q)
    c = np.asarray(cats)
    for k in range(ntraj):
        plan = None if tail is None else jnp.asarray(tail[k])
        old = jnp.asarray(ring[k, head][c][None])
        fb = np.asarray(jb.force_pred(jnp.asarray(noise[k, row]),
                                      jnp.asarray(p[k, c]),
                                      jnp.asarray(q[k, c]), old, plan))
        f = pf[k].copy()
        f[c] += fb
        np.testing.assert_allclose(fbs[0][k].numpy(), fb, rtol=1e-12)
        np.testing.assert_allclose(cur[k, s, 0].item(), fb @ p[k, c],
                                   rtol=1e-12)
        np.testing.assert_allclose(etot[k, s].item(), 0.5 * p[k] @ p[k],
                                   rtol=1e-12)
        np.testing.assert_allclose(pthalf[k].numpy(), p[k] + f * DT / 2,
                                   rtol=1e-12)
        qtt_k = q[k] + p[k] * DT + f * DT * DT / 2
        np.testing.assert_allclose(qtt[k].numpy(), qtt_k, rtol=1e-12)
        np.testing.assert_array_equal(ring_t[k, 0].numpy(), p[k])
        fc = np.asarray(jb.force_corr(jnp.asarray(noise[k, row + 1]),
                                      jnp.asarray(x[k, c]),
                                      jnp.asarray(qtt_k[c]),
                                      jnp.asarray(p[k, c]), plan))
        f2 = pf2[k].copy()
        f2[c] += fc
        np.testing.assert_allclose(pc[k].numpy(),
                                   pthalf[k].numpy() + DT / 2 * f2,
                                   rtol=1e-12)
        np.testing.assert_allclose(f_out[k].numpy(), f2, rtol=1e-12)
        np.testing.assert_allclose(pl[k].numpy(), pc[k].numpy() * mask,
                                   rtol=1e-12)
        np.testing.assert_allclose(ql[k].numpy(), qtt_k * mask, rtol=1e-12)
        if kind in ("electron", "biased"):
            want = np.asarray(jb._markov_force(
                jnp.asarray(noise[k, row]), jnp.asarray(p[k, c]),
                jnp.asarray(q[k, c])))
            np.testing.assert_allclose(fb, want, rtol=1e-12)


# --- the port's plain path against its blocked path --------------------------
@pytest.mark.parametrize("ml,block", [(17, 8), (5, 16)])
def test_plain_matches_blocked(ml, block):
    """As tests/test_blocked.py holds the JAX blocked path against the
    plain one: same noise, same start, non-local phonon baths."""
    jsys = _jax_system(NPH, NMD, [
        _bath("phonon", range(4), NMD, ml=ml, T=320.0),
        _bath("phonon", range(12, 16), NMD, ml=ml - 2, T=280.0)])
    noises, p0, q0 = _inputs(jsys, 3, 17)
    tsys = from_jax_system(jsys, device="cpu")
    tsys = tsys.replace(baths=tuple(
        b.replace(noise=torch.as_tensor(n)) for b, n in
        zip(tsys.baths, noises)), unconstrained=True)
    st = TMD.initial_state(tsys, 3, dtype=torch.float64).replace(
        p=torch.as_tensor(p0), q=torch.as_tensor(q0))
    fp, yp = TMD.run_segment(tsys, st, 48, t0=9)
    fb, yb = TMD.run_segment_blocked(tsys, st, 48, t0=9, block=block)
    for a, b in ((fp.p, fb.p), (fp.q, fb.q), (fp.qhis, fb.qhis),
                 (yp["cur"], yb["cur"]), (yp["etot"], yb["etot"])):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
    for b in tsys.baths:
        torch.testing.assert_close(fp.phis[:, :b.ml - 1, b.cols],
                                   fb.phis[:, :b.ml - 1, b.cols],
                                   rtol=1e-9, atol=1e-12)
