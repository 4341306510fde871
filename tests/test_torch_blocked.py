"""Parity of the port's blocked integrator with the JAX package.

The same junction (harmonic chain + non-local phonon baths), the same
injected noise and the same initial state go through
``sclmd_tpu.md.run_segment_blocked`` (one trajectory at a time) and
``sclmd_tpu_torch.md.run_segment_blocked`` (the batch at once, through
the plain twins of kernels K1 and K2 on the CPU), in float64.

Tolerance rtol 1e-9: both sides compute the same terms in float64 but
sum them in another order (XLA's fused dots and FFTs against torch's
batched matmuls and pocketfft), so they agree to float64 rounding
amplified over the run, as tests/test_blocked.py holds the JAX blocked
path against the plain one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu import md as JMD
from sclmd_tpu.models.harmonic import chain_dynmat as j_chain_dynmat

from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.convert import from_jax_system

torch.set_num_threads(2)

RTOL = 1e-9


def _jax_system(nph, nmd, specs, dt=0.4, seed=3, mask=None):
    """``specs``: (T, cats, ml, nc) per bath; noise from host numpy."""
    gwl = np.linspace(0.0, 0.6, 16)
    baths = []
    for i, (T, cats, ml, nc) in enumerate(specs):
        gam = np.array([np.eye(nc) * 0.02 * np.exp(-(w / 0.3) ** 2)
                        for w in gwl])
        pb = JB.phbath(T, cats, 0.3, 32, dt, nmd, ml=ml, gamma=gam, gwl=gwl,
                       dtype=jnp.float64)
        baths.append(pb.gnoi_np(seed + i, dtype=np.float64)
                     .replace(nevecs=None, nstd=None))
    m = jnp.ones(nph) if mask is None else jnp.asarray(mask)
    return JMD.GLESystem(dyn=jnp.asarray(j_chain_dynmat(nph, 0.05)),
                         baths=tuple(baths), mask=m, dt=dt, nph=nph,
                         ml=max(b.ml for b in baths), nmd=nmd,
                         unconstrained=mask is None)


def _with_noise(system, noises):
    return system.replace(baths=tuple(
        b.replace(noise=jnp.asarray(n)) for b, n in zip(system.baths, noises)))


def _run_both(jsys, noises, p0, q0, nsteps, block, t0=0):
    """JAX per trajectory vs the port's batch; noises[i] is (traj, nmd, nc)."""
    ntraj = p0.shape[0]
    jfin, jys = [], []
    for k in range(ntraj):
        sk = _with_noise(jsys, [n[k] for n in noises])
        st = JMD.initial_state(sk, dtype=jnp.float64).replace(
            p=jnp.asarray(p0[k]), q=jnp.asarray(q0[k]))
        f, ys = JMD.run_segment_blocked(sk, st, nsteps, t0=t0, block=block)
        jfin.append(f)
        jys.append(ys)
    tsys = from_jax_system(jsys)
    tsys = tsys.replace(baths=tuple(
        b.replace(noise=torch.as_tensor(n)) for b, n in
        zip(tsys.baths, noises)))
    st = TMD.initial_state(tsys, ntraj, dtype=torch.float64).replace(
        p=torch.as_tensor(p0), q=torch.as_tensor(q0))
    tfin, tys = TMD.run_segment_blocked(tsys, st, nsteps, t0=t0, block=block)
    return jfin, jys, tfin, tys


def _assert_match(jfin, jys, tfin, tys):
    for k, (f, ys) in enumerate(zip(jfin, jys)):
        for name in ("p", "q", "phis", "qhis"):
            np.testing.assert_allclose(
                getattr(tfin, name)[k].numpy(), np.asarray(getattr(f, name)),
                rtol=RTOL, atol=1e-13, err_msg=name)
        np.testing.assert_allclose(tys["cur"][k].numpy(),
                                   np.asarray(ys["cur"]), rtol=RTOL,
                                   atol=1e-13)
        np.testing.assert_allclose(tys["etot"][k].numpy(),
                                   np.asarray(ys["etot"]), rtol=RTOL,
                                   atol=1e-13)
        assert int(tfin.t[k]) == int(f.t)


def _noise_batch(jsys, ntraj, seed):
    rng = np.random.default_rng(seed)
    return [np.stack([np.asarray(b.noise)] +
                     [np.asarray(b.noise) * rng.uniform(0.5, 1.5)
                      + 1e-3 * rng.standard_normal(b.noise.shape)
                      for _ in range(ntraj - 1)])
            for b in jsys.baths]


# the tests/test_blocked.py junction without its electron bath: two
# non-local phonon baths (ml 17 and 12, nc 4) on a 24-DOF chain
SMALL = dict(nph=24, nmd=128, specs=[(280.0, range(20, 24), 17, 4),
                                     (300.0, range(10, 14), 12, 4)])


@pytest.mark.parametrize("block", [4, 8, 32])
def test_blocked_matches_jax(block):
    jsys = _jax_system(**SMALL)
    noises = _noise_batch(jsys, 2, block)
    rng = np.random.default_rng(block)
    p0 = 0.05 * rng.standard_normal((2, 24))
    q0 = 0.05 * rng.standard_normal((2, 24))
    _assert_match(*_run_both(jsys, noises, p0, q0, 64, block, t0=5))


def test_blocked_constrained_matches_jax():
    """mask with constrained DOFs: no force carry-forward, the potential
    force is re-evaluated at every step on both sides."""
    mask = np.ones(24)
    mask[[0, 1, 23]] = 0.0
    jsys = _jax_system(**SMALL, mask=mask)
    noises = _noise_batch(jsys, 2, 7)
    p0 = np.zeros((2, 24))
    q0 = np.zeros((2, 24))
    _assert_match(*_run_both(jsys, noises, p0, q0, 32, 8))


def test_blocked_wide_three_trajectories():
    """nph=60 chain, two nc=12 baths with ml=65: the frequency-
    proportional noise path and a history longer than the block."""
    jsys = _jax_system(nph=60, nmd=128, specs=[
        (310.0, range(12), 65, 12), (290.0, range(48, 60), 65, 12)])
    noises = _noise_batch(jsys, 3, 11)
    rng = np.random.default_rng(5)
    p0 = 0.02 * rng.standard_normal((3, 60))
    q0 = 0.02 * rng.standard_normal((3, 60))
    _assert_match(*_run_both(jsys, noises, p0, q0, 64, 16))


def test_blocked_rejects_ragged_block():
    jsys = _jax_system(**SMALL)
    tsys = from_jax_system(jsys)
    st = TMD.initial_state(tsys, 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple of"):
        TMD.run_segment_blocked(tsys, st, 30, block=8)


def test_blocked_rejects_local_bath():
    tsys = from_jax_system(_jax_system(**SMALL))
    from sclmd_tpu_torch import baths as TB
    local = TB.phbath(300.0, range(4), 0.3, 32, 0.4, 128,
                      dtype=torch.float64)
    local = local.replace(noise=torch.zeros((1, 128, 4),
                                            dtype=torch.float64))
    tsys = tsys.replace(baths=(local,))
    st = TMD.initial_state(tsys, 1, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TMD.run_segment_blocked(tsys, st, 16, block=8)

