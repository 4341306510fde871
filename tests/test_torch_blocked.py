"""Parity of the port's blocked integrator with the JAX package.

The same junction (harmonic chain + non-local phonon baths), the same
injected noise and the same initial state go through
``sclmd_tpu.md.run_segment_blocked`` (one trajectory at a time) and
``sclmd_tpu_torch.md.run_segment_blocked`` (the batch at once, through
the plain twins of kernels K1 and K2 on the CPU), in float64. K1 runs a
block as sub-blocks of near taps with far-tap updates between them; the
tests set the sub-block length to cover one-step blocks, blocks that
are and are not multiples of it, and memory kernels shorter and longer
than the block.

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
from sclmd_tpu_torch.kernels import gle_block as K1

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
    tsys = from_jax_system(jsys, device="cpu")
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
    tsys = from_jax_system(jsys, device="cpu")
    st = TMD.initial_state(tsys, 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple of"):
        TMD.run_segment_blocked(tsys, st, 30, block=8)


def test_blocked_rejects_local_bath():
    tsys = from_jax_system(_jax_system(**SMALL), device="cpu")
    from sclmd_tpu_torch import baths as TB
    local = TB.phbath(300.0, range(4), 0.3, 32, 0.4, 128,
                      dtype=torch.float64, device="cpu")
    local = local.replace(noise=torch.zeros((1, 128, 4),
                                            dtype=torch.float64))
    tsys = tsys.replace(baths=(local,))
    st = TMD.initial_state(tsys, 1, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TMD.run_segment_blocked(tsys, st, 16, block=8)


# --- the split of K1: near-tap sub-blocks with far-tap updates between ---
@pytest.fixture
def sub_steps(monkeypatch):
    """Set the sub-block length the composition uses."""
    def use(sub):
        monkeypatch.setattr(K1, "sub_steps",
                            lambda block: min(block, sub))
    return use


@pytest.mark.parametrize("block,sub,nsteps", [
    (1, 1, 16),       # one step per block: near taps only
    (8, 4, 64),       # block a multiple of the sub-block
    (8, 3, 64),       # ragged last sub-block (3 + 3 + 2)
    (32, 5, 64),      # ml 17 and 12 shorter than the block
])
def test_split_blocked_matches_jax(sub_steps, block, sub, nsteps):
    """The near- and far-tap twins composed by run_segment_blocked on the
    CPU against the JAX package's blocked integrator."""
    sub_steps(sub)
    jsys = _jax_system(**SMALL)
    noises = _noise_batch(jsys, 2, block + sub)
    rng = np.random.default_rng(sub)
    p0 = 0.05 * rng.standard_normal((2, 24))
    q0 = 0.05 * rng.standard_normal((2, 24))
    _assert_match(*_run_both(jsys, noises, p0, q0, nsteps, block, t0=3))


def test_split_blocked_constrained_matches_jax(sub_steps):
    """Constrained DOFs (no force carry-forward) through the split."""
    sub_steps(3)
    mask = np.ones(24)
    mask[[0, 1, 23]] = 0.0
    jsys = _jax_system(**SMALL, mask=mask)
    noises = _noise_batch(jsys, 2, 5)
    rng = np.random.default_rng(4)
    p0 = 0.05 * rng.standard_normal((2, 24)) * mask
    _assert_match(*_run_both(jsys, noises, p0, np.zeros((2, 24)), 32, 16))


def test_split_blocked_wide_matches_jax(sub_steps):
    """nc 12 baths, ml 65 longer than the block, three trajectories, a
    block of 16 in sub-blocks of 6 (6 + 6 + 4)."""
    sub_steps(6)
    jsys = _jax_system(nph=60, nmd=128, specs=[
        (310.0, range(12), 65, 12), (290.0, range(48, 60), 65, 12)])
    noises = _noise_batch(jsys, 3, 12)
    rng = np.random.default_rng(6)
    p0 = 0.02 * rng.standard_normal((3, 60))
    q0 = 0.02 * rng.standard_normal((3, 60))
    _assert_match(*_run_both(jsys, noises, p0, q0, 48, 16))


@pytest.mark.parametrize("block,b0,ns", [(8, 0, 3), (8, 3, 3), (9, 0, 8),
                                         (16, 5, 4)])
def test_far_twin_matches_direct_sum(block, b0, ns):
    """gle_far_plain against the sum written term by term:
    O[:, s] += sum_{i<ns} K[s-b0-i] p_{b0+i} for s in [b0+ns, block]."""
    rng = np.random.default_rng(block + b0 + ns)
    nc, ntraj = 3, 2
    kin = rng.standard_normal((nc, (block + 1) * nc))
    ring = rng.standard_normal((ntraj, block, nc))
    O = rng.standard_normal((ntraj, block + 1, nc))
    want = O.copy()
    for t in range(ntraj):
        for s in range(b0 + ns, block + 1):
            for i in range(ns):
                d = s - b0 - i                      # tap, kin block d-1
                K = kin[:, (d - 1) * nc:d * nc]
                want[t, s] += K @ ring[t, block - 1 - b0 - i]
    got = torch.as_tensor(O)
    K1.gle_far_plain(torch.as_tensor(kin), torch.as_tensor(ring), got,
                     block, b0, ns)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[:, :b0 + ns].numpy(),
                                  O[:, :b0 + ns])


@pytest.mark.parametrize("free", [True, False])
@pytest.mark.parametrize("sub", [1, 2, 3, 11, 16])
def test_split_matches_whole_block_twin(sub_steps, free, sub):
    """The split composition against gle_block_plain (the whole block in
    one piece) on random operands, two baths of which one is scattered."""
    sub_steps(sub)
    rng = np.random.default_rng(sub)
    ntraj, nph, nc, block, nmd = 3, 12, 4, 11, 40

    def rnd(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape))

    baths = []
    for cols in (slice(0, 4), torch.tensor([7, 9, 8, 11])):
        kin = rnd(nc, (block + 1) * nc, scale=0.05)
        baths.append(K1.BathOperands(
            rnd(ntraj, nmd, nc, scale=0.1), rnd(ntraj, block + 1, nc,
                                                scale=0.1),
            kin, K1.tap_major(kin, block), rnd(nc, nc, scale=0.1), cols,
            None))
    dyn = rnd(nph, nph, scale=0.05)
    dyn = dyn + dyn.T
    mask = torch.ones(nph, dtype=torch.float64)
    if not free:
        mask[[2, 10]] = 0.0
    p, q = rnd(ntraj, nph, scale=0.1), rnd(ntraj, nph, scale=0.1)
    pf = -(q @ dyn.T) if free else torch.zeros_like(p)
    args = (p, q, pf, dyn, mask, baths, 5, nmd, 0.3, free, block)
    before = [t.clone() for t in (p, q, pf, *(b.O for b in baths))]
    got, want = K1.gle_block(*args), K1.gle_block_plain(*args)
    for name in ("p", "q", "pf", "qprev", "cur", "etot"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, atol=1e-14)
    for g, w in zip(got.rings, want.rings):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-14)
    # the far updates go to a copy of O: the operands are left as found
    for x, y in zip(before, (p, q, pf, *(b.O for b in baths))):
        assert torch.equal(x, y)
