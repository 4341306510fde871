"""The port's ensemble path (``fused_chunk``, ``md.RunEnsemble``) against
the JAX package, and its counter-keyed draw schedule.

JAX's threefry draws cannot be reproduced in torch, so the parity test
injects the same numbers into both: the noise draws come from one numpy
generator per trajectory (the JAX host sampler draws them from the same
generator state), and the thermal-init phases are the uniforms JAX's
``thermal_init`` draws from its key. CPU float64 throughout.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu import md as JMD
from sclmd_tpu.ops import noise as JN

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.kernels import noise_synth as K3
from sclmd_tpu_torch.ops import noise as TN
from sclmd_tpu_torch.parallel import ensemble as TE

torch.set_num_threads(2)

NAT, NMD, DT, T, ML, NC = 4, 64, 0.4, 300.0, 9, 3
NPH = 3 * NAT
GWL = np.linspace(0.0, 0.6, 16)
GAM = np.array([np.eye(NC) * 0.02 * np.exp(-(w / 0.3) ** 2) for w in GWL])
SPECS = ((330.0, range(NC)), (270.0, range(NPH - NC, NPH)))


def _dyn():
    from sclmd_tpu_torch.models.harmonic import chain_dynmat
    return chain_dynmat(NPH, 0.05).numpy()


def _torch_runner(outdir, seed=7):
    r = TMD.md(DT, NMD, T, axyz=[["C", 1.0 * i, 0.0, 0.0]
                                 for i in range(NAT)],
               dyn=_dyn(), dtype=torch.float64, seed=seed,
               outdir=str(outdir), block=16, device="cpu")
    for Tb, cats in SPECS:
        r.AddBath(TB.phbath(Tb, cats, 0.3, 32, DT, NMD, ml=ML, gamma=GAM,
                            gwl=GWL, dtype=torch.float64, device="cpu"))
    return r


def test_fused_chunk_matches_jax():
    """Injected draws: the port's fused_chunk (noise synthesis, thermal
    init, blocked run, current reduction) equals the JAX pipeline per
    trajectory to float64 rounding (rtol 1e-9, summation order)."""
    ntraj, nsteps, block, skip = 3, 64, 16, 16
    jbaths = [JB.phbath(Tb, cats, 0.3, 32, DT, NMD, ml=ML, gamma=GAM,
                        gwl=GWL, dtype=jnp.float64) for Tb, cats in SPECS]
    dyn, hw, U = JMD.set_dyn(_dyn(), dtype=jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(3), ntraj)
    us = np.stack([np.asarray(jax.random.uniform(k, (NPH,),
                                                 dtype=jnp.float64))
                   for k in keys])
    seeds = [[100 * i + j for j in range(ntraj)] for i in range(len(SPECS))]

    want = []
    for j in range(ntraj):
        bs = tuple(b.replace(noise=jnp.asarray(JN.sample_noise_np(
            np.random.default_rng(seeds[i][j]), b.nevecs, b.nstd, DT, NMD)),
            nevecs=None, nstd=None) for i, b in enumerate(jbaths))
        sys_j = JMD.GLESystem(dyn=dyn, baths=bs, mask=jnp.ones(NPH), dt=DT,
                              nph=NPH, ml=ML, nmd=NMD, unconstrained=True)
        st = JMD.thermal_init(keys[j], sys_j, hw, U, T)
        _, ys = JMD.run_segment_blocked(sys_j, st, nsteps, block=block)
        want.append(np.asarray(ys["cur"])[skip:].sum(axis=0))

    r = _torch_runner("unused")
    facs = TE.bath_factors(r.baths, "cpu")
    rs = [torch.as_tensor(np.stack([
        np.random.default_rng(s).standard_normal(tuple(std.shape))
        for s in seeds[i]])) for i, (_, std) in enumerate(facs)]
    system = r._build_system()
    finals, sums, ok = TE.fused_chunk(
        system, facs, rs, nsteps, 0, block, skip,
        states=TMD.thermal_init(torch.as_tensor(us), system, r.hw, r.U, T))
    assert bool(ok) and sums.shape == (ntraj, 2)
    np.testing.assert_allclose(sums.numpy(), np.stack(want), rtol=1e-9,
                               atol=1e-14)


def test_chunked_ensemble_is_bitwise_unchunked(tmp_path):
    """Draws come from the (seed, stream, trajectory)-keyed Philox
    schedule, so chunks of 2 and 4 (ragged) reproduce the single batch
    exactly."""
    means = {}
    for chunk in (6, 2, 4):
        d = tmp_path / f"c{chunk}"
        d.mkdir()
        means[chunk] = _torch_runner(d).RunEnsemble(6, chunk=chunk)
    assert np.array_equal(means[2], means[4])
    assert np.array_equal(means[2], means[6])
    assert np.isfinite(means[2]).all() and means[2].shape == (6, 2)


def test_draw_schedule_windows():
    """The Philox schedule: windows of trajectories [0, 5) and [3, 5) draw
    bitwise the same noise series and thermal starts; streams differ by
    bath and seeds differ; the twin's noise is the schedule's normals
    through ``sample_noise_from_r``, and its start is ``thermal_init`` on
    the schedule's uniforms (stream = number of baths)."""
    from sclmd_tpu_torch.ops import philox
    from sclmd_tpu_torch.ops.noise import sample_noise_from_r
    r = _torch_runner("unused")
    system = r._build_system()
    facs = TE.bath_factors(r.baths, "cpu")
    start = r._thermal_start(T)
    rs, st = TE.draw_chunk(facs, 11, 0, 5, DT, NMD, start, system)
    rs2, st2 = TE.draw_chunk(facs, 11, 3, 5, DT, NMD, start, system)
    assert torch.equal(rs[1][3:], rs2[1])
    assert torch.equal(st.p[3:], st2.p) and torch.equal(st.q[3:], st2.q)
    assert not torch.equal(rs[0], rs[1])        # streams differ by bath
    noises, none = TE.draw_chunk(facs, 12, 0, 5, DT, NMD)
    assert none is None and not torch.equal(noises[0], rs[0])
    u = philox.uniforms(11, len(facs), 0, 5, NPH, dtype=torch.float64)
    want = TMD.thermal_init(u, system, r.hw, r.U, T)
    assert torch.equal(st.p, want.p) and torch.equal(st.q, want.q)
    ev, std = facs[1]
    z = philox.normals(11, 1, 0, 5, std.numel()).reshape((5,) + std.shape)
    assert torch.equal(rs[1], sample_noise_from_r(z, ev, std, DT, NMD))


@pytest.mark.parametrize("per_mode", [False, True])
def test_thermal_start_matches_jax_thermal_init(per_mode):
    """K3b's twin and the product (``md.ThermalStart``) on the uniforms
    the JAX package's ``thermal_init`` draws from its key give its state,
    for a scalar temperature and a per-mode one; on the schedule's
    uniforms they give the port's ``thermal_init`` bitwise."""
    from sclmd_tpu_torch.ops import philox
    r = _torch_runner("unused")
    r.AddConstr([[0, 1, 2]])
    system = r._build_system()
    Tm = np.linspace(250.0, 350.0, NPH) if per_mode else T
    dyn, hw, U = JMD.set_dyn(_dyn(), dtype=jnp.float64)
    jsys = JMD.GLESystem(dyn=dyn, baths=(), mask=jnp.asarray(
        system.mask.numpy()), dt=DT, nph=NPH, ml=1, nmd=NMD)
    start = TMD.ThermalStart(r.hw, r.U, Tm, torch.float64, "cpu")
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    for key in keys:
        u = torch.as_tensor(np.array(jax.random.uniform(
            key, (NPH,), dtype=jnp.float64)))[None]
        got = start.project(K3.amplitudes_of(u, start.am, start.hw), system)
        want = JMD.thermal_init(key, jsys, hw, U, jnp.asarray(Tm))
        for a, b in ((got.p[0], want.p), (got.q[0], want.q)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-12 * np.abs(b).max())
        assert not got.p[0, :3].any() and not got.q[0, :3].any()
    st = start.states(system, 8, 2, 1, 5)
    u = philox.uniforms(8, 2, 1, 5, NPH, dtype=torch.float64)
    ref = TMD.thermal_init(u, system, r.hw, r.U, Tm)
    assert torch.equal(st.p, ref.p) and torch.equal(st.q, ref.q)


def test_thermal_start_made_once_per_temperature(tmp_path, monkeypatch):
    """The runner makes a temperature's amplitudes, frequencies and
    eigenvectors once, and reuses them across calls and chunks."""
    made = []
    real = TMD.ThermalStart.__init__

    def spy(self, hw, evecs, T, *a, **k):
        made.append(np.asarray(T))
        real(self, hw, evecs, T, *a, **k)

    monkeypatch.setattr(TMD.ThermalStart, "__init__", spy)
    r = _torch_runner(tmp_path)
    r.RunEnsemble(4, chunk=2)
    r.RunEnsemble(3, chunk=2)
    assert len(made) == 1 and float(made[0]) == T
    s1 = r._thermal_start(T)
    assert r._thermal_start(float(T)) is s1
    Tm = np.full(NPH, 310.0)
    s2 = r._thermal_start(Tm)
    assert s2 is not s1 and r._thermal_start(Tm.copy()) is s2
    assert len(made) == 2
    r.setDyn(_dyn())                             # new modes, new starts
    assert r._thermal_start(T) is not s1


def test_ensemble_states_windows():
    r = _torch_runner("unused")
    system = r._build_system()
    full = TE.ensemble_states(system, 5, seed=4, hw=r.hw, evecs=r.U, T=T)
    win = TE.ensemble_states(system, 5, seed=4, hw=r.hw, evecs=r.U, T=T,
                             lo=1, hi=3)
    assert torch.equal(full.p[1:3], win.p) and torch.equal(full.q[1:3], win.q)
    zero = TE.ensemble_states(system, 5, lo=1, hi=3)
    assert zero.p.shape == (2, NPH) and not zero.p.any()


def test_run_ensemble_kappa_files_match_jax(tmp_path):
    """Same kappa.T.bathI.runJ.dat names and columns as the JAX runner."""
    dj, dt_ = tmp_path / "jax", tmp_path / "torch"
    dj.mkdir()
    dt_.mkdir()
    rj = JMD.md(DT, NMD, T, axyz=[["C", 1.0 * i, 0.0, 0.0]
                                  for i in range(NAT)],
                dyn=_dyn(), dtype=jnp.float64, outdir=str(dj), block=16)
    for Tb, cats in SPECS:
        rj.AddBath(JB.phbath(Tb, cats, 0.3, 32, DT, NMD, ml=ML, gamma=GAM,
                             gwl=GWL, dtype=jnp.float64))
    mj = rj.RunEnsemble(3)
    mt = _torch_runner(dt_).RunEnsemble(3)
    assert mj.shape == mt.shape == (3, 2)
    names_j = sorted(os.listdir(dj))
    assert names_j == sorted(os.listdir(dt_))
    assert len(names_j) == 6 and names_j[0] == "kappa.300.bath0.run0.dat"
    for name in names_j:
        fj = open(dj / name).read().split()
        ft = open(dt_ / name).read().split()
        assert len(fj) == len(ft) == 3 and fj[:2] == ft[:2]
        float(ft[2])


def test_kappa_files_are_the_bytes_of_buffered_open(tmp_path):
    """The raw-syscall writer leaves the bytes ``open(path, "w")`` would
    write: 3 trajectories x 2 baths."""
    (tmp_path / "a").mkdir()
    r = _torch_runner(tmp_path / "a")
    means = r.RunEnsemble(3)
    names = sorted(os.listdir(tmp_path / "a"))
    assert len(names) == 6
    (tmp_path / "b").mkdir()
    for j in range(3):
        for i in range(2):
            name = f"kappa.300.bath{i}.run{j}.dat"
            with open(tmp_path / "b" / name, "w") as f:
                f.write("%i %f    %f \n" % (j, r.T,
                                             means[j, i] * TMD.U.CURCOF))
            assert (tmp_path / "a" / name).read_bytes() == \
                (tmp_path / "b" / name).read_bytes()


def test_auto_chunk_budget():
    system = _torch_runner("unused")._build_system()
    per = TE.estimate_traj_bytes(system, NMD, 16)
    assert per > 0
    assert TE.auto_chunk(system, 100, NMD, 16) == 100
    assert TE.auto_chunk(system, 100, NMD, 16, budget_bytes=per * 40) == 32
    assert TE.auto_chunk(system, 100, NMD, 16, budget_bytes=per * 40,
                         depth=2) == 16


@pytest.mark.parametrize("block,kw", [
    (16, dict(npie=2)), (16, dict(checkpoint=True)),
    (None, dict(npie=4, checkpoint=True))])
def test_segmented_equals_fused(tmp_path, block, kw):
    """Segments (npie), the checkpointed path, or both, give the fused
    call's means to rounding (the same draws; the segments' current sums
    are added on the host), on the blocked and the plain step: the
    port's side of the JAX package's
    test_fused_matches_segmented_and_checkpoint_paths."""
    d1, d2 = tmp_path / "fused", tmp_path / "seg"
    d1.mkdir()
    d2.mkdir()
    r1, r2 = _torch_runner(d1), _torch_runner(d2)
    r1.block = r2.block = block
    fused = r1.RunEnsemble(5, chunk=2)
    seg = r2.RunEnsemble(5, chunk=2, **kw)
    np.testing.assert_allclose(seg, fused, rtol=1e-11, atol=1e-15)
    assert os.path.isfile(d2 / "MDE.npz") == bool(kw.get("checkpoint"))
    for name in os.listdir(d1):
        assert (d2 / name).is_file(), name


class _Interrupted(Exception):
    pass


def _interrupt_after(monkeypatch, n):
    """Let the port's runner write ``n`` ensemble checkpoints, then stop
    it as a lost job would stop."""
    real = TMD.md._save_ensemble_checkpoint
    done = []

    def save(self, *a, **k):
        real(self, *a, **k)
        done.append(1)
        if len(done) == n:
            raise _Interrupted
    monkeypatch.setattr(TMD.md, "_save_ensemble_checkpoint", save)


def test_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """A call stopped after its third checkpoint (chunk 1 of 3, segment 0
    of 2) and resumed by a fresh runner in the same directory gives the
    uninterrupted call's means bitwise and rewrites every kappa file; a
    finished ensemble resumed again returns the same means."""
    d1, d2 = tmp_path / "whole", tmp_path / "resumed"
    d1.mkdir()
    d2.mkdir()
    want = _torch_runner(d1).RunEnsemble(5, chunk=2, npie=2,
                                         checkpoint=True)
    with monkeypatch.context() as m:
        _interrupt_after(m, 3)
        with pytest.raises(_Interrupted):
            _torch_runner(d2).RunEnsemble(5, chunk=2, npie=2,
                                          checkpoint=True)
    ck = np.load(d2 / "MDE.npz")
    assert int(ck["ichunk"][0]) == 1 and int(ck["ipie"][0]) == 0
    # the resuming runner's own seed differs: the draws of chunk 2 come
    # from the seed in the file
    r = _torch_runner(d2, seed=5)
    got = r.RunEnsemble(5, chunk=2, npie=2, checkpoint=True)
    assert np.array_equal(got, want)
    for name in os.listdir(d1):
        assert (d1 / name).read_bytes() == (d2 / name).read_bytes(), name
    for name in os.listdir(d2):
        if name.startswith("kappa."):
            os.remove(d2 / name)
    again = r.RunEnsemble(5, chunk=2, npie=2, checkpoint=True)
    assert np.array_equal(again, want)
    assert len([n for n in os.listdir(d2) if n.startswith("kappa.")]) == 10


@pytest.mark.parametrize("change", ["ntraj", "chunk", "nmd", "dt"])
def test_stale_ensemble_checkpoint_raises(tmp_path, change):
    """An MDE.npz of another setup (trajectories, chunk, noise period or
    time step) in the outdir is refused, as the JAX package refuses it."""
    _torch_runner(tmp_path).RunEnsemble(4, chunk=2, npie=2,
                                        checkpoint=True)
    kw = dict(ntraj=4, chunk=2)
    if change in ("ntraj", "chunk"):
        kw[change] = {"ntraj": 6, "chunk": 4}[change]
        r = _torch_runner(tmp_path)
    else:
        nmd, dt = (2 * NMD, DT) if change == "nmd" else (NMD, 0.5 * DT)
        r = TMD.md(dt, nmd, T, axyz=[["C", 1.0 * i, 0.0, 0.0]
                                     for i in range(NAT)],
                   dyn=_dyn(), dtype=torch.float64, outdir=str(tmp_path),
                   device="cpu")
        for Tb, cats in SPECS:
            r.AddBath(TB.phbath(Tb, cats, 0.3, 32, dt, nmd, ml=ML,
                                gamma=GAM, gwl=GWL, dtype=torch.float64,
                                device="cpu"))
    with pytest.raises(ValueError, match="stale checkpoint"):
        r.RunEnsemble(kw["ntraj"], npie=2, checkpoint=True,
                      chunk=kw["chunk"])


def test_resumes_jax_written_checkpoint(tmp_path, monkeypatch):
    """An MDE.npz the JAX package wrote when stopped after the first of
    two segments (its noise injected from numpy in the test, its thermal
    start its own) is resumed by the port: the port runs the second
    segment from the file's state and noise, and the means equal the JAX
    package's uninterrupted call (rtol 1e-9, the two steps' summation
    order)."""
    from sclmd_tpu.parallel import ensemble as JE

    ntraj = 3

    def injected(system, key, n, lo=0, hi=None):
        hi = n if hi is None else hi
        return system.replace(baths=tuple(
            b.replace(noise=jnp.asarray(np.stack([JN.sample_noise_np(
                np.random.default_rng(100 * i + j), b.nevecs, b.nstd, DT,
                NMD) for j in range(lo, hi)])), nevecs=None, nstd=None)
            for i, b in enumerate(system.baths)))

    def jax_runner(outdir):
        r = JMD.md(DT, NMD, T, axyz=[["C", 1.0 * i, 0.0, 0.0]
                                     for i in range(NAT)],
                   dyn=_dyn(), dtype=jnp.float64, outdir=str(outdir),
                   block=16, seed=3)
        for Tb, cats in SPECS:
            r.AddBath(JB.phbath(Tb, cats, 0.3, 32, DT, NMD, ml=ML,
                                gamma=GAM, gwl=GWL, dtype=jnp.float64))
        return r

    monkeypatch.setattr(JE, "ensemble_noise", injected)
    (tmp_path / "whole").mkdir()
    want = jax_runner(tmp_path / "whole").RunEnsemble(
        ntraj, npie=2, checkpoint=True)
    real_savez = np.savez

    def savez_once(*a, **k):
        real_savez(*a, **k)
        raise _Interrupted

    with monkeypatch.context() as m:
        m.setattr(np, "savez", savez_once)
        with pytest.raises(_Interrupted):
            jax_runner(tmp_path).RunEnsemble(ntraj, npie=2, checkpoint=True)
    ck = np.load(tmp_path / "MDE.npz")
    assert "noise_key" in ck and "seed" not in ck
    assert int(ck["ipie"][0]) == 0
    got = _torch_runner(tmp_path).RunEnsemble(ntraj, npie=2,
                                              checkpoint=True)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-14)


def test_run_ensemble_signature_and_check_order(tmp_path):
    """The reference's keywords are all accepted, and ``nsteps % npie``
    raises its ValueError before anything runs or a checkpoint is
    read."""
    import inspect
    want = list(inspect.signature(JMD.md.RunEnsemble).parameters)
    assert list(inspect.signature(TMD.md.RunEnsemble).parameters) == want
    r = _torch_runner(tmp_path)
    with pytest.raises(ValueError, match="not divisible"):
        r.RunEnsemble(2, nsteps=NMD, npie=3, steady_init=True)
    with pytest.raises(ValueError, match="not divisible"):
        r.RunEnsemble(2, nsteps=NMD, npie=3, checkpoint=True)
    means = r.RunEnsemble(2, nsteps=NMD, steady_init=False)
    assert means.shape == (2, len(r.baths)) and np.isfinite(means).all()


@pytest.mark.parametrize("block", [None, 24])
def test_run_ensemble_falls_back_to_plain(tmp_path, block):
    """No block, or one that does not divide nsteps: the plain step runs
    (as the JAX runner falls back to it), and so K1 is never reached."""
    r = _torch_runner(tmp_path)
    r.block = None
    means = r.RunEnsemble(3, nsteps=40, block=block)
    assert means.shape == (3, 2) and np.isfinite(means).all()


def _plain_baths(kind, dtype, pkg):
    """Electron + local baths, or a memory-kernel bath with tails + an
    electron bath, built by the JAX (``pkg`` JB) or the port (TB)."""
    f64 = dtype in (jnp.float64, torch.float64)
    assert f64
    eta = np.eye(NC) / 60.0
    wind = 0.01 * np.random.default_rng(0).normal(size=(2, NC, NC))
    dev = {"device": "cpu"} if pkg is TB else {}
    eb = pkg.ebath(range(NPH - NC, NPH), 270.0, DT, NMD, wmax=1.0,
                   efric=eta, dtype=dtype, **dev)
    if kind == "electron_local":
        return [pkg.ebath(range(NC), 330.0, DT, NMD, wmax=1.0, efric=eta,
                          bias=0.2, exim=wind[0], zeta2=wind[1],
                          dtype=dtype, **dev),
                pkg.phbath(300.0, [4, 6], 0.3, 32, DT, NMD, dtype=dtype,
                           **dev),
                eb]
    return [pkg.phbath(330.0, range(NC), 0.3, 32, DT, NMD, ml=ML,
                       gamma=GAM, gwl=GWL, dtype=dtype, **dev), eb]


@pytest.mark.parametrize("kind", ["electron_local", "memory_electron"])
def test_fused_chunk_plain_matches_jax(kind):
    """block=None: the port's fused_chunk on the plain step equals the
    JAX plain ensemble per trajectory (injected draws, rtol 1e-9)."""
    ntraj, nsteps, skip = 3, 48, 12
    jbaths = _plain_baths(kind, jnp.float64, JB)
    dyn, hw, U = JMD.set_dyn(_dyn(), dtype=jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(5), ntraj)
    us = np.stack([np.asarray(jax.random.uniform(k, (NPH,),
                                                 dtype=jnp.float64))
                   for k in keys])
    seeds = [[50 * i + j for j in range(ntraj)] for i in range(len(jbaths))]
    mask = np.ones(NPH)
    mask[[0, 5]] = 0.0
    ml = max(b.ml for b in jbaths)

    want = []
    for j in range(ntraj):
        bs = tuple(b.replace(noise=jnp.asarray(JN.sample_noise_np(
            np.random.default_rng(seeds[i][j]), b.nevecs, b.nstd, DT, NMD)),
            nevecs=None, nstd=None) for i, b in enumerate(jbaths))
        sys_j = JMD.GLESystem(dyn=dyn, baths=bs, mask=jnp.asarray(mask),
                              dt=DT, nph=NPH, ml=ml, nmd=NMD)
        st = JMD.thermal_init(keys[j], sys_j, hw, U, T)
        _, ys = JMD.run_segment(sys_j, st, nsteps)
        want.append(np.asarray(ys["cur"])[skip:].sum(axis=0))

    r = _torch_runner("unused")
    r.baths, r.ml = _plain_baths(kind, torch.float64, TB), ml
    r.AddConstr([[0, 5]])
    facs = TE.bath_factors(r.baths, "cpu")
    rs = [torch.as_tensor(np.stack([
        np.random.default_rng(s).standard_normal(tuple(std.shape))
        for s in seeds[i]])) for i, (_, std) in enumerate(facs)]
    system = r._build_system()
    finals, sums, ok = TE.fused_chunk(
        system, facs, rs, nsteps, 0, None, skip,
        states=TMD.thermal_init(torch.as_tensor(us), system, r.hw, r.U, T))
    assert bool(ok) and sums.shape == (ntraj, len(jbaths))
    np.testing.assert_allclose(sums.numpy(), np.stack(want), rtol=1e-9,
                               atol=1e-14)
    assert not finals.p[:, [0, 5]].any()


def test_run_ensemble_plain_matches_jax(tmp_path, monkeypatch):
    """The runner itself on the plain path (ragged chunks of 2, the
    equilibration skip, the means and the kappa files) against the JAX
    plain step per trajectory, with the schedule's draws replaced by
    injected numbers."""
    ntraj, nsteps, equil = 3, 40, 0.25
    skip = int(nsteps * equil)
    jbaths = _plain_baths("electron_local", jnp.float64, JB)
    dyn, hw, U = JMD.set_dyn(_dyn(), dtype=jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(9), ntraj)
    us = np.stack([np.asarray(jax.random.uniform(k, (NPH,),
                                                 dtype=jnp.float64))
                   for k in keys])
    seeds = [[70 * i + j for j in range(ntraj)] for i in range(len(jbaths))]
    want = []
    for j in range(ntraj):
        bs = tuple(b.replace(noise=jnp.asarray(JN.sample_noise_np(
            np.random.default_rng(seeds[i][j]), b.nevecs, b.nstd, DT, NMD)),
            nevecs=None, nstd=None) for i, b in enumerate(jbaths))
        sys_j = JMD.GLESystem(dyn=dyn, baths=bs, mask=jnp.ones(NPH), dt=DT,
                              nph=NPH, ml=1, nmd=NMD)
        st = JMD.thermal_init(keys[j], sys_j, hw, U, T)
        _, ys = JMD.run_segment(sys_j, st, nsteps)
        want.append(np.asarray(ys["cur"])[skip:].mean(axis=0))

    def injected(facs, seed, lo, hi, dt, nmd, start, system):
        rs = [torch.as_tensor(np.stack([
            np.random.default_rng(s).standard_normal(tuple(std.shape))
            for s in seeds[i][lo:hi]])) for i, (_, std) in enumerate(facs)]
        amps = K3.amplitudes_of(torch.as_tensor(us[lo:hi]), start.am,
                                start.hw)
        return ([TN.sample_noise_from_r(r, ev, std, dt, nmd)
                 for r, (ev, std) in zip(rs, facs)],
                start.project(amps, system))

    monkeypatch.setattr(TE, "draw_chunk", injected)
    r = _torch_runner(tmp_path)
    r.baths, r.ml, r.block = _plain_baths("electron_local", torch.float64,
                                          TB), 1, None
    means = r.RunEnsemble(ntraj, nsteps=nsteps, equil_frac=equil, chunk=2)
    np.testing.assert_allclose(means, np.stack(want), rtol=1e-9, atol=1e-14)
    row = (tmp_path / "kappa.300.bath2.run1.dat").read_text().split()
    np.testing.assert_allclose(float(row[2]), want[1][2] * 243414.0,
                               rtol=1e-5, atol=1e-6)
