"""The port's ``md.Run`` runner: the counterparts of tests/test_md.py's
``TestWrapper``, ``TestFailureDetection`` and ``TestStaleCheckpoint``,
and resume across packages.

A cross-package resume starts from one ``MD0.npz`` written at segment 1
of 4 (by either package) and finishes it once with the JAX runner and
once with the port's, in CPU float64: the checkpoint carries the state
and the noise, so both finals agree to float64 rounding (rtol 1e-9).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu import md as JMD
from sclmd_tpu.models.harmonic import chain_dynmat as j_chain_dynmat

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.models.harmonic import chain_dynmat

torch.set_num_threads(2)

NAT = 4
AXYZ = [["C", 1.0 * i, 0.0, 0.0] for i in range(NAT)]


def _build(tmpdir, nmd=64, npie=1, seed=7, nstop=1, jax=False):
    """tests/test_md.py's TestWrapper junction (4-atom chain, one
    electron bath on DOFs 0-2, DOFs 9-11 fixed), in either package."""
    dyn = np.asarray(j_chain_dynmat(3 * NAT, 0.05))
    eta = np.eye(3) / 80.0
    if jax:
        r = JMD.md(0.4, nmd, 300.0, axyz=AXYZ, dyn=dyn, nstart=0,
                   nstop=nstop, npie=npie, dtype=jnp.float64, seed=seed,
                   outdir=str(tmpdir))
        r.AddBath(JB.ebath(range(3), 300.0, 0.4, nmd, wmax=1.0, efric=eta,
                           dtype=jnp.float64))
    else:
        r = TMD.md(0.4, nmd, 300.0, axyz=AXYZ, dyn=dyn, nstart=0,
                   nstop=nstop, npie=npie, dtype=torch.float64, seed=seed,
                   outdir=str(tmpdir), device="cpu")
        r.AddBath(TB.ebath(range(3), 300.0, 0.4, nmd, wmax=1.0, efric=eta,
                           dtype=torch.float64, device="cpu"))
    r.AddConstr([range(9, 12)])
    return r


def test_run_writes_kappa(tmp_path):
    _build(tmp_path).Run()
    files = list(tmp_path.glob("kappa.300.bath0.run0.dat"))
    assert len(files) == 1
    row = files[0].read_text().split()
    assert int(row[0]) == 0 and float(row[1]) == 300.0
    ck = np.load(tmp_path / "MD0.npz")
    assert int(ck["ipie"][0]) == 0 and int(ck["t"][0]) == 64
    assert ck["etot"].shape == (64,) and ck["cur"].shape == (64, 1)


def test_checkpoint_keys_match_jax(tmp_path):
    """Same MD0.npz keys, shapes and dtypes as the JAX runner."""
    dj, dt_ = tmp_path / "jax", tmp_path / "torch"
    dj.mkdir()
    dt_.mkdir()
    for d, jax in ((dj, True), (dt_, False)):
        r = _build(d, jax=jax)
        r.CalPowerSpec()
        r.Run()
    cj, ct = np.load(dj / "MD0.npz"), np.load(dt_ / "MD0.npz")
    assert sorted(cj.files) == sorted(ct.files)
    for k in cj.files:
        assert cj[k].shape == ct[k].shape and cj[k].dtype == ct[k].dtype, k
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt_))


def test_resume_matches_uninterrupted(tmp_path):
    d1, d2 = tmp_path / "full", tmp_path / "interrupted"
    d1.mkdir()
    d2.mkdir()
    _build(d1, npie=4, seed=3).Run()
    ck1 = np.load(d1 / "MD0.npz")

    # interrupted run: two segments of four, then a fresh runner resumes
    r2 = _build(d2, npie=4, seed=3)
    system = r2._build_system()
    seed = r2._next_seed()
    state = r2.initialise(system, seed)
    r2._draw_noise(seed, 0)
    system = r2._build_system()
    for i in range(2):
        state, _ = TMD.run_segment(system, state, 16, t0=16 * i)
    r2.dump(state, 1, 0)
    _build(d2, npie=4, seed=3).Run()
    ck2 = np.load(d2 / "MD0.npz")
    np.testing.assert_allclose(ck1["p"], ck2["p"], rtol=1e-10)
    np.testing.assert_allclose(ck1["q"], ck2["q"], rtol=1e-10)
    assert int(ck2["ipie"][0]) == 3 and int(ck2["t"][0]) == 64


def test_constraint_holds(tmp_path):
    r = _build(tmp_path)
    r.Run()
    assert not r.state.q[0, 9:12].any() and not r.state.p[0, 9:12].any()
    assert r.energy(r.state) > 0.0


def test_traj_and_power_outputs(tmp_path):
    r = _build(tmp_path)
    r.CalPowerSpec()
    r.CalAveStruct()
    r.AddPowerSection([[0, 1, 2], [3, 4, 5]])
    r.SaveTraj(16)
    r.Run()
    assert (tmp_path / "power.300.run0.dat").exists()
    for layer in (0, 1):
        assert (tmp_path / f"poweratomlist.{layer}.300.run0.dat").exists()
    assert r.GetPower().shape == (64, 2)
    traj = (tmp_path / "trajectories.300.run0.ani").read_text().splitlines()
    assert traj[0].strip() == "4" and len(traj) == 4 * (2 + NAT)
    ave = (tmp_path / "avestructure.300.run0.dat").read_text().splitlines()
    assert ave[0] == "4" and len(ave) == 2 + NAT


def test_runs_chain_skip_and_remove(tmp_path):
    """Run 1 chains from MD0.npz; a second Run skips both finished runs;
    RemoveNC deletes MD{j-1} after run j."""
    r = _build(tmp_path, nstop=2)
    r.Run()
    ck0, ck1 = np.load(tmp_path / "MD0.npz"), np.load(tmp_path / "MD1.npz")
    assert int(ck1["t"][0]) == 128 and int(ck0["t"][0]) == 64
    assert not np.array_equal(ck0["noise0"], ck1["noise0"])
    r2 = _build(tmp_path, nstop=2)
    r2.Run()
    assert int(r2.t) == 128
    np.testing.assert_array_equal(np.load(tmp_path / "MD1.npz")["p"],
                                  ck1["p"])
    os.remove(tmp_path / "MD1.npz")
    r3 = _build(tmp_path, nstop=2)
    r3.RemoveNC()
    r3.Run()
    assert not (tmp_path / "MD0.npz").exists()
    np.testing.assert_allclose(np.load(tmp_path / "MD1.npz")["p"], ck1["p"],
                               rtol=1e-12)


def test_missing_previous_checkpoint_raises(tmp_path):
    """A run after the first with neither its own nor the previous
    checkpoint refuses to start from scratch."""
    class Forgetful(TMD.md):
        def _postrun(self, j, state, outputs):
            super()._postrun(j, state, outputs)
            os.remove(self._ckfile(j))

    dyn = chain_dynmat(3 * NAT, 0.05).numpy()
    r = Forgetful(0.4, 64, 300.0, axyz=AXYZ, dyn=dyn, nstop=2,
                  dtype=torch.float64, outdir=str(tmp_path), device="cpu")
    r.AddBath(TB.ebath(range(3), 300.0, 0.4, 64, wmax=1.0,
                       efric=np.eye(3) / 80.0, dtype=torch.float64,
                       device="cpu"))
    with pytest.raises(FileNotFoundError, match="no previous checkpoint"):
        r.Run()


def test_divergence_raises_with_context(tmp_path):
    """An unstable run (dt far beyond the stiff chain's Verlet limit)
    aborts with a FloatingPointError naming the step and an honest
    last-good-checkpoint pointer instead of writing non-finite output."""
    r = TMD.md(4.0, 256, 300.0, axyz=[["C", 1.0 * i, 0.0, 0.0]
                                      for i in range(2)],
               dyn=chain_dynmat(6, 5.0).numpy(), nstop=1,
               dtype=torch.float64, outdir=str(tmp_path), device="cpu")
    r.AddBath(TB.ebath(range(3), 300.0, 4.0, 256, wmax=1.0,
                       efric=np.eye(3) * 0.01, dtype=torch.float64,
                       device="cpu"))
    with pytest.raises(FloatingPointError, match="non-finite") as ei:
        r.Run()
    assert "none (run diverged" in str(ei.value)
    assert not (tmp_path / "MD0.npz").exists()


def test_mismatched_checkpoint_rejected(tmp_path):
    _build(tmp_path).Run()
    nat = 6
    r2 = TMD.md(0.4, 64, 300.0, axyz=[["C", 1.0 * i, 0.0, 0.0]
                                      for i in range(nat)],
                dyn=chain_dynmat(3 * nat, 0.05).numpy(), nstop=1,
                dtype=torch.float64, outdir=str(tmp_path), device="cpu")
    r2.AddBath(TB.ebath(range(3), 300.0, 0.4, 64, wmax=1.0,
                        efric=np.eye(3) / 80.0, dtype=torch.float64,
                        device="cpu"))
    with pytest.raises(ValueError, match="stale checkpoint"):
        r2.Run()


def test_mismatched_nmd_rejected(tmp_path):
    _build(tmp_path, nmd=64).Run()
    with pytest.raises(ValueError, match="stale checkpoint"):
        _build(tmp_path, nmd=128).Run()


# --- resume across packages -------------------------------------------------
def _interrupted(d, writer):
    """MD0.npz at ipie 1 of npie 4 written by ``writer`` ("jax" or
    "torch"), with the outputs of its two segments."""
    r = _build(d, npie=4, seed=3, jax=writer == "jax")
    r.CalPowerSpec()
    r.CalAveStruct()
    system = r._build_system()
    if writer == "jax":
        state = r.initialise(system)
        for i in range(len(r.baths)):
            r.baths[i] = r.baths[i].gnoi(r._next_key())
        run, t = JMD.run_segment, None
    else:
        seed = r._next_seed()
        state = r.initialise(system, seed)
        r._draw_noise(seed, 0)
        run = TMD.run_segment
    system = r._build_system()
    outs = []
    for i in range(2):
        state, ys = run(system, state, 16, t0=16 * i)
        outs.append({k: np.asarray(v)[0] if writer == "torch"
                     else np.asarray(v) for k, v in ys.items()
                     if v is not None})
    r.dump(state, 1, 0, outputs={k: np.concatenate([o[k] for o in outs])
                                 for k in ("etot", "cur", "ps", "qs")})


def _numbers(path):
    return np.array([float(x) for x in path.read_text().split()
                     if x.replace(".", "").replace("-", "").replace(
                         "e", "").isdigit()])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_resume(tmp_path, writer):
    src, dj, dt_ = tmp_path / "src", tmp_path / "jax", tmp_path / "torch"
    for d in (src, dj, dt_):
        d.mkdir()
    _interrupted(src, writer)
    for d, jax in ((dj, True), (dt_, False)):
        shutil.copy(src / "MD0.npz", d / "MD0.npz")
        r = _build(d, npie=4, seed=99, jax=jax)
        r.CalPowerSpec()
        r.CalAveStruct()
        r.SaveTraj(8)
        r.Run()
    cj, ct = np.load(dj / "MD0.npz"), np.load(dt_ / "MD0.npz")
    assert sorted(cj.files) == sorted(ct.files)
    assert int(ct["ipie"][0]) == 3 and int(ct["t"][0]) == 64
    for k in ("p", "q", "phis", "qhis", "etot", "cur", "ps", "qs", "power",
              "noise0"):
        np.testing.assert_allclose(ct[k], cj[k], rtol=1e-9, atol=1e-12,
                                   err_msg=k)
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt_))
    for name in names:
        if name.endswith((".dat", ".ani")):
            np.testing.assert_allclose(_numbers(dt_ / name),
                                       _numbers(dj / name), rtol=1e-6,
                                       atol=2e-6, err_msg=name)


def test_partition_by_axis_matches_jax():
    from sclmd_tpu.utils.junction import partition_by_axis as jpart

    from sclmd_tpu_torch.tools.flagship import flagship_junction
    from sclmd_tpu_torch.utils.junction import partition_by_axis
    axyz, part, dyn = flagship_junction()
    want = jpart(axyz)
    assert set(part) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(part[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert (len(part["ecatsl"]), len(part["ecatsr"]),
            len(part["fixdofs"])) == (150, 150, 120)
    assert dyn.shape == (603, 603)
    rng = np.random.default_rng(0)
    small = [["C", *rng.normal(size=3)] for _ in range(30)]
    for axis in (0, 2):
        got, ref = partition_by_axis(small, axis=axis), jpart(small,
                                                               axis=axis)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(ref[k]))
    with pytest.raises(ValueError, match="no device"):
        partition_by_axis(small[:8])


def test_reset_savepq_is_a_no_op_as_in_jax(tmp_path):
    r, j = _build(tmp_path), _build(tmp_path, jax=True)
    assert r.ResetSavepq() is None and j.ResetSavepq() is None


def test_get_atommass_matches_jax(tmp_path):
    r, j = _build(tmp_path), _build(tmp_path, jax=True)
    r.els = j.els = ["C", "H", "Au", "Si"]
    assert r.get_atommass() == j.get_atommass() == r.mass
    assert r.mass[0] == pytest.approx(12.011, abs=0.01)


def test_apply_constraint_matches_jax():
    f = np.arange(12.0) - 4.5
    for constr in (None, [[0, 1, 2]], [range(9, 12), [4]]):
        got, want = TMD.ApplyConstraint(f, constr), \
            JMD.ApplyConstraint(f, constr)
        assert np.array_equal(got, want)
    assert not TMD.ApplyConstraint(f, [[0]])[0] and f[0] == -4.5


def test_sameq_matches_jax():
    q = np.linspace(0.0, 1.0, 6)
    for other in (q.copy(), q + 5e-10, q + 2e-9, q[:5]):
        assert TMD.sameq(q, other) == JMD.sameq(q, other)
    assert TMD.sameq(q, q + 5e-10) and not TMD.sameq(q, q[:5])
