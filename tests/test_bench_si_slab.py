"""The benchmark's silicon slab (``benchmarks/configs/si_slab*``) on the
CPU: the plain reference's Stillinger-Weber force against the program's
float64 twin, the configuration's runner cut to a small slab and held
correct through the harness, K9's work count against a direct count of
the slab's terms, and the driver's set-up span read by its metric. No
JAX."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from benchmarks import peaks, run, spec
from benchmarks.configs import si_slab as SI
from benchmarks.configs import si_slab_reference as REF
from benchmarks.reference import gle
from benchmarks.tests.conftest import SEED, cut
from benchmarks.traffic import Traffic

F64 = gle.Prec("float64")
CELL = "si_slab.ens64"
SMALL = [2, 2, 2]


def _cfg(cells=SMALL):
    with open(os.path.join(spec.HERE, "configs", "si_slab.json")) as f:
        cfg = json.load(f)
    cfg["cells"] = list(cells)
    return cfg


def _driver(cfg, dtype=torch.float64):
    from sclmd_tpu_torch.models.sw import SWDriver
    axyz, cell = SI.geometry(cfg)
    nb = cfg["neighbours"]
    return SWDriver(axyz, cell=cell, max_nnei=nb["slots"],
                    cutoff_skin=nb["skin"], dtype=dtype,
                    params=dict(cfg["sw"]), device="cpu")


def _displaced(sysr, ntraj, rms, seed):
    """q of displacements ``rms`` angstrom per coordinate."""
    rng = np.random.default_rng(seed)
    conv = REF.MD2ANG / np.sqrt(_cfg()["mass"])
    return torch.as_tensor(rms * rng.standard_normal((ntraj, sysr.nph))
                           / conv)


def test_the_published_set_is_run():
    from sclmd_tpu_torch.models.sw import SW_PARAMS
    assert _cfg()["sw"] == SW_PARAMS["Si"]


@pytest.mark.parametrize("rms", [0.02, 0.08])
def test_reference_force_matches_the_driver(rms):
    """Random displacements of the 64-atom periodic slab, small and large
    enough to pull second neighbours inside the cutoff (and first ones
    towards it): the reference's force by autograd of its own energy
    against the driver's float64 twin, and zero at the reference
    geometry."""
    cfg = _cfg()
    sysr = REF.system(cfg, nmd=64)
    q = _displaced(sysr, 3, rms, seed=int(rms * 100))
    got = sysr.force(q, F64)
    want = _driver(cfg).force_torch(q)
    assert float((got - want).abs().max()) <= \
        1e-12 * float(want.abs().max())
    assert float(sysr.force(torch.zeros_like(q[:1]), F64).abs().max()) == 0


def test_displacements_cross_the_cutoff():
    """The larger displacements above take second neighbours (3.84
    angstrom, outside a sigma = 3.77) inside the cutoff: the skin's
    entries are live in that test."""
    cfg = _cfg()
    sysr = REF.system(cfg, nmd=64)
    axyz, cell = SI.geometry(cfg)
    x0 = np.array([a[1:] for a in axyz])
    q = _displaced(sysr, 3, 0.08, seed=8).numpy()
    conv = REF.MD2ANG / np.sqrt(cfg["mass"])
    x = x0[None] + (conv * q).reshape(3, -1, 3)
    d = x[:, None] - x[:, :, None]
    d -= cell * np.round(d / cell)
    r = np.linalg.norm(d, axis=-1)
    d0 = x0[None] - x0[:, None]
    r0 = np.linalg.norm(d0 - cell * np.round(d0 / cell), axis=-1)
    rc = cfg["sw"]["a"] * cfg["sw"]["sigma"]
    second = (r0 > rc) & (r0 < rc + cfg["neighbours"]["skin"])
    assert second.any() and (r[:, second] < rc).any()


def test_rest_start_and_markovian_baths():
    """The reference starts at rest without an (nph, nph) array, and its
    baths are one-matrix (Markovian) baths with the friction sclmd's
    ``phbath`` gives at ml 1: (2/pi) wl[-1] mean Gamma = 0.01 * 2 *
    0.5625 / pi here."""
    cfg = _cfg()
    sysr = REF.system(cfg, nmd=64)
    assert sysr.modes.strides == (0, 0) and not sysr.hw.any()
    q, p = gle.thermal_start(sysr, [(SEED, 0), (SEED, 3)], F64, "cpu")
    assert not q.any() and not p.any()
    nb = 3 * 8 * 2 * 2
    for b, cids in zip(sysr.baths, SI.partition(cfg)):
        assert b.kernel is None and b.nc == nb == len(cids)
        assert np.array_equal(b.cids, cids)
        np.testing.assert_allclose(
            b.efric, 0.01 * 2 * 0.5625 / np.pi * np.identity(nb),
            rtol=1e-15)


def test_the_program_bath_friction_is_the_reference_one():
    """The builder's ``phbath`` at ml 1 carries the reference's friction
    as its one kernel matrix."""
    cfg = _cfg()
    r = SI.build(cfg, "cpu", torch.float64, SEED, "unused")
    sysr = REF.system(cfg, nmd=cfg["nmd"])
    assert len(r.baths) == len(sysr.baths) == 2
    for b, rb in zip(r.baths, sysr.baths):
        assert b.ml == 1
        np.testing.assert_allclose(b.kernel[0].numpy(), rb.efric,
                                   rtol=1e-14, atol=0)


def _direct_counts(cfg):
    """Pairs inside the cutoff and ordered angular terms of the slab,
    by minimum image over every pair of atoms."""
    axyz, cell = SI.geometry(cfg)
    x0 = np.array([a[1:] for a in axyz])
    d = x0[None] - x0[:, None]
    r = np.linalg.norm(d - cell * np.round(d / cell), axis=-1)
    np.fill_diagonal(r, np.inf)
    rc = cfg["sw"]["a"] * cfg["sw"]["sigma"]
    k = (r < rc).sum(1)
    reach = (r < rc + cfg["neighbours"]["skin"]).sum(1)
    return dict(atoms=len(x0), entries=int(np.minimum(
        reach, cfg["neighbours"]["slots"]).sum()), pairs=int(k.sum()),
        triples=int((k * (k - 1)).sum()))


@pytest.mark.parametrize("cells", [SMALL, [3, 2, 2]])
def test_k9_work_count_is_the_slab_terms(cells):
    """The reference's counts are the slab's terms counted directly; the
    work file's operations a trajectory equal the program's own count
    (``kernels.sw_force.work_counts``); a call counts two evaluations a
    step."""
    from sclmd_tpu_torch.kernels import sw_force
    cfg = _cfg(cells)
    sysr = REF.system(cfg, nmd=64)
    counts = sysr.potential["counts"]
    assert counts == _direct_counts(cfg)
    K9 = spec.work("K9")
    drv = _driver(cfg, torch.float32)
    mine = sw_force.work_counts(sw_force.pack_operands(
        drv.kernel.terms, drv.xyz, drv.conv))
    assert K9.per_trajectory(counts)["f32"] == mine["ops"]
    assert K9.table_bytes(counts) == mine["table_bytes"]
    mix = {"entry": "RunEnsemble", "ntraj": 4, "nsteps": 64, "block": None,
           "rate": "traj_steps_per_s", "check": {"sample": 2}}
    shape = Traffic(mix, cfg).shape(sysr)
    w = K9.per_call(shape)
    assert w["f32"] == 2 * 64 * 4 * mine["ops"]
    assert spec.work("K5").per_call(shape) is None
    assert spec.work("potential").per_call(shape) is None
    assert K9.per_call(dict(shape, potential=dict(kind="ch"))) is None


def test_k9_bound_at_the_full_slab():
    """The kernel table's bound of K9 at 64 slab trajectories: 2.6e8
    operations, 0.00384 ms an evaluation; the counts of the 3,456-atom
    slab (16 entries, 4 pairs and 12 angular terms a centre)."""
    cfg = _cfg([12, 6, 6])
    counts = REF.SWModel(
        np.array([a[1:] for a in SI.geometry(cfg)[0]]), SI.geometry(cfg)[1],
        cfg["sw"], cfg["neighbours"]["slots"],
        cfg["neighbours"]["skin"]).counts
    assert counts == dict(atoms=3456, entries=16 * 3456, pairs=4 * 3456,
                          triples=12 * 3456)
    w = spec.work("K9").per_trajectory(counts)
    one = {"f32": 64 * w["f32"], "bytes": 64 * w["bytes"]}
    assert one["f32"] == pytest.approx(2.6e8, rel=1e-2)
    assert 1e3 * peaks.least_seconds(one) == pytest.approx(0.00384,
                                                           rel=2e-3)


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    """trace -> one run of the cell cut to the 64-atom slab and four
    trajectories, under a temporary directory of its own."""
    cache = {}

    def get(trace):
        if trace not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tempfile, "tempdir",
                           str(tmp_path_factory.mktemp("tmp")))
                cell = cut(spec.Cell(CELL))
                cell.cfg["cells"] = SMALL
                cache[trace] = run.run_cell(cell, SEED, 0.0, trace, "cpu")
        return cache[trace]
    return get


@pytest.mark.parametrize("trace", [False, True])
def test_cut_cell_runs_correct(small_runs, trace):
    res = small_runs(trace)
    assert res["correct"], res["check"]
    assert res["failed"] == 0
    assert set(res["check"]) == {"early_gap", "means_gap", "kappa_gap",
                                 "missing"}


def test_driver_setup_ms_reads_a_traced_run(small_runs):
    """The set-up span of ``SWDriver`` is read by ``driver_setup_ms``
    (the process report holds every driver this process built)."""
    from sclmd_tpu_torch.utils import profiling
    res = small_runs(True)
    got = res["metrics"].get("driver_setup_ms")
    assert got is not None and got["value"] > 0 and got["unit"] == "ms"
    assert profiling.process_report().span_count("setup/driver") >= 1


def test_the_slab_cell_reads_its_metrics():
    """The slab's cell lists K9's roofline and not the step's share of
    the peak (whose work list leaves K9 out), nor K5's."""
    names = {m["name"] for m in spec.Cell(CELL).per_layer}
    assert {"K9_roofline", "K7_roofline", "K3_roofline",
            "driver_setup_ms"} <= names
    assert not names & {"step_mfu.ens", "K5_roofline"}
    mod = spec.load_file(os.path.join(spec.HERE, "metrics",
                                      "K9_roofline.py"), "K9_roofline")
    K9 = spec.work(mod.WORK)
    assert len(K9.COUNTERS) == len(K9.KERNELS)
