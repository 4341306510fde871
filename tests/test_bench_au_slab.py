"""The benchmark's gold slab (``benchmarks/configs/au_slab*``) on the CPU:
the plain reference's Sutton-Chen force against the program's float64
twin, the configuration's runner cut to a small slab and held correct
through the harness, K10's work count against a direct count of the
slab's terms, and the driver's set-up span read by its metric. No JAX."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from benchmarks import peaks, run, spec
from benchmarks.configs import au_slab as AU
from benchmarks.configs import au_slab_reference as REF
from benchmarks.reference import gle
from benchmarks.tests.conftest import SEED, cut
from benchmarks.traffic import Traffic

F64 = gle.Prec("float64")
CELL = "au_slab.ens64"
# the smallest periodic slab whose half cell (2 a0 = 8.16 angstrom) is
# wider than the cutoff and the skin (7.236): one image a pair
SMALL = [4, 4, 4]


def _cfg(cells=SMALL):
    with open(os.path.join(spec.HERE, "configs", "au_slab.json")) as f:
        cfg = json.load(f)
    cfg["cells"] = list(cells)
    return cfg


def _driver(cfg, dtype=torch.float64):
    from sclmd_tpu_torch.models.eam import EAMDriver
    axyz, cell = AU.geometry(cfg)
    sc = cfg["sutton_chen"]
    return EAMDriver(axyz, cell=cell, cutoff_skin=cfg["neighbours"]["skin"],
                     params={k: sc[k] for k in AU.SC_KEYS}, rcut=sc["rcut"],
                     dtype=dtype, device="cpu")


def _displaced(sysr, ntraj, rms, seed):
    """q of displacements ``rms`` angstrom per coordinate."""
    rng = np.random.default_rng(seed)
    conv = REF.MD2ANG / np.sqrt(_cfg()["mass"])
    return torch.as_tensor(rms * rng.standard_normal((ntraj, sysr.nph))
                           / conv)


def test_the_published_set_is_run():
    """The Au set of Sutton and Chen as the port holds it, its cutoff 1.7
    a, the port's mass of gold and the driver's switch width."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.models.eam import SUTTON_CHEN_PARAMS
    cfg = _cfg()
    sc = cfg["sutton_chen"]
    assert {k: sc[k] for k in AU.SC_KEYS} == SUTTON_CHEN_PARAMS["Au"]
    assert sc["rcut"] == pytest.approx(1.7 * sc["a"], rel=1e-15)
    assert cfg["a0"] == sc["a"] and cfg["element"] == "Au"
    assert cfg["mass"] == units.AtomicMassTable["Au"]
    terms = _driver(cfg).energy_fn.terms
    assert terms["rcut"] - terms["r_on"] == sc["switch_width"]
    nx, ny, nz = _cfg([12, 6, 6])["cells"]
    assert 4 * nx * ny * nz == cfg["natoms"] and 3 * cfg["natoms"] == \
        cfg["nph"]


def test_the_builder_refuses_another_switch():
    cfg = _cfg()
    cfg["sutton_chen"]["switch_width"] = 0.4
    with pytest.raises(ValueError, match="switches"):
        AU.build(cfg, "cpu", torch.float64, SEED, "unused")


@pytest.mark.parametrize("rms", [0.02, 0.08])
def test_reference_force_matches_the_driver(rms):
    """Random displacements of the 256-atom periodic slab, small and large
    enough to move entries across the switch's ends: the reference's
    force by autograd of its own energy against the driver's float64
    twin, and zero at the reference geometry."""
    cfg = _cfg()
    sysr = REF.system(cfg, nmd=64)
    q = _displaced(sysr, 3, rms, seed=int(rms * 100))
    got = sysr.force(q, F64)
    want = _driver(cfg).force_torch(q)
    assert float((got - want).abs().max()) <= \
        1e-12 * float(want.abs().max())
    assert float(sysr.force(torch.zeros_like(q[:1]), F64).abs().max()) == 0


def test_displacements_cross_the_switch():
    """The larger displacements above take entries of the skin's shell
    (sqrt 3 a = 7.07 angstrom) inside the cutoff (6.936) and entries of
    the shell at 6.45 across the switch's start (6.436): both ends of
    the switch are crossed in that test."""
    cfg = _cfg()
    sysr = REF.system(cfg, nmd=64)
    axyz, cell = AU.geometry(cfg)
    x0 = np.array([a[1:] for a in axyz])
    q = _displaced(sysr, 3, 0.08, seed=8).numpy()
    conv = REF.MD2ANG / np.sqrt(cfg["mass"])
    x = x0[None] + (conv * q).reshape(3, -1, 3)
    d = x[:, None] - x[:, :, None]
    d -= cell * np.round(d / cell)
    r = np.linalg.norm(d, axis=-1)
    d0 = x0[None] - x0[:, None]
    r0 = np.linalg.norm(d0 - cell * np.round(d0 / cell), axis=-1)
    sc = cfg["sutton_chen"]
    rc, r_on = sc["rcut"], sc["rcut"] - sc["switch_width"]
    skin = (r0 > rc) & (r0 < rc + cfg["neighbours"]["skin"])
    assert skin.any() and (r[:, skin] < rc).any()
    fifth = (r0 > r_on) & (r0 < rc)
    assert fifth.any() and (r[:, fifth] < r_on).any()


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
    nb = 3 * 4 * 4 * 4
    for b, cids in zip(sysr.baths, AU.partition(cfg)):
        assert b.kernel is None and b.nc == nb == len(cids)
        assert np.array_equal(b.cids, cids)
        np.testing.assert_allclose(
            b.efric, 0.01 * 2 * 0.5625 / np.pi * np.identity(nb),
            rtol=1e-15)


def test_the_program_bath_friction_is_the_reference_one():
    """The builder's ``phbath`` at ml 1 carries the reference's friction
    as its one kernel matrix, at the reference's temperatures."""
    cfg = _cfg()
    r = AU.build(cfg, "cpu", torch.float64, SEED, "unused")
    sysr = REF.system(cfg, nmd=cfg["nmd"])
    assert len(r.baths) == len(sysr.baths) == 2
    for b, rb in zip(r.baths, sysr.baths):
        assert b.ml == 1 and b.T == rb.T
        np.testing.assert_allclose(b.kernel[0].numpy(), rb.efric,
                                   rtol=1e-14, atol=0)


def _direct_counts(cfg):
    """Entries within the cutoff plus the skin and inside the cutoff of
    the slab, by minimum image over every pair of atoms."""
    axyz, cell = AU.geometry(cfg)
    x0 = np.array([a[1:] for a in axyz])
    d = x0[None] - x0[:, None]
    r = np.linalg.norm(d - cell * np.round(d / cell), axis=-1)
    np.fill_diagonal(r, np.inf)
    rc = cfg["sutton_chen"]["rcut"]
    return dict(atoms=len(x0),
                entries=int((r < rc + cfg["neighbours"]["skin"]).sum()),
                inside=int((r < rc).sum()))


@pytest.mark.parametrize("cells", [SMALL, [5, 4, 4]])
def test_k10_work_count_is_the_slab_terms(cells):
    """The reference's counts are the slab's terms counted directly; the
    work file's operations and table bytes equal the program's own count
    (``kernels.eam_force.work_counts``); a call counts two evaluations a
    step, and no other force's work."""
    from sclmd_tpu_torch.kernels import eam_force
    cfg = _cfg(cells)
    sysr = REF.system(cfg, nmd=64)
    counts = sysr.potential["counts"]
    assert counts == _direct_counts(cfg)
    K10 = spec.work("K10")
    drv = _driver(cfg, torch.float32)
    mine = eam_force.work_counts(eam_force.pack_operands(
        drv.kernel.terms, drv.xyz, drv.conv))
    assert (mine["slots"], mine["inside"]) == (counts["entries"],
                                               counts["inside"])
    assert K10.per_trajectory(counts)["f32"] == mine["ops"]
    assert K10.per_trajectory(counts)["bytes"] == mine["bytes"]
    assert K10.table_bytes(counts) == mine["table_bytes"]
    mix = {"entry": "RunEnsemble", "ntraj": 4, "nsteps": 64, "block": None,
           "rate": "traj_steps_per_s", "check": {"sample": 2}}
    shape = Traffic(mix, cfg).shape(sysr)
    w = K10.per_call(shape)
    assert w["f32"] == 2 * 64 * 4 * mine["ops"]
    assert w["bytes"] == 2 * 64 * (4 * mine["bytes"] + mine["table_bytes"])
    for other in ("K5", "K9", "potential"):
        assert spec.work(other).per_call(shape) is None
    assert K10.per_call(dict(shape, potential=dict(kind="sw"))) is None


def test_k10_bound_at_the_full_slab():
    """The kernel table's bound of K10 at 64 slab trajectories: 8.0e8
    operations, 0.0120 ms an evaluation; the counts of the 1,728-atom
    slab (86 entries a centre, 78 of them inside the cutoff: the fcc
    shells of 12, 6, 24, 12, 24 and, in the skin, 8)."""
    cfg = _cfg([12, 6, 6])
    axyz, cell = AU.geometry(cfg)
    counts = REF.SuttonChenModel(
        np.array([a[1:] for a in axyz]), cell, cfg["sutton_chen"],
        cfg["neighbours"]["skin"]).counts
    assert counts == dict(atoms=1728, entries=86 * 1728, inside=78 * 1728)
    w = spec.work("K10").per_trajectory(counts)
    one = {"f32": 64 * w["f32"], "bytes": 64 * w["bytes"]}
    assert one["f32"] == pytest.approx(8.0e8, rel=1e-2)
    assert 1e3 * peaks.least_seconds(one) == pytest.approx(0.0120,
                                                           rel=1e-3)


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    """trace -> one run of the cell cut to the 256-atom slab and four
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
    """The set-up span of ``EAMDriver`` is read by ``driver_setup_ms``
    (the process report holds every driver this process built)."""
    from sclmd_tpu_torch.utils import profiling
    res = small_runs(True)
    got = res["metrics"].get("driver_setup_ms")
    assert got is not None and got["value"] > 0 and got["unit"] == "ms"
    assert profiling.process_report().span_count("setup/driver") >= 1


def test_the_slab_cell_reads_its_metrics():
    """The gold slab's cell lists K10's roofline and not the step's share
    of the peak (whose work list leaves K10 out), nor K5's or K9's."""
    names = {m["name"] for m in spec.Cell(CELL).per_layer}
    assert {"K10_roofline", "K7_roofline", "K3_roofline", "driver_setup_ms",
            "graphed_share.ens", "idle_share.ens"} <= names
    assert not names & {"step_mfu.ens", "K5_roofline", "K9_roofline"}
    mod = spec.load_file(os.path.join(spec.HERE, "metrics",
                                      "K10_roofline.py"), "K10_roofline")
    K10 = spec.work(mod.WORK)
    assert len(K10.COUNTERS) == len(K10.KERNELS)
    assert {m["name"] for m in spec.Cell(CELL).end_to_end} == \
        {"traj_steps_per_s", "setup_s"}
