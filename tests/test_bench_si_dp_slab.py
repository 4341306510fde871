"""The benchmark's DeepPot-SE silicon slab (``benchmarks/configs/
si_dp_slab*``) on the CPU: DeePMD-kit's published widths as the runner
builds them, the plain reference's force against the program's float64
driver, the harness's weights, the network's work count against the
model's layer shapes, the configuration's runner cut to a small slab and
held correct through the harness (and not correct without its network),
and the cell's metrics. No JAX."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from benchmarks import peaks, run, spec
from benchmarks.configs import si_dp_slab as DPS
from benchmarks.configs import si_dp_slab_reference as REF
from benchmarks.configs import si_slab as SI
from benchmarks.reference import gle
from benchmarks.tests.conftest import SEED, cut
from benchmarks.traffic import Traffic

F64 = gle.Prec("float64")
CELL = "si_dp_slab.ens4"
# the smallest periodic slab whose half period (8.1 angstrom) exceeds the
# network's cutoff and skin (6.5): one image a pair
SMALL = [3, 3, 3]


def _cfg(cells=SMALL, seed=SEED):
    with open(os.path.join(spec.HERE, "configs", "si_dp_slab.json")) as f:
        cfg = json.load(f)
    cfg["cells"] = list(cells)
    cfg["deeppot"]["weights_seed"] = seed
    return cfg


@pytest.fixture(scope="module")
def small_runner():
    """The builder's runner of the cut slab in float64 on the CPU and the
    reference system of the same configuration."""
    cfg = _cfg()
    r = DPS.build(cfg, "cpu", torch.float64, SEED, "unused")
    return cfg, r, REF.system(cfg, nmd=64)


def test_the_published_widths_are_run(small_runner):
    """DeePMD-kit's se_e2_a settings (rcut 6.0, rcut_smth 0.5, embedding
    25-50-100, axis 16, fitting 240-240-240) on one type, over the SW
    set and slab of ``si_slab``; the runner's driver is the overlay of the
    network on ``SWDriver``, its table 48 wide (46 neighbours in five
    shells), and the builder records the run's seed."""
    from sclmd_tpu_torch.models.nnp import deepmddriver
    from sclmd_tpu_torch.models.sw import SW_PARAMS, SWDriver
    cfg, r, _ = small_runner
    dp = cfg["deeppot"]
    assert (dp["rcut"], dp["rcut_smth"], dp["neuron"], dp["axis_neuron"],
            dp["fitting_neuron"]) == (6.0, 0.5, [25, 50, 100], 16,
                                      [240, 240, 240])
    assert dp["type_map"] == ["Si"] and dp["weights_seed"] == SEED
    with open(os.path.join(spec.HERE, "configs", "si_slab.json")) as f:
        si = json.load(f)
    for k in ("sw", "neighbours", "wideband_baths", "a0", "mass", "dt",
              "nmd", "T", "delta", "natoms", "nph", "dtype"):
        assert cfg[k] == si[k], k
    assert cfg["sw"] == SW_PARAMS["Si"]
    drv = r.pforce
    assert isinstance(drv, deepmddriver)
    assert isinstance(drv.baseline, SWDriver)
    m = drv.model
    assert (m.embed_sizes, m.fit_sizes, m.naxis, m.rcut, m.rcut_smth) == \
        ((25, 50, 100), (240, 240, 240), 16, 6.0, 0.5)
    assert m.nbr.shape == (216, 48) and int(m.nmask.sum(1).max()) == 46
    assert m.params["fit"][0][0][0].shape == (1600, 240)


def test_reference_force_matches_the_driver(small_runner):
    """Random displacements of the 216-atom slab: the reference's force
    by autograd of its own SW and network energies against the program's
    float64 driver (the network's autograd plus the SW twin), and zero at
    the reference geometry. Both sum the same terms in float64, in other
    orders: 1e-10 of the largest."""
    _, r, sysr = small_runner
    rng = np.random.default_rng(1)
    conv = REF.MD2ANG / np.sqrt(28.0855)
    q = torch.as_tensor(0.06 * rng.standard_normal((3, sysr.nph)) / conv)
    got = sysr.force(q, F64)
    want = r.pforce.force_torch(q)
    assert float((got - want).abs().max()) <= \
        1e-10 * float(want.abs().max())
    assert float(sysr.force(torch.zeros_like(q[:1]), F64).abs().max()) == 0
    # the network's share of the force: the weights' scaling makes it
    # count
    net = r.pforce._net.force_torch(q)
    assert float(net.norm()) > 0.02 * float(want.norm())


def test_weights_are_the_seeds():
    """The harness's weights: float32 numbers, the same for one seed and
    other for another, the output layer scaled so that the network's
    force is a tenth of the SW force's RMS on the probe."""
    cfg = _cfg()
    a, b = REF.weights(cfg), REF.weights(cfg)
    c = REF.weights(_cfg(seed=SEED + 1))
    for (w1, b1), (w2, b2) in zip(a[0] + a[1], b[0] + b[1]):
        assert np.array_equal(w1, w2) and np.array_equal(b1, b2)
        assert np.array_equal(w1, w1.astype(np.float32))
    assert not np.array_equal(a[1][0][0], c[1][0][0])
    sw, net = REF.probe_forces(cfg, a)
    assert net / sw == pytest.approx(cfg["deeppot"]["force_share"], rel=1e-5)
    assert cfg["deeppot"]["force_share"] == 0.1


def test_the_reference_takes_tf32_products():
    """Under the control's precision every product of the network rounds
    its operands to TF32: the energy moves by about TF32's rounding, and
    its gradient stays finite."""
    cfg = _cfg()
    axyz, cell = SI.geometry(cfg)
    x0 = np.array([s[1:] for s in axyz])
    model = REF.DeepPotModel(x0, cell, cfg["deeppot"])
    nets = REF.weights(cfg)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(x0 + 0.05 * rng.standard_normal(x0.shape),
                        dtype=torch.float32)[None].requires_grad_(True)
    net = [[(torch.as_tensor(w, dtype=torch.float32),
             torch.as_tensor(bb, dtype=torch.float32)) for w, bb in n]
           for n in nets]
    e32 = model.energy(x, net, gle.Prec("float32"))
    etf = model.energy(x, net, gle.Prec("tf32"))
    g, = torch.autograd.grad(etf.sum(), x)
    assert bool(torch.isfinite(g).all())
    rel = float((etf - e32).abs().detach() / e32.abs().detach())
    assert 1e-6 < rel < 1e-2


def _layer_ops(model):
    """The products of one evaluation counted from the program's own
    weights: every embedding layer on each entry inside the cutoff and
    every fitting layer on each atom, forward and to its input; G and D
    forward and to both factors."""
    nemb, naxis = model.embed_sizes[-1], model.naxis
    emb = sum(2 * int(np.prod(w.shape)) for w, _ in model.params["embed"][0])
    fit = sum(2 * int(np.prod(w.shape)) for w, _ in model.params["fit"][0])
    return emb, fit, 2 * nemb * 4, 2 * nemb * naxis * 4


@pytest.mark.parametrize("cells", [SMALL, [4, 3, 3]])
def test_dp_work_count_is_the_model_shapes(cells):
    """The reference's counts are the slab's entries inside the cutoff
    and its atoms; the work file's operations equal those of the
    program's layers (``_layer_ops``), its weight bytes their float32
    size; a call counts two evaluations a step; K9's work is the SW
    term's, and no other force's work is counted."""
    cfg = _cfg(cells)
    sysr = REF.system(cfg, nmd=64)
    pot = sysr.potential
    c = pot["dp"]
    na = cfg["cells"][0] * cfg["cells"][1] * cfg["cells"][2] * 8
    assert (c["atoms"], c["slots"], c["inside"]) == (na, 48, 46 * na)
    r = DPS.build(cfg, "cpu", torch.float32, SEED, "unused")
    emb, fit, g, d = _layer_ops(r.pforce.model)
    DP = spec.work("DP")
    assert DP.per_trajectory(c)["f32"] == 2 * emb * c["inside"] \
        + 3 * g * c["inside"] + (2 * fit + 3 * d) * na
    nw = sum(t.numel() for t in (x for n in ("embed", "fit")
                                 for w, b in r.pforce.model.params[n][0]
                                 for x in (w, b)))
    assert DP.weight_bytes(c) == 4 * nw
    mix = {"entry": "RunEnsemble", "ntraj": 4, "nsteps": 64, "block": None,
           "rate": "traj_steps_per_s", "check": {"sample": 2}}
    shape = Traffic(mix, cfg).shape(sysr)
    w = DP.per_call(shape)
    one = DP.per_trajectory(c)
    assert w["f32"] == 2 * 64 * 4 * one["f32"]
    assert w["bytes"] == 2 * 64 * (4 * one["bytes"] + DP.weight_bytes(c))
    K9 = spec.work("K9")
    assert K9.per_call(shape)["f32"] == \
        2 * 64 * 4 * K9.per_trajectory(pot["counts"])["f32"]
    for other in ("K5", "K10", "potential"):
        assert spec.work(other).per_call(shape) is None
    assert DP.per_call(dict(shape, potential=dict(kind="sw"))) is None


def test_dp_bound_at_the_full_slab():
    """The network's work at the whole slab: 46 neighbours in a row of 48
    slots, 11.41 GFLOP a trajectory and evaluation (the fitting net 6.90
    of it, the embedding 3.99), so 1.395 s of float32 peak a call of four
    trajectories and 1,024 steps: compute-bound."""
    cfg = _cfg([12, 6, 6])
    axyz, cell = SI.geometry(cfg)
    c = REF.DeepPotModel(np.array([a[1:] for a in axyz]), cell,
                         cfg["deeppot"]).counts
    assert (c["atoms"], c["slots"], c["inside"]) == (3456, 48, 46 * 3456)
    w = spec.work("DP").per_trajectory(c)
    assert w["f32"] == pytest.approx(11.41e9, rel=1e-3)
    call = {"f32": w["f32"] * 4 * 2 * 1024,
            "bytes": (4 * w["bytes"] + spec.work("DP").weight_bytes(c))
            * 2 * 1024}
    assert peaks.least_seconds(call) == pytest.approx(1.395, rel=1e-3)
    assert call["f32"] / peaks.F32 > call["bytes"] / peaks.HBM


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    """trace -> one run of the cell cut to the 216-atom slab and four
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


def test_a_run_without_its_network_is_not_correct(tmp_path, monkeypatch):
    """The network's share of the force is large enough for the check to
    see it: the program's runs with the SW force alone fail
    ``early_gap``."""
    from sclmd_tpu_torch.models import nnp
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(nnp.deepmddriver, "force_torch",
                        lambda self, q: self.baseline.force_torch(q))
    cell = cut(spec.Cell(CELL))
    cell.cfg["cells"] = SMALL
    res = run.run_cell(cell, SEED, 0.0, False, "cpu")
    assert not res["correct"]
    assert res["check"]["early_gap"]["value"] > \
        10 * res["check"]["early_gap"]["limit"]


def test_driver_setup_ms_reads_a_traced_run(small_runs):
    """The set-up spans of ``SWDriver`` and ``deepmddriver`` are read by
    ``driver_setup_ms``."""
    from sclmd_tpu_torch.utils import profiling
    res = small_runs(True)
    got = res["metrics"].get("driver_setup_ms")
    assert got is not None and got["value"] > 0 and got["unit"] == "ms"
    assert profiling.process_report().span_count("setup/driver") >= 2


def test_the_cell_reads_its_metrics():
    """The cell lists the network's roofline beside the SW kernel's, the
    baths' and the draws', and not the step's share of the peak (whose
    work list has neither K9 nor the network); its end-to-end metrics are
    the rate and the set-up."""
    names = {m["name"] for m in spec.Cell(CELL).per_layer}
    assert {"DP_roofline", "K9_roofline", "K7_roofline", "K3_roofline",
            "driver_setup_ms", "graphed_share.ens",
            "idle_share.ens"} <= names
    assert not names & {"step_mfu.ens", "K5_roofline", "K10_roofline"}
    assert {m["name"] for m in spec.Cell(CELL).end_to_end} == \
        {"traj_steps_per_s", "setup_s"}
    mod = spec.load_file(os.path.join(spec.HERE, "metrics",
                                      "DP_roofline.py"), "DP_roofline")
    assert mod.WORK == "DP" and mod.MOVES == "traj_steps_per_s"


def test_the_cell_is_one_chunk_of_four():
    """``si_dp_slab.ens4``: one chunk of four trajectories over the
    configuration's 1,024 steps on the plain path, two of them replayed
    by the reference, on one chip."""
    cell = spec.Cell(CELL)
    t = Traffic(cell.mix, cell.cfg)
    assert (t.ntraj, t.nsteps, t.block, t.sample) == (4, 1024, None, 2)
    assert cell.entry["chips"] == 1


def _trace(tmp_path, kernels):
    """A Chrome trace of one traced call holding ``kernels``: (name,
    start us, end us)."""
    from benchmarks.trace import Trace
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench:call",
               "ts": 0.0, "dur": 1000.0}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a,
                "args": {}} for n, a, b in kernels]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(path))


def test_dp_roofline_reads_every_kernel_but_the_hand_kernels(tmp_path):
    """The network's device time is the window's kernels but those other
    work files name (here K9's and K7's): its least time over that, in
    %; nothing where the activation kernels' count differs from the
    program's or no evaluation ran."""
    mod = spec.load_file(os.path.join(spec.HERE, "metrics",
                                      "DP_roofline.py"), "DP_roofline")
    assert {"sw_centre_kernel", "bath_force_kernel"} <= mod.others()
    tr = _trace(tmp_path, [
        ("void at::native::tanh_kernel_cuda(float)", 0, 100),
        ("sm80_xmma_gemm_f32f32", 100, 300),
        ("void at::native::tanh_backward_kernel_cuda(float)", 250, 400),
        ("void sw_centre_kernel<false>(SwArgs)", 400, 900),
        ("bath_force_kernel_wide(BwArgs)", 900, 950)])
    c = REF.DeepPotModel(*(lambda a: (np.array([s[1:] for s in a[0]]),
                                      a[1]))(SI.geometry(_cfg())),
                         _cfg()["deeppot"]).counts
    shape = dict(block=None, ntraj=4, nsteps=8,
                 potential=dict(kind="sw", dp=c))
    least = peaks.least_seconds(spec.work("DP").per_call(shape))
    view = run.View(tr, shape, None, 1, {"DP": True})
    assert mod.read(view) == pytest.approx(100 * least / 400e-6, rel=1e-9)
    assert mod.read(run.View(tr, shape, None, 1, {"DP": False})) is None
    bare = _trace(tmp_path, [("sm80_xmma_gemm_f32f32", 0, 300)])
    assert mod.read(run.View(bare, shape, None, 1, {"DP": True})) is None
