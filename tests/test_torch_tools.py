"""The port's measurement tools on the CPU: the primary-junction set-up
that chip_smoke.py and the sweeps share, the kernel's tap-major operand,
and the trace summary of ``tools.profile_e2e``. No JAX."""

import json
import tempfile

import numpy as np
import pytest
import torch

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.kernels import gle_block as K1
from sclmd_tpu_torch.tools import primary as P
from sclmd_tpu_torch.tools import profile_e2e as PE

torch.set_num_threads(2)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 1000), (2000, 3000)], 2.0),
    ([(0, 2000), (1000, 3000)], 3.0),
    ([(0, 3000), (1000, 2000), (2500, 4000)], 4.0),
])
def test_union_ms(intervals, want):
    assert PE._union_ms(intervals) == pytest.approx(want)


def test_summarise_synthetic_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 4000},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 3000, "dur": 2000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "cp", "ts": 8000,
         "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "host:K1_gle_block",
         "ts": 0, "dur": 500},
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": "host:K1_gle_block", "ts": 0, "dur": 4000},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = PE.summarise(str(path), 0.010)
    assert s["device_busy_ms"] == pytest.approx(6.0)
    assert s["idle_share"] == pytest.approx(0.4)
    assert s["spans"]["K1_gle_block"] == {"calls": 1, "host_ms": 0.5,
                                          "device_ms": 4.0}
    assert s["spans"]["kappa_files"]["calls"] == 0
    assert [k["name"] for k in s["top_kernels"]] == ["k1", "k2"]


def test_profile_spans_cover_run_ensemble(tmp_path):
    """Every span of the profile wraps a function that the profiled
    workloads (blocked and plain RunEnsemble, md.Run) really call, and
    the wrappers come off again. The K5/K6/K7 spans wrap the launches,
    which happen only on the card, and so do K1's near- and far-tap
    launches."""
    nmd, dt, nat = 32, 0.4, 4
    gwl = np.linspace(0.0, 0.6, 16)
    gam = np.array([np.eye(3) * 0.02 * np.exp(-(w / 0.3) ** 2)
                    for w in gwl])
    from sclmd_tpu_torch.models.harmonic import chain_dynmat
    r = TMD.md(dt, nmd, 300.0, axyz=[["C", 1.0 * i, 0.0, 0.0]
                                     for i in range(nat)],
               dyn=chain_dynmat(3 * nat, 0.05).numpy(), dtype=torch.float64,
               outdir=str(tmp_path), block=8, device="cpu")
    for Tb, cats in ((330.0, range(3)), (270.0, range(9, 12))):
        r.AddBath(TB.phbath(Tb, cats, 0.3, 32, dt, nmd, ml=9, gamma=gam,
                            gwl=gwl, dtype=torch.float64, device="cpu"))
    before = TMD.md._write_kappa_files, TMD.gle_block
    undo = PE._wrap_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            r.RunEnsemble(3, nsteps=16, block=8)
            r.block = None
            r.RunEnsemble(3, nsteps=16)
            r.npie = 2
            r.Run()
    finally:
        undo()
    assert (TMD.md._write_kappa_files, TMD.gle_block) == before
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = PE.summarise(path, 1.0)["spans"]
    assert set(spans) == set(PE.SPANS)
    card_only = {"K5_ch_force", "K6_conv_tails", "K7_bath_force", "K1_near",
                 "K1_far"}
    assert [k for k, v in spans.items()
            if k not in card_only and not v["calls"]] == []
    assert spans["K1_gle_block"]["calls"] == 2
    assert spans["K2_block_corr"]["calls"] == 4
    # noise synthesis (K3 and the C2R stage on the card): one call per
    # bath for each of the two one-chunk ensembles and for md.Run's one
    # run; the thermal start (K3b) once per ensemble chunk and once for
    # md.Run's start
    assert spans["noise_synth"]["calls"] == 6
    assert spans["noise_synthesis"]["calls"] == 6
    assert spans["noise_c2r"]["calls"] == 6
    assert spans["init_draws"]["calls"] == 3
    assert spans["thermal_init"]["calls"] == 3


@pytest.mark.parametrize("nc,block", [(3, 4), (8, 2), (90, 3)])
def test_tap_major_layout(nc, block):
    kin = torch.randn((nc, (block + 1) * nc), dtype=torch.float64)
    kt = K1.tap_major(kin, block)
    ncs = -(-nc // 4) * 4
    assert kt.shape == (block + 1, ncs, nc)
    for k in range(block + 1):
        assert torch.equal(kt[k, :nc, :], kin[:, k * nc:(k + 1) * nc].T)
    assert not kt[:, nc:, :].any()


def test_primary_block_operands_cpu():
    """The primary junction at its full widths with two trajectories:
    the chunk shapes RunEnsemble runs at 256 and 1024 trajectories under
    the 40 GB budget, and one block of K1's plain twin on the operands
    chip_smoke.py holds the kernel against."""
    r = P.primary_runner(torch.float32, "cpu", tempfile.mkdtemp())
    system = r._build_system()
    assert P.chunk_sizes(system, 256) == [256]
    assert P.chunk_sizes(system, 1024) == [512, 512]
    gen = torch.Generator().manual_seed(1)
    _, args, corr = P.block_operands(r, 2, 7, gen)
    khat, hhat = corr[0]
    assert khat.shape == (1025, P.NC, P.NC) and hhat.shape == (2, 1025, P.NC)
    out = K1.gle_block(*args)
    assert out.cur.shape == (2, P.BLOCK, 2) and out.etot.shape == (2, P.BLOCK)
    for x in (out.p, out.q, out.cur, out.etot):
        assert torch.isfinite(x).all()


def test_flagship_setup_cpu():
    """The harmonic flagship at its full widths: 603 DOFs, two electron
    baths of 150 DOFs at T (1 +- delta/2), 120 fixed DOFs, and the chunk
    shapes of the plain-path RunEnsemble at 128 and 1024 trajectories
    under the 40 GB budget."""
    from sclmd_tpu_torch.tools import flagship as F
    r = F.flagship_runner(torch.float32, "cpu", tempfile.mkdtemp())
    system = r._build_system()
    assert system.nph == 603 and system.ml == 1 and system.nmd == F.NMD
    assert [b.nc for b in r.baths] == [150, 150]
    assert [b.T for b in r.baths] == [315.0, 285.0]
    assert int((system.mask == 0).sum()) == 120
    assert F.chunk_sizes(system, 128) == [128]
    assert F.chunk_sizes(system, 1024) == [1024]
    sw = F.flagship_runner(torch.float32, "cpu", tempfile.mkdtemp(),
                           temps=(285.0, 315.0))
    assert [b.T for b in sw.baths] == [285.0, 315.0]


def test_card_scripts_refuse_without_cuda(monkeypatch):
    """The measurement scripts fail, and do not fall back to the CPU,
    where there is no card."""
    from sclmd_tpu_torch.tools import plain_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        plain_bench.main()
    with pytest.raises(SystemExit, match="CUDA"):
        PE.main(["--out", "unused"])


def test_flagship_bpt_setup_cpu():
    """The flagship's NEGF set-up that chip_smoke phase 20 and
    ``tools.negf_bench`` share: nd 483 after the 120 fixed DOFs, leads of
    150 DOFs, 4,001 points up to 0.45 eV, and the sweep's operation
    count (5.8e8 a point)."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools.negf_bench import negf_flops
    b = F.flagship_bpt("cpu")
    assert b.nd == 483 and b.intnum + 1 == 4001
    assert [len(g) for g in b.dofatomofbath] == [150, 150]
    assert b.maxomega * units.RPC == pytest.approx(0.45)
    assert b._D.device.type == "cpu" and b._D.shape == (483, 483)
    assert negf_flops(483, 150) == pytest.approx(5.804e8, rel=1e-3)


@pytest.mark.parametrize("tool", ["blocked_bench", "k1_sweep",
                                  "negf_bench"])
def test_card_tools_refuse_the_cpu(monkeypatch, tool):
    """The measurement tools time the card and stop without one instead
    of timing the CPU."""
    import importlib
    mod = importlib.import_module(f"sclmd_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        mod.main([])


def test_bias_stability_growth_rate():
    """``tools.bias_stability.growth_rate`` on a 4-atom chain split as the
    flagship is (fixed ends, one lead atom a side, one centre atom): a
    stable chain decays, a negative stiffness in the centre grows, and a
    centre friction damps faster."""
    from sclmd_tpu_torch.models.harmonic import chain_dynmat
    from sclmd_tpu_torch.tools.bias_stability import growth_rate
    dyn = np.asarray(chain_dynmat(15, 0.04))
    part = {"fixdofs": [0, 1, 2, 12, 13, 14], "ecatsl": [3, 4, 5],
            "ecatsr": [9, 10, 11], "device": np.array([2])}
    z = np.zeros((3, 3))
    bare = growth_rate(dyn, part)
    assert bare < 0.0
    # the force bias (xim - zeta1) q: a negative zeta1 softens
    soft = growth_rate(dyn, part, (z, z, -np.eye(3) * 0.2, z), bias=1.0)
    assert soft > 0.0
    damped = growth_rate(dyn, part, (np.eye(3) * 0.05, z, z, z))
    assert damped < bare
