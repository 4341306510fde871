"""The port's tracing (``sclmd_tpu_torch.utils.profiling``) on the CPU:
spans inside ``md.RunEnsemble`` and ``md.Run`` as ``sclmd:`` records of
a ``torch.profiler`` Chrome trace, nested as the runners open them and
around the ATen ops launched inside them; the per-call reports' spans
and counters against what the calls did and wrote; the launch counters'
registry; the reports ring; set-up spans; ``Tracer`` on top of ``span``.
No JAX."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.models.harmonic import chain_dynmat
from sclmd_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

NMD, DT, NAT, NTRAJ, CHUNK, NPIE = 32, 0.4, 4, 4, 2, 2
ENSEMBLE = {"ensemble", "ensemble/start", "ensemble/draw",
            "ensemble/segment", "ensemble/readback", "ensemble/files"}
RUN = {"run", "run/start", "run/segment", "run/readback",
       "run/checkpoint", "run/postrun"}
# each case: (the spans of its call, its entry)
CASES = {"blocked": (ENSEMBLE, "RunEnsemble"),
         "plain": (ENSEMBLE, "RunEnsemble"),
         "checkpoint": (ENSEMBLE | {"ensemble/checkpoint"}, "RunEnsemble"),
         "run": (RUN, "Run")}


def chain_runner(outdir, block=8):
    """A 4-atom chain between two memory-kernel phonon baths."""
    os.makedirs(outdir, exist_ok=True)
    gwl = np.linspace(0.0, 0.6, 16)
    gam = np.array([np.eye(3) * 0.02 * np.exp(-(w / 0.3) ** 2)
                    for w in gwl])
    r = TMD.md(DT, NMD, 300.0, axyz=[["C", 1.0 * i, 0.0, 0.0]
                                     for i in range(NAT)],
               dyn=chain_dynmat(3 * NAT, 0.05).numpy(), dtype=torch.float64,
               outdir=str(outdir), block=block, device="cpu")
    for Tb, cats in ((330.0, range(3)), (270.0, range(9, 12))):
        r.AddBath(TB.phbath(Tb, cats, 0.3, 32, DT, NMD, ml=9, gamma=gam,
                            gwl=gwl, dtype=torch.float64, device="cpu"))
    return r


def case_runner(case, outdir):
    r = chain_runner(outdir, block=8 if case == "blocked" else None)
    if case == "run":
        r.npie = NPIE
        r.CalPowerSpec(True)
        r.CalAveStruct(True)
    return r


def one_call(case, r):
    if case == "run":
        r.Run()
    else:
        r.RunEnsemble(NTRAJ, nsteps=16, chunk=CHUNK, npie=NPIE,
                      checkpoint=case == "checkpoint")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """case -> (the report of its call, its ``sclmd:`` records, its other
    host ops, its output directory), from one profiled call of each."""
    out = {}
    for case in CASES:
        d = tmp_path_factory.mktemp(case)
        r = case_runner(case, d)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            one_call(case, r)
        rep = P.reports()[-1]
        path = str(d / "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        os.remove(path)
        spans, ops = [], []
        for e in events:
            iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            if e["name"].startswith(P.PREFIX):
                spans.append((e["name"][len(P.PREFIX):],) + iv)
            elif e.get("cat") == "cpu_op":
                ops.append((e["name"],) + iv)
        out[case] = rep, spans, ops, d
    return out


def _inside(iv, ivs):
    return any(a <= iv[0] and iv[1] <= b for a, b in ivs)


@pytest.mark.parametrize("case", list(CASES))
def test_trace_holds_the_spans_nested(traced, case):
    """Each expected span is in the Chrome trace as ``sclmd:<span>``, each
    lies inside its parent (``ensemble/draw`` in ``ensemble``), and the
    call's ATen ops lie inside the call's span."""
    want, _ = CASES[case]
    _, spans, ops, _ = traced[case]
    assert {s[0] for s in spans} == want
    by = {}
    for name, a, b in spans:
        by.setdefault(name, []).append((a, b))
    for name, ivs in by.items():
        parent = name.rsplit("/", 1)[0]
        if parent != name and parent in by:
            for iv in ivs:
                assert _inside(iv, by[parent]), name
    top = "run" if case == "run" else "ensemble"
    assert [op for op in ops if op[0].startswith("aten::")
            and not _inside(op[1:], by[top])] == []


@pytest.mark.parametrize("case", list(CASES))
def test_spans_enclose_their_ops(traced, case):
    """The segment, draw and read-back spans hold the ATen ops the step,
    the draws and the read-back launch."""
    _, spans, ops, _ = traced[case]
    top = "run" if case == "run" else "ensemble"
    inner = [f"{top}/segment", f"{top}/readback"] + \
        ([] if case == "run" else ["ensemble/draw"])
    for name in inner:
        for _, a, b in (s for s in spans if s[0] == name):
            assert any(op[0].startswith("aten::") and a <= op[1]
                       and op[2] <= b for op in ops), name


def _sizes(d, pattern):
    return [os.path.getsize(p) for p in glob.glob(os.path.join(d, pattern))]


@pytest.mark.parametrize("case", ["blocked", "plain", "checkpoint"])
def test_ensemble_report_counts(traced, case):
    """Chunks, segments and read-backs as the call ran them; ``steps`` the
    steps enqueued; one file a trajectory and bath (and an MDE.npz a
    segment with checkpoints) and their bytes as on disk; without
    checkpoints the first chunk's files from the writer thread."""
    rep, _, _, d = traced[case]
    nchunk, nb = NTRAJ // CHUNK, 2
    behind = 0 if case == "checkpoint" else nchunk - 1
    assert rep.entry == "RunEnsemble" and rep.wall_s > 0
    assert rep.span_count("ensemble") == 1
    assert rep.span_count("ensemble/start") == 1
    assert rep.span_count("ensemble/draw") == nchunk
    assert rep.span_count("ensemble/segment") == nchunk * NPIE
    assert rep.span_count("ensemble/readback") == nchunk * NPIE
    assert rep.span_count("ensemble/files") == nchunk - behind
    assert rep.span_count("ensemble/files_behind") == behind
    assert rep.counters["files_behind"] == behind * CHUNK * nb
    assert rep.counters["steps"] == nchunk * 16
    assert rep.counters["syncs"] >= 2 * nchunk * NPIE
    kappa = _sizes(d, "kappa.*.dat")
    assert len(kappa) == NTRAJ * nb
    ck = nchunk * NPIE if case == "checkpoint" else 0
    assert rep.span_count("ensemble/checkpoint") == ck
    assert rep.counters["files"] == NTRAJ * nb + ck
    mde = _sizes(d, "MDE.npz")
    assert rep.counters["bytes_written"] == sum(kappa) + ck * sum(mde)
    assert rep.span_s("ensemble/segment") <= rep.span_s("ensemble")


def test_run_report_counts(traced):
    """``md.Run`` of one trajectory in two segments: the start (call and
    trajectory), a segment, read-back and checkpoint each segment, the
    last checkpoint inside ``_postrun``; the files it wrote."""
    rep, _, _, d = traced["run"]
    assert rep.entry == "Run"
    assert rep.span_count("run/start") == 2
    assert rep.span_count("run/segment") == NPIE
    assert rep.span_count("run/readback") == NPIE
    assert rep.span_count("run/checkpoint") == NPIE + 1
    assert rep.span_count("run/postrun") == 1
    assert rep.counters["steps"] == NMD
    text = [p for p in glob.glob(os.path.join(d, "*.dat"))]
    # kappa a bath, the spectrum, the average structure
    assert len(text) == 4
    assert rep.counters["files"] == len(text) + NPIE + 1
    on_disk = sum(os.path.getsize(p) for p in text) + \
        sum(_sizes(d, "MD0.npz"))
    # earlier checkpoints of the run were overwritten by larger ones
    assert on_disk < rep.counters["bytes_written"] < \
        on_disk + NPIE * sum(_sizes(d, "MD0.npz"))


def test_steps_per_segment_not_per_step(tmp_path):
    """Span counts follow segments and chunks, not steps: twice the steps
    give the same spans and twice the ``steps``."""
    reps = []
    for nsteps in (16, 32):
        r = chain_runner(tmp_path / str(nsteps), block=None)
        r.RunEnsemble(NTRAJ, nsteps=nsteps, chunk=CHUNK, npie=NPIE)
        reps.append(P.reports()[-1])
    assert {k: v[0] for k, v in reps[0].spans.items()} == \
        {k: v[0] for k, v in reps[1].spans.items()}
    assert reps[1].counters["steps"] == 2 * reps[0].counters["steps"]


def test_no_record_function_without_profiler(tmp_path, monkeypatch):
    """With no profiler running the spans never build a
    ``record_function`` (which costs time even with the profiler off),
    and still record their host time."""
    def refuse(*a, **k):
        raise AssertionError("record_function without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for case in CASES:
        one_call(case, case_runner(case, tmp_path / case))
        top = "run" if case == "run" else "ensemble"
        nseg = NPIE if case == "run" else NPIE * NTRAJ // CHUNK
        assert P.reports()[-1].span_count(f"{top}/segment") == nseg
    with P.span("outside"):
        pass
    assert P.process_report().span_count("outside") >= 1


def test_span_under_profiler_is_a_record():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("probe/outer"):
            torch.ones(3).sum()
    names = [e.key for e in prof.key_averages()]
    assert "sclmd:probe/outer" in names
    assert P.process_report().span_count("probe/outer") >= 1


REGISTRY = [
    ("launches.K1_near", "gle_block", "launches_near"),
    ("launches.K1_far", "gle_block", "launches_far"),
    ("launches.K2", "block_corr", "launches"),
    ("launches.K3", "noise_synth", "launches"),
    ("launches.K3b", "noise_synth", "launches_init"),
    ("launches.K3_transpose", "noise_synth", "launches_transpose"),
    ("launches.K5", "ch_force", "launches"),
    ("launches.K6", "conv_tails", "launches"),
    ("launches.K7", "bath_force", "launches"),
    ("launches.K7_wide", "bath_force", "launches_wide"),
    ("launches.K8", "ch_force", "launches_tersoff"),
    ("launches.K9", "sw_force", "launches"),
    ("launches.K10", "eam_force", "launches"),
    ("launches.K10_sym", "eam_force", "launches_sym"),
    ("launches.DP_desc", "dp_descriptor", "launches"),
]


@pytest.mark.parametrize("name,module,attr", REGISTRY)
def test_counter_follows_module_global(monkeypatch, name, module, attr):
    """Each kernel module's launch counter, registered at import, reads
    the module's own integer (which the card tests and the benchmark's
    work files read by name); a call's report holds its change."""
    import importlib
    mod = importlib.import_module(f"sclmd_tpu_torch.kernels.{module}")
    before = P.counters()[name]
    assert before == getattr(mod, attr)
    with P.call("probe", "probe"):
        monkeypatch.setattr(mod, attr, getattr(mod, attr) + 3)
    assert P.counters()[name] == before + 3
    assert P.reports()[-1].counters[name] == 3


def test_reports_ring_keeps_64():
    for i in range(P.RING + 6):
        with P.call("probe", "probe"):
            P.count("steps", i)
    reps = P.reports()
    assert len(reps) == P.RING == 64
    assert [r.counters["steps"] for r in reps] == list(range(6, P.RING + 6))


def test_failed_call_leaves_its_report():
    with pytest.raises(RuntimeError):
        with P.call("probe", "probe"):
            with P.span("probe/inner"):
                raise RuntimeError("x")
    rep = P.reports()[-1]
    assert rep.entry == "probe" and rep.span_count("probe/inner") == 1
    json.dumps(rep.to_dict())


def test_setup_spans(tmp_path):
    """Set-up outside a call lands in the process report: the eigh of the
    start, a bath's factorisation, CHDriver's tables."""
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    rep = P.process_report()
    before = {k: rep.span_count(k) for k in
              ("setup/thermal_start", "setup/bath", "setup/driver")}
    chain_runner(tmp_path)
    ring = [["C", 1.39 * np.cos(a), 1.39 * np.sin(a), 0.0]
            for a in np.arange(6) * np.pi / 3]
    ring += [["H", 2.48 * np.cos(a), 2.48 * np.sin(a), 0.0]
             for a in np.arange(6) * np.pi / 3]
    CHDriver(ring, device="cpu")
    after = {k: rep.span_count(k) for k in before}
    assert after["setup/thermal_start"] == before["setup/thermal_start"] + 1
    assert after["setup/bath"] == before["setup/bath"] + 2
    assert after["setup/driver"] == before["setup/driver"] + 1


def test_tracer_sections_are_spans():
    """``Tracer`` keeps its own stats and is a span of each section's
    path, inside the open report and, under a profiler, in the trace."""
    tr = P.Tracer()
    synced = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.call("probe", "probe"):
            with tr.section("outer"):
                with tr.section("inner", sync=lambda: synced.append(1)):
                    pass
    assert synced == [1]
    assert tr.stats["outer/inner"][0] == 1
    rep = P.reports()[-1]
    assert rep.span_count("outer") == rep.span_count("outer/inner") == 1
    assert rep.span_s("outer/inner") == tr.stats["outer/inner"][1]
    assert "sclmd:outer/inner" in [e.key for e in prof.key_averages()]


def test_record_function_only_in_profiling():
    """The port opens profiler records in one place only."""
    import sclmd_tpu_torch
    root = os.path.dirname(sclmd_tpu_torch.__file__)
    hits = [os.path.relpath(p, root) for p in
            glob.glob(os.path.join(root, "**", "*.py"), recursive=True)
            if "record_function" in open(p).read()]
    assert hits == [os.path.join("utils", "profiling.py")]
