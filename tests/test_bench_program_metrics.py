"""The benchmark's per-layer metrics that read the program's own spans
and counters (``benchmarks/metrics/{launches_per_step,readback_ms,
checkpoint_ms,start_ms,kappa_behind_share}.*.py`` through
``benchmarks/reports.py``): each
reads a traced CPU run of its cell at a cut size, and gives nothing
where the program keeps no reports, too few, or another entry's. No
JAX."""

import tempfile
import types

import pytest

from benchmarks import reports, run, spec
from benchmarks.tests.conftest import SEED, cut
from sclmd_tpu_torch.utils import profiling

PROGRAM = {"launches_per_step.ens", "launches_per_step.run",
           "readback_ms.ens", "readback_ms.run", "checkpoint_ms.run",
           "start_ms.run"}
PAIRS = [(m["name"], w) for m in spec.benchmark()["per_layer"]
         if m["name"] in PROGRAM for w in m["workloads"]]


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """cell -> the result of one traced cut run, made when first asked,
    under a temporary directory of its own (an ensemble cell writes into
    a fixed directory of the temporary directory)."""
    cache = {}

    def get(name):
        if name not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tempfile, "tempdir",
                           str(tmp_path_factory.mktemp("tmp")))
                cache[name] = run.run_cell(cut(spec.Cell(name)), SEED, 0.0,
                                           True, "cpu")
        return cache[name]
    return get


def test_every_program_metric_is_declared():
    assert {m for m, _ in PAIRS} == PROGRAM
    for name in PROGRAM:
        entry = [m for m in spec.benchmark()["per_layer"]
                 if m["name"] == name][0]
        mod = spec.load_file(f"{spec.HERE}/metrics/{name}.py", name)
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == \
            (entry["unit"], entry["layer"], entry["moves"])
        assert mod.SPANS == {}


@pytest.mark.parametrize("metric,cell", PAIRS)
def test_metric_reads_a_traced_run(traced_runs, metric, cell):
    """A positive value, except the launches a step, which a CPU trace
    cannot give (no device kernels): left out of the line."""
    res = traced_runs(cell)
    assert res["correct"], res["check"]
    got = res["metrics"].get(metric)
    if metric.startswith("launches_per_step"):
        assert got is None
    else:
        assert got is not None and got["value"] > 0, res["metrics"]


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_count(self, names):
        assert names == ("",)
        return self.kernels


def _view(calls, kernels=0):
    return types.SimpleNamespace(calls=calls, trace=_Trace(kernels))


def test_launches_per_step_counts_the_window():
    for steps in (100, 300):
        with profiling.call("RunEnsemble", "ensemble"):
            profiling.count("steps", steps)
    assert reports.launches_per_step(_view(2, kernels=2000),
                                     "RunEnsemble") == 5.0
    assert reports.launches_per_step(_view(2, kernels=0),
                                     "RunEnsemble") is None


def test_span_ms_per_call_and_per_trajectory():
    for _ in range(3):
        with profiling.call("Run", "run"):
            for name in ("run/readback", "run/readback", "run/postrun"):
                with profiling.span(name):
                    pass
    reps = profiling.reports()[-3:]
    total = 1e3 * sum(r.span_s("run/readback") for r in reps)
    assert reports.span_ms(_view(3), "Run", "run/readback") == \
        pytest.approx(total / 3)
    assert reports.span_ms(_view(3), "Run", "run/readback",
                           per="run/postrun") == pytest.approx(total / 3)
    assert reports.span_ms(_view(3), "Run", "run/checkpoint") is None


def test_window_refuses_another_entry_or_too_few():
    with profiling.call("Run", "run"):
        pass
    assert reports.window(_view(1), "RunEnsemble") is None
    assert reports.window(_view(1), "Run") is not None
    assert reports.window(_view(profiling.RING + 1), "Run") is None


def test_window_without_program_reports(monkeypatch):
    """A program older than its reports (the parent of this reader) gives
    nothing and raises nothing."""
    monkeypatch.delattr(profiling, "reports")
    assert reports.window(_view(1), "Run") is None
    assert reports.launches_per_step(_view(1, kernels=10), "Run") is None


BEHIND = "kappa_behind_share.ens"


def _behind():
    entry = [m for m in spec.benchmark()["per_layer"]
             if m["name"] == BEHIND][0]
    return entry, spec.load_file(f"{spec.HERE}/metrics/{BEHIND}.py", BEHIND)


def test_kappa_behind_share_reads_the_counters():
    """``files_behind`` over ``files`` across the window's calls, in %;
    None where a report lacks the counter (a tree older than the
    writer thread)."""
    entry, mod = _behind()
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == \
        (entry["unit"], entry["layer"], entry["moves"])
    assert mod.SPANS == {}
    for behind in (1024, 0):
        with profiling.call("RunEnsemble", "ensemble"):
            profiling.count("files", 2048)
            profiling.count("files_behind", behind)
    assert mod.read(_view(2)) == 25.0
    assert mod.read(_view(1)) == 0.0
    del profiling.reports()[-1].counters["files_behind"]
    assert mod.read(_view(2)) is None


@pytest.mark.parametrize("cell", _behind()[0]["workloads"])
def test_kappa_behind_share_of_a_one_chunk_run(traced_runs, cell):
    """Each cell's cut run is one chunk of four trajectories, whose files
    the calling thread writes: the share reads 0."""
    res = traced_runs(cell)
    assert res["metrics"][BEHIND] == {"value": 0.0, "unit": "%"}
