"""The plain step's CUDA graph (``kernels.step_graph``, ``md.graph_plan``)
on the CPU: the group plan, the decision where the graph engages, the
launch counters' accounting around a capture and its replays (with a
stand-in for the CUDA graph), and the step loop. The graphed path itself
runs on the card (``tests/test_torch_kernels_cuda.py``). No JAX."""

import types

import pytest
import torch

from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.kernels import bath_force as K7
from sclmd_tpu_torch.kernels import conv_tails as K6
from sclmd_tpu_torch.kernels import step_graph as SG
from sclmd_tpu_torch.models.harmonic import chain_dynmat
from sclmd_tpu_torch.models.hydrocarbon import CHDriver
from sclmd_tpu_torch.utils import profiling as P

G = SG.GRAPH_STEPS


def test_group_is_even():
    """K7's two-turn buffers come back to their parity after a replay
    only for an even group."""
    assert G >= 2 and G % 2 == 0


@pytest.mark.parametrize("nsteps", [0, 1, 2, G, G + 1, G + 2, 2 * G + 3,
                                    1024, 4096, 4097])
def test_group_plan(nsteps):
    """``LEAD`` eager steps, whole groups replayed, the rest eager; a
    segment without a whole group after its lead runs eagerly."""
    lead, replays, tail = SG.group_plan(nsteps)
    assert lead + replays * G + tail == nsteps
    if nsteps < SG.LEAD + G:
        assert (lead, replays, tail) == (nsteps, 0, 0)
    else:
        assert lead == SG.LEAD and replays == (nsteps - SG.LEAD) // G
        assert 0 <= tail < G


@pytest.mark.parametrize("nsteps,group,plan", [
    (1024, 8, (1, 127, 7)), (1024, 16, (1, 63, 15)), (16, 16, (16, 0, 0)),
    (17, 16, (1, 1, 0)), (4096, 8, (1, 511, 7)), (10, 2, (1, 4, 1))])
def test_group_plan_other_groups(monkeypatch, nsteps, group, plan):
    assert SG.LEAD == 1
    monkeypatch.setattr(SG, "GRAPH_STEPS", group)
    assert SG.group_plan(nsteps) == plan


def test_replayed_share_of_the_benchmark_segments():
    """The benchmark's plain segments (``md.Run``'s 1,024 steps, a
    flagship chunk's 4,096) replay at least 99 % of their steps."""
    for n in (1024, 4096):
        _, replays, _ = SG.group_plan(n)
        assert replays * G >= 0.99 * n


def _system(**kw):
    nph = 6
    return TMD.GLESystem(dyn=chain_dynmat(nph, 0.05), baths=(),
                         mask=torch.ones(nph, dtype=torch.float64),
                         dt=0.4, nph=nph, ml=1, nmd=16, **kw)


def _on(device):
    """A stand-in state whose tensors claim to lie on ``device``."""
    return types.SimpleNamespace(
        p=types.SimpleNamespace(device=torch.device(device)))


class _Marked:
    capturable = True

    def force_torch(self, q):
        return -q


class _Unmarked:
    def force_torch(self, q):
        return -q


@pytest.mark.parametrize("case,engages", [
    ("harmonic", True), ("cpu", False), ("cf_fn", False), ("savef", False),
    ("unmarked driver", False), ("lambda", False), ("marked driver", True),
    ("short", False), ("savep saveq", True)])
def test_graph_plan_engages_where_safe(case, engages):
    """The graph engages on the card for the harmonic GEMM and for a
    driver that declares itself capturable, with ps and qs written by
    K7; never on the CPU, with a compared driver (``cf_fn``), with the
    host's per-step scatter of ``savef``, with a driver that is not
    marked, or for a segment without a whole group."""
    kw, dev, nsteps = {}, "cuda", 4 * G + 3
    if case == "cpu":
        dev = "cpu"
    elif case == "cf_fn":
        kw["cf_fn"] = _Marked().force_torch
    elif case == "savef":
        kw["savef"] = True
    elif case == "unmarked driver":
        kw["force_fn"] = _Unmarked().force_torch
    elif case == "lambda":
        kw["force_fn"] = lambda q: -q
    elif case == "marked driver":
        kw["force_fn"] = _Marked().force_torch
    elif case == "short":
        nsteps = G
    elif case == "savep saveq":
        kw.update(savep=True, saveq=True)
    plan = TMD.graph_plan(_system(**kw), _on(dev), nsteps)
    if engages:
        assert plan == SG.group_plan(nsteps) and plan[1] > 0
    else:
        assert plan == (nsteps, 0, 0)


def test_ch_driver_is_marked_capturable():
    """``CHDriver`` (K5 on the card) is marked; the Tersoff driver is
    not, and keeps the eager step."""
    from sclmd_tpu_torch.models.tersoff import TersoffDriver
    assert CHDriver.capturable is True
    assert not getattr(TersoffDriver, "capturable", False)


def test_sw_driver_is_marked_capturable():
    """``SWDriver`` (K9 on the card: launches into kept scratch, its
    output from the caching allocator, no host sync) is marked, so the
    graph engages for its bound force."""
    from sclmd_tpu_torch.models.sw import SWDriver
    assert SWDriver.capturable is True
    drv = SWDriver.__new__(SWDriver)
    plan = TMD.graph_plan(_system(force_fn=drv.force_torch), _on("cuda"),
                          4 * G + 3)
    assert plan == SG.group_plan(4 * G + 3)


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records the calls."""

    def __init__(self):
        self.calls = []

    def capture_begin(self):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        self.calls.append("replay")


def _fake_step(s):
    """What a step's Python calls add to the launch counters on the
    card: K6 once, K7 three times."""
    K6.launches += 1
    K7.launches += 3


def test_capture_adds_no_launches_and_replays_add_the_groups():
    """The calls made while capturing leave the counters as they were;
    each replay adds the group's launches of each kernel, the word's
    base moves by the group, and ``steps_graphed`` / ``graph_captures``
    count the replayed steps and the capture."""
    word = SG.StepWord("cpu", base=1)
    graph = SG.StepGraph(word, G, graph=_FakeGraph())
    before = P.counters()
    graph.capture(_fake_step, 1)
    mid = P.counters()
    assert mid["launches.K6"] == before["launches.K6"]
    assert mid["launches.K7"] == before["launches.K7"]
    assert mid["graph_captures"] == before["graph_captures"] + 1
    assert graph.nodes == {"launches.K6": G, "launches.K7": 3 * G}
    assert graph.graph.calls == ["begin", "end"]
    # the stand-in ran the word's advance at once; a captured one waits
    # for the replays
    assert int(word.t[0]) == 1 + G and word.base == 1
    graph.replay(5)
    after = P.counters()
    assert graph.graph.calls[2:] == ["replay"] * 5
    assert after["launches.K6"] == before["launches.K6"] + 5 * G
    assert after["launches.K7"] == before["launches.K7"] + 15 * G
    assert after["steps_graphed"] == before["steps_graphed"] + 5 * G
    assert word.base == 1 + 5 * G
    assert word.off(1 + 5 * G + 2) == 2


def test_capture_restores_counters_when_a_step_raises():
    word = SG.StepWord("cpu")
    graph = SG.StepGraph(word, G, graph=_FakeGraph())
    before = P.counters()

    def bad(s):
        _fake_step(s)
        if s == 3:
            raise RuntimeError("refused")

    with pytest.raises(RuntimeError):
        graph.capture(bad, 0)
    assert graph.graph.calls == ["begin", "end"]
    after = P.counters()
    assert after["launches.K7"] == before["launches.K7"]
    assert after["graph_captures"] == before["graph_captures"]


def test_eager_plan_runs_every_step_in_order():
    seen = []
    SG.run_steps(seen.append, 7, (7, 0, 0), None, "cpu")
    assert seen == list(range(7))


def test_step_word_offsets():
    word = SG.StepWord("cpu", base=9)
    assert word.t.dtype == torch.int32 and int(word.t[0]) == 9
    assert [word.off(s) for s in (0, 9, 12)] == [-9, 0, 3]


def test_eam_driver_is_marked_capturable():
    """``EAMDriver`` (K10 on the card, both routes: the same launch into
    kept scratch as K9, its output from the caching allocator, no host
    sync) is marked, so the graph engages for its bound force."""
    from sclmd_tpu_torch.models.eam import EAMDriver
    assert EAMDriver.capturable is True
    drv = EAMDriver.__new__(EAMDriver)
    plan = TMD.graph_plan(_system(force_fn=drv.force_torch), _on("cuda"),
                          4 * G + 3)
    assert plan == SG.group_plan(4 * G + 3)
