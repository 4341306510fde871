"""The plain step's launches replayed as a CUDA graph (``md.run_segment``).

A plain GLE step launches K6 once, K7 three times and the potential
force twice (``torch.mm`` for a harmonic system, K5 twice for a
``CHDriver``, K9 twice for an ``SWDriver``). The card's work is short
(about 52 us a step at one primary trajectory) and the host's Python per
launch is long (about 100 to 160 us a step on the H100's host), so
launched one by one the card waits on the host. Here a segment captures
``GRAPH_STEPS`` steps once as a CUDA graph and replays it; every kernel
in it stays the hand-written one.

The step index lives on the card (``StepWord``): K6 and K7 read one
int32 word and add the launch's own offset, and derive from that step
the noise rows, the history ring's head and push rows and the rows of
the per-step outputs (``cur``, ``etot``, ``ps``, ``qs``). An eager
launch passes ``s - base``; a captured one keeps its offset inside the
group, and one add after the group's steps moves the word by the group
length at every replay. Eager and graphed steps run the same kernels
with the same arguments, so they give the same bits.

What makes a replay repeatable: K7 returns its own output buffers, two a
stage used in turn, and with an even group length a replay ends on the
buffers it started from; the potential force's tensors come from the
graph's private pool and live within a step. The first ``LEAD`` steps
of a segment run eagerly on the capture stream before the capture, the
groups are replayed on the caller's stream, and the steps after the last
whole group run eagerly. The graph and its pool are dropped when the
segment returns.

Launch counters count kernel executions: the calls made while capturing
add nothing, and each replay adds the group's launches of each kernel.
``steps_graphed`` counts the steps run by replay and ``graph_captures``
the captures (``utils.profiling``).
"""

from __future__ import annotations

import torch

from sclmd_tpu_torch.utils import profiling

# Steps a graph holds. Even, so that K7's two-turn output buffers come
# back to the same parity after every replay. A segment's host time is
# about (LEAD + GRAPH_STEPS + its remainder) eager steps for the lead, the
# capture and the tail, plus a few microseconds a replay, against
# GRAPH_STEPS steps of card time a replay. On an H100 (700 W; a sweep of
# the group length, three segments each, two calls; CHANGES.md) the
# primary chain's 1,024-step segment at one trajectory took
# 4.9-8.5 ms of host time and 60.3-61.7 ms of wall time at 8 steps,
# against 58-77 ms of both eagerly; 4 steps read the same within the
# spread (5.8-7.8 and 59.9-62.0), 16 the same in one call and 9.6-89 ms
# of host time in the other, 32 and 64 9.6-24 ms and 63.5-73. The many-body
# flagship's 1,024 steps at 1,024 trajectories took 129.6-131.5 ms at 8
# (one sample 149.2), 132.5-135.1 eagerly. At 8 the eager lead and tail
# are at most 8 steps of a segment.
GRAPH_STEPS = 8
if GRAPH_STEPS < 2 or GRAPH_STEPS % 2:
    raise ValueError(f"step_graph: a group of {GRAPH_STEPS} steps; it must "
                     "be even and at least 2")

# Eager steps before the capture, on the capture stream: they make the
# stream's cuBLAS workspace and whatever a driver makes at its first call,
# and leave the state in K7's own buffers
LEAD = 1

_streams = {}


class StepWord:
    """The segment's step index on the card, read by K6 and K7: a launch
    for step ``s`` passes ``off(s)`` and the kernel takes ``word + off``.
    ``base`` is the value the word will hold when the next eager launch
    runs; a replay moves both the word and, through ``StepGraph``,
    ``base``."""

    def __init__(self, device, base: int = 0):
        self.base = int(base)
        self.t = torch.full((1,), self.base, dtype=torch.int32,
                            device=device)

    @property
    def ptr(self) -> int:
        return self.t.data_ptr()

    def off(self, s: int) -> int:
        return int(s) - self.base


def group_plan(nsteps: int) -> tuple:
    """(lead, replays, tail) of a graphed segment of ``nsteps`` steps:
    ``lead`` eager steps before the capture, ``replays`` replays of a
    group of ``GRAPH_STEPS`` steps, ``tail`` eager steps after them;
    (nsteps, 0, 0) where no whole group follows the lead steps."""
    replays = max(int(nsteps) - LEAD, 0) // GRAPH_STEPS
    if not replays:
        return int(nsteps), 0, 0
    return LEAD, replays, int(nsteps) - LEAD - replays * GRAPH_STEPS


class StepGraph:
    """``steps`` steps captured once with the word's advance, replayed.
    ``graph`` stands in for ``torch.cuda.CUDAGraph`` (tests)."""

    def __init__(self, word: StepWord, steps: int, graph=None):
        self.word, self.steps = word, steps
        self.graph = torch.cuda.CUDAGraph() if graph is None else graph
        self.nodes = {}

    def capture(self, step, s0: int):
        """Capture ``step(s0)`` .. ``step(s0 + steps - 1)`` and the
        word's advance by ``steps`` on the current stream; the launch
        counters are left as they were, and ``nodes`` holds what the
        group adds to each."""
        before = profiling.launch_counts()
        self.graph.capture_begin()
        try:
            for k in range(self.steps):
                step(s0 + k)
            self.word.t.add_(self.steps)
        finally:
            self.graph.capture_end()
            after = profiling.launch_counts()
            profiling.set_launch_counts(before)
        self.nodes = {k: v - before[k] for k, v in after.items()
                      if v != before[k]}
        profiling.count("graph_captures")

    def replay(self, n: int):
        """``n`` replays on the current stream."""
        for _ in range(n):
            self.graph.replay()
        now = profiling.launch_counts()
        profiling.set_launch_counts({k: now[k] + n * d
                                     for k, d in self.nodes.items()})
        self.word.base += n * self.steps
        profiling.count("steps_graphed", n * self.steps)


def _capture_stream(device) -> torch.cuda.Stream:
    key = torch.device(device).index or 0
    if key not in _streams:
        _streams[key] = torch.cuda.Stream(device)
    return _streams[key]


def run_steps(step, nsteps: int, plan: tuple, word: StepWord, device):
    """``step(s)`` for s in range(nsteps), by ``plan`` (``group_plan``,
    or (nsteps, 0, 0): all eager). ``word.base`` must be the plan's
    lead."""
    lead, replays, _ = plan
    if not replays:
        for s in range(nsteps):
            step(s)
        return
    if word.base != lead:
        raise ValueError("step_graph: the word must hold the first graphed "
                         "step")
    main = torch.cuda.current_stream(device)
    side = _capture_stream(device)
    side.wait_stream(main)
    graph = StepGraph(word, (nsteps - lead - plan[2]) // replays)
    with torch.cuda.stream(side):
        for s in range(lead):
            step(s)
        graph.capture(step, lead)
    main.wait_stream(side)
    graph.replay(replays)
    for s in range(lead + replays * graph.steps, nsteps):
        step(s)
