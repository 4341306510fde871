"""Tracing and profiling of the port (counterpart of
``sclmd_tpu.utils.profiling``): one system of spans, counters and
per-call reports, with the section ``Tracer``, ``device_trace``, the
operation count of ``compiled_cost`` and the GLE step's cost model on
top of it.

Spans. ``span(name)`` times a block on the host clock
(``time.perf_counter_ns``) into the open report. Only while a
``torch.profiler`` session runs does it also open
``torch.profiler.record_function("sclmd:" + name)``, so the program's
spans lie in the profiler's Chrome trace on the clock of the device's
kernels, and an idle gap of the card can be put down to the span open
on the host. With no profiler a span costs one flag check and two clock
reads. Spans mark layer boundaries (a call, a chunk, a segment, a
read-back, a batch of files, a checkpoint), never a step:

    ensemble             md.RunEnsemble, the whole call
    ensemble/start       the system, seed, thermal start, factors,
                         the MDE.npz load
    ensemble/draw        a chunk's noise and start (draw_chunk)
    ensemble/segment     a chunk's segment enqueued (fused_chunk)
    ensemble/readback    the host's wait for a segment's sums and flag
    ensemble/files       a chunk's kappa files
    ensemble/files_behind
                         a chunk's kappa files written on the writer
                         thread while the next chunk runs (timed there,
                         added by the calling thread: ``add_span``)
    ensemble/checkpoint  an MDE.npz write
    run                  md.Run, the whole call
    run/start            system, seed, initialise, checkpoint probing,
                         the run's noise
    run/segment          a segment (run_segment or run_segment_blocked)
    run/readback         the segment's outputs copied to the host and
                         the finite checks
    run/checkpoint       an MD{j}.npz write (dump)
    run/traj             the .ani frames of a segment
    run/postrun          _postrun: spectra, kappa and structure files,
                         the last checkpoint
    setup/library        loading (or building) the kernel library
    setup/bath           a bath's PSD factorisation
    setup/driver         a driver's tables and kernel pack (CHDriver,
                         SWDriver, EAMDriver), or deepmddriver's
                         forces at q = 0
    setup/thermal_start  the eigh of the dynamical matrix (set_dyn)

Counters. ``counters()`` reads them all: the program's own, added with
``count`` (``steps``: the steps enqueued, a segment's at once, summed
over chunks; ``syncs``: the runners' reads of device values, each
``md._host`` copy and finite flag; ``files`` and
``bytes_written``: kappa, power and structure files and the MD{j}.npz /
MDE.npz checkpoints; ``files_behind``: the kappa files of those
``files`` that ``RunEnsemble``'s writer thread wrote;
``library_builds``: compilations of the kernel library;
``steps_graphed``: plain steps run by replaying a CUDA graph,
``graph_captures``: the graphs captured, ``kernels.step_graph``), and
the kernels' launch counters, each a plain integer global
of its module registered once at import (``register``):
``launches.K7`` is ``kernels.bath_force.launches`` (``launches.K9`` and
``launches.K10`` count evaluations, three kernels each;
``launches.K10_sym`` those of K10 on its symmetric route;
``launches.DP`` is ``models.nnp.launches``, the DeepPot-SE network's
evaluations by ``deepmddriver``, each a forward pass and its backward).
They count kernel executions: a graph replay adds the launches it holds.

Reports. ``md.RunEnsemble`` and ``md.Run`` each run inside ``call``,
which opens one ``Report``: the entry, its wall seconds, ``{span:
[count, host seconds]}`` and each counter's change over the call.
``reports()`` gives the last 64, oldest first; spans outside any call go
into ``process_report()`` (set-up).
"""

from __future__ import annotations

import collections
import contextlib
import json
import sys
import time
from typing import Optional

import torch

PREFIX = "sclmd:"
RING = 64


class Report:
    """What one runner call (or, for ``process_report``, everything
    outside a call) did: ``entry``, ``wall_s``, ``spans`` ({name: [count,
    host seconds]}) and ``counters`` (each counter's change)."""

    __slots__ = ("entry", "wall_s", "spans", "counters")

    def __init__(self, entry: str):
        self.entry, self.wall_s = entry, 0.0
        self.spans, self.counters = {}, {}

    def span_s(self, name: str) -> float:
        return self.spans.get(name, (0, 0.0))[1]

    def span_count(self, name: str) -> int:
        return self.spans.get(name, (0, 0.0))[0]

    def to_dict(self) -> dict:
        return {"entry": self.entry, "wall_s": self.wall_s,
                "spans": {k: list(v) for k, v in self.spans.items()},
                "counters": dict(self.counters)}


_process = Report("process")
_open = []                              # reports of the calls under way
_ring = collections.deque(maxlen=RING)
_counts = dict.fromkeys(("steps", "syncs", "files", "bytes_written",
                         "files_behind", "library_builds", "steps_graphed",
                         "graph_captures"), 0)
_registered = {}                        # name -> (module name, attribute)


def count(name: str, n: int = 1):
    """Add ``n`` to the program counter ``name``."""
    _counts[name] += n


def add_span(name: str, seconds: float):
    """Add one span ``name`` of ``seconds`` host time, timed elsewhere, to
    the open report. Counters, spans and reports are not thread-safe: work
    on another thread is timed there and added here by the thread that
    made the call."""
    spans = (_open[-1] if _open else _process).spans
    st = spans.get(name)
    if st is None:
        spans[name] = [1, seconds]
    else:
        st[0] += 1
        st[1] += seconds


def register(name: str, module: str, attr: str):
    """Read the integer global ``attr`` of ``module`` as counter
    ``name``; a kernel module registers its launch counters at import."""
    _registered[name] = (module, attr)


def launch_counts() -> dict:
    """The registered kernel counters (``register``) now."""
    return {name: getattr(sys.modules[mod], attr)
            for name, (mod, attr) in _registered.items()}


def set_launch_counts(values: dict):
    """Set registered kernel counters: ``{name: value}``."""
    for name, v in values.items():
        mod, attr = _registered[name]
        setattr(sys.modules[mod], attr, v)


def counters() -> dict:
    """Every counter's value now."""
    return {**_counts, **launch_counts()}


def reports() -> list:
    """The last ``RING`` runner calls' reports, oldest first."""
    return list(_ring)


def process_report() -> Report:
    """The spans opened outside every call (set-up)."""
    return _process


class span:
    """``with span(name):`` adds the block's host time to the open
    report (``seconds`` after the block); under a running
    ``torch.profiler`` the block is also ``record_function("sclmd:" +
    name)``."""

    __slots__ = ("name", "seconds", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.seconds = (time.perf_counter_ns() - self._t0) * 1e-9
        if self._rf is not None:
            self._rf.__exit__(*exc)
        add_span(self.name, self.seconds)
        return False


@contextlib.contextmanager
def call(entry: str, name: str):
    """One runner call: a new report, the whole call as span ``name``,
    the counters' changes; the report joins ``reports()`` when the call
    ends, whether it returns or raises. Usable as a decorator."""
    rep = Report(entry)
    before = counters()
    _open.append(rep)
    t0 = time.perf_counter_ns()
    try:
        with span(name):
            yield rep
    finally:
        rep.wall_s = (time.perf_counter_ns() - t0) * 1e-9
        _open.remove(rep)
        rep.counters = {k: v - before.get(k, 0)
                        for k, v in counters().items()}
        _ring.append(rep)


def device_sync():
    """Wait for the current CUDA card's queued work; no-op without one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Tracer:
    """Nested sections, each a ``span`` of its path (``outer/inner``),
    with calls and seconds kept per path in ``stats`` as well.

    with tracer.section("noise"):
        ...
    print(tracer.report())
    """

    def __init__(self):
        # path -> [calls, seconds]
        self.stats = collections.defaultdict(lambda: [0, 0.0])
        self._stack = []

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time a section; ``sync`` (e.g. ``device_sync``) runs before the
        clock stops, so queued card work is counted."""
        path = "/".join([*self._stack, name])
        self._stack.append(name)
        sp = span(path)
        try:
            with sp:
                try:
                    yield
                finally:
                    if sync is not None:
                        sync()
        finally:
            self._stack.pop()
            st = self.stats[path]
            st[0] += 1
            st[1] += sp.seconds

    def wrap(self, name: str, fn, sync_result: bool = True):
        """Wrap a callable so every invocation is traced; the card's
        queued work is waited for (``torch.cuda.synchronize``), so the
        time is the work's, not its enqueue's."""

        def wrapped(*a, **kw):
            with self.section(name, sync=device_sync if sync_result
                              else None):
                return fn(*a, **kw)
        return wrapped

    def report(self, sort_by_time: bool = True) -> str:
        rows = sorted(self.stats.items(),
                      key=(lambda kv: -kv[1][1]) if sort_by_time else None)
        lines = ["%-40s %10s %12s %12s" % ("section", "calls",
                                           "total[s]", "per-call[ms]")]
        for name, (calls, secs) in rows:
            lines.append("%-40s %10d %12.4f %12.3f"
                         % (name, calls, secs, 1e3 * secs / max(calls, 1)))
        return "\n".join(lines)

    def to_json(self, path: Optional[str] = None) -> str:
        d = {k: {"calls": v[0], "seconds": v[1]}
             for k, v in self.stats.items()}
        s = json.dumps(d, indent=2)
        if path:
            with open(path, "w") as fh:
                fh.write(s)
        return s


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace (CPU and, with a card, CUDA activities) of
    everything launched inside; a Chrome trace ``trace.json`` is written
    into ``logdir`` and the profiler object is yielded (its
    ``key_averages()`` give per-kernel sums)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        device_sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def compiled_cost(fn, *args, **kwargs):
    """Operation count of one call of ``fn`` on the given arguments, by
    ``FlopCounterMode``: {'flops': ..., 'bytes accessed': None}. The
    counter has no byte count (the JAX package's XLA cost analysis has
    one)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": counter.get_total_flops(), "bytes accessed": None}


def flops_estimate_gle_step(nph: int, nbaths: int, nc: int, ml: int):
    """Analytic per-step cost model of the GLE step (for roofline
    comparisons): potential 2 x nph^2 MACs (harmonic), memory kernel
    one (nc, (ml-2) nc) matmul with 2 columns + 6 small matvecs."""
    pot = 2 * 2 * nph * nph
    kern = nbaths * (2 * (ml - 2) * nc * nc * 2 + 6 * 2 * nc * nc)
    return {"flops": pot + kern,
            "kernel_bytes": nbaths * ml * nc * nc * 4}
