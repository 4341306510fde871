"""Tracing and profiling utilities (counterpart of
``sclmd_tpu.utils.profiling``).

A nested wall-clock section tracer whose report gives calls and total
time per section; a ``torch.profiler`` trace of everything launched
inside a block; the operation count of a function by
``torch.utils.flop_counter.FlopCounterMode``; and the analytic cost model
of one GLE step.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Optional

import torch


def device_sync():
    """Wait for the current CUDA card's queued work; no-op without one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Tracer:
    """Nested wall-clock section tracer.

    with tracer.section("noise"):
        ...
    print(tracer.report())
    """

    def __init__(self):
        self.stats = defaultdict(lambda: [0, 0.0])   # name -> [calls, secs]
        self._stack = []

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time a section; ``sync`` (e.g. ``device_sync``) runs before the
        clock stops, so queued card work is counted."""
        path = "/".join([*self._stack, name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            dt = time.perf_counter() - t0
            self._stack.pop()
            st = self.stats[path]
            st[0] += 1
            st[1] += dt

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
