"""The program's own reports of the traced calls
(``sclmd_tpu_torch.utils.profiling.reports``: a report a runner call,
with its spans' host seconds and its counters' changes), which the
metrics that read the program's spans and counters share.

The traced loop is the last thing that calls the runners (the check
replays the reference only), so the window's calls are the last
``v.calls`` reports. ``window`` gives None where the program keeps no
reports (a tree older than them), fewer than that, or reports of
another entry.
"""


def window(v, entry: str):
    """The traced window's reports, oldest first, or None."""
    from sclmd_tpu_torch.utils import profiling
    reports = getattr(profiling, "reports", None)
    if reports is None or v.calls < 1:
        return None
    reps = reports()[-v.calls:]
    if len(reps) < v.calls or any(r.entry != entry for r in reps):
        return None
    return reps


def span_ms(v, entry: str, name: str, per: str = None):
    """Host milliseconds in span ``name`` over the window, per call, or
    per span ``per`` (a trajectory of ``md.Run``: its ``run/postrun``);
    None where the span never ran."""
    reps = window(v, entry)
    if reps is None or not sum(r.span_count(name) for r in reps):
        return None
    n = v.calls if per is None else sum(r.span_count(per) for r in reps)
    return 1e3 * sum(r.span_s(name) for r in reps) / n if n else None


def launches_per_step(v, entry: str):
    """Device kernels of the traced window over the steps its calls
    enqueued (the program's ``steps`` counter); None where the trace
    holds no kernel (a CPU run)."""
    reps = window(v, entry)
    if reps is None:
        return None
    steps = sum(r.counters.get("steps", 0) for r in reps)
    kernels = v.trace.kernel_count(("",))
    return kernels / steps if kernels and steps else None
