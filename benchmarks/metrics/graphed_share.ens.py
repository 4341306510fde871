"""Share of ``RunEnsemble``'s plain steps that ran by replaying a CUDA graph:
the program's ``steps_graphed`` counter over its ``steps`` in the traced
window, in percent. None where the program keeps no such counter (a
tree older than the graph)."""

UNIT, LAYER, MOVES = "%", "integrator", "traj_steps_per_s"
SPANS = {}
ENTRY = "RunEnsemble"


def read(v):
    from benchmarks import reports
    reps = reports.window(v, ENTRY)
    if reps is None or any("steps_graphed" not in r.counters for r in reps):
        return None
    steps = sum(r.counters.get("steps", 0) for r in reps)
    graphed = sum(r.counters["steps_graphed"] for r in reps)
    return 100.0 * graphed / steps if steps else None
