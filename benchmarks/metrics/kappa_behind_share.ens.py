"""Share of ``RunEnsemble``'s kappa files written on its writer thread,
while a later chunk runs on the card: the program's ``files_behind``
counter over its ``files`` in the traced window, in percent. None where
the program keeps no such counter (a tree older than the writer)."""

UNIT, LAYER, MOVES = "%", "runner output", "traj_steps_per_s"
SPANS = {}
ENTRY = "RunEnsemble"


def read(v):
    from benchmarks import reports
    reps = reports.window(v, ENTRY)
    if reps is None or any("files_behind" not in r.counters for r in reps):
        return None
    files = sum(r.counters.get("files", 0) for r in reps)
    behind = sum(r.counters["files_behind"] for r in reps)
    return 100.0 * behind / files if files else None
