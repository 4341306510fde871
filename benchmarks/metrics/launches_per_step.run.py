"""Device kernels a step of ``md.Run`` launches: the traced window's
kernels over the steps its calls enqueued (the program's ``steps``
counter, added once a segment). None on the CPU."""

UNIT, LAYER, MOVES = "launches", "integrator", "run_steps_per_s"
SPANS = {}


def read(v):
    from benchmarks import reports
    return reports.launches_per_step(v, "Run")
