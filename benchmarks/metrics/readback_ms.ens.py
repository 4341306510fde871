"""Host milliseconds a ``RunEnsemble`` call waits for its segments'
sums and finite flags (the program's span ``ensemble/readback``)."""

UNIT, LAYER, MOVES = "ms", "runners", "traj_steps_per_s"
SPANS = {}


def read(v):
    from benchmarks import reports
    return reports.span_ms(v, "RunEnsemble", "ensemble/readback")
