"""Host milliseconds an ``md.Run`` trajectory spends starting: the
system, the seed, the thermal start, the checkpoint probe and the run's
noise (the program's span ``run/start``)."""

UNIT, LAYER, MOVES = "ms", "runners", "run_steps_per_s"
SPANS = {}


def read(v):
    from benchmarks import reports
    return reports.span_ms(v, "Run", "run/start", per="run/postrun")
