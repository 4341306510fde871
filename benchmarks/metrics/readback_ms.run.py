"""Host milliseconds an ``md.Run`` trajectory spends copying its
segments' outputs to the host and checking them finite (the program's
span ``run/readback``)."""

UNIT, LAYER, MOVES = "ms", "runners", "run_steps_per_s"
SPANS = {}


def read(v):
    from benchmarks import reports
    return reports.span_ms(v, "Run", "run/readback", per="run/postrun")
