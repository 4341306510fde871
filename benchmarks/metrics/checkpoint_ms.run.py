"""Host milliseconds an ``md.Run`` trajectory spends writing its
``MD{j}.npz`` checkpoints, one a segment (the program's span
``run/checkpoint``, the last one inside ``_postrun``)."""

UNIT, LAYER, MOVES = "ms", "runner output", "run_steps_per_s"
SPANS = {}


def read(v):
    from benchmarks import reports
    return reports.span_ms(v, "Run", "run/checkpoint", per="run/postrun")
