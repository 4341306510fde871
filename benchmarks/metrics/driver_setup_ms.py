"""Host milliseconds the process spent building its force driver: the
neighbour tables, the kernel's packed operands and its force at q = 0
(the program's span ``setup/driver`` in its set-up report,
``profiling.process_report``). None where the program keeps no such
report or the driver opens no such span (a tree older than them)."""

UNIT, LAYER, MOVES = "ms", "set-up", "setup_s"
SPANS = {}


def read(v):
    from sclmd_tpu_torch.utils import profiling
    report = getattr(profiling, "process_report", None)
    if report is None:
        return None
    rep = report()
    if not rep.span_count("setup/driver"):
        return None
    return 1e3 * rep.span_s("setup/driver")
