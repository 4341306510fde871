"""K10, the Sutton-Chen EAM force: the least time its work needs
(``work/K10.py``) over the device time of its kernels in the traced
window (by name, ``KERNELS`` of the work file: the slot transpose, the
centre pass and the gather), in percent. Left out where the trace's
launches differ from the program's counters. No span: a span around
each launch would cost the traced run a record a launch."""

UNIT, LAYER, MOVES = "%", "kernels", "traj_steps_per_s"
WORK = "K10"
SPANS = {}


def read(v):
    from benchmarks import spec
    dev = v.trace.kernel_s(spec.work(WORK).KERNELS)
    if dev <= 0 or not v.launches_ok(WORK):
        return None
    return 100.0 * v.least_s(WORK) / dev
