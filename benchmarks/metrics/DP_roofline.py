"""DP, the DeepPot-SE network's force: the least time its work needs
(``work/DP.py``) over the device time of the network's kernels in the
traced window, in percent. Those kernels are cuBLAS's and ATen's, named
as other code's are, so the device time is that of every kernel of the
window but the hand kernels the other work files name (the runner's own
few ATen and cuFFT kernels a call, against thousands of evaluations of
about 130 kernels, count with the network's and lower the share by under
0.1 %). Left out where the trace's activation kernels (``KERNELS``, ten
an evaluation) differ from the program's evaluations (``launches.DP``)
times ten. No span: the evaluations run inside graph replays, which
record no host span."""

import glob
import os

UNIT, LAYER, MOVES = "%", "kernels", "traj_steps_per_s"
WORK = "DP"
SPANS = {}


def others() -> set:
    """The names of every other work file's kernels."""
    from benchmarks import spec
    names = set()
    for path in glob.glob(os.path.join(spec.HERE, "work", "*.py")):
        name = os.path.basename(path)[:-3]
        if name != WORK:
            names.update(spec.work(name).KERNELS)
    return names


def read(v):
    from benchmarks import spec
    from benchmarks.trace import _clip, _length, _merge
    t = v.trace
    if not v.launches_ok(WORK) or not t.kernel_count(spec.work(WORK).KERNELS):
        return None
    skip = others()
    dev = 1e-6 * _length(_merge(_clip(
        [(a, b) for a, b, cat, n, _ in t.dev
         if cat == "kernel" and not any(k in n for k in skip)],
        t.lo, t.hi)))
    return 100.0 * v.least_s(WORK) / dev if dev > 0 else None
