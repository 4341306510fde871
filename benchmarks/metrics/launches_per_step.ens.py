"""Device kernels a step of the ensemble runner launches: the traced
window's kernels (all of them: the hand kernels, ATen's, cuFFT's) over
the steps ``RunEnsemble`` enqueued (the program's ``steps`` counter, a
segment's steps added once per chunk and segment). None on the CPU."""

UNIT, LAYER, MOVES = "launches", "integrator", "traj_steps_per_s"
SPANS = {}


def read(v):
    from benchmarks import reports
    return reports.launches_per_step(v, "RunEnsemble")
