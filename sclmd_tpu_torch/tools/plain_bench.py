"""Times of the plain GLE step's kernels and entry points on the card.

    python -m sclmd_tpu_torch.tools.plain_bench

Needs a CUDA card. Measures the package it is imported from, so two
versions are compared by running it from the root of each checkout in
turn, in one call on one card (parent, change, change, parent). Prints
one JSON line:

* ``k6_event_us``: K6 at the primary shapes, one trajectory (CUDA
  events over 200 back-to-back calls);
* ``device_us``: profiler device time per launch (mean of 50) of K6's
  two passes at one trajectory, of K7's predictor at one trajectory on
  the primary phonon baths with tails, and at 128 flagship trajectories;
* ``run_steps_per_s``: two ``md.Run`` calls on the primary junction (no
  block, 2 runs x 2048 steps in two segments, power spectra on), runner
  set-up outside the window, after a warm-up call;
* ``flagship_traj_steps_per_s``: ``RunEnsemble(block=None)`` on the
  harmonic flagship at 128 and 1024 trajectories, after a warm-up each.
"""

import json
import tempfile
import time

import torch


def _event_us(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return 1000.0 * a.elapsed_time(b) / reps


def _device_us(fn, reps=50):
    """Profiler device time per launch of the plain step's kernels."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / e.count for e in prof.key_averages()
            if e.count and ("bath_force" in e.key or "conv_tails" in e.key)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("plain_bench: needs a CUDA device")
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import conv_tails as K6
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools.primary import (NMD, NPH, primary_baths,
                                               primary_runner)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return 0.05 * torch.randn(shape, device=dev, generator=gen)

    pb = primary_baths(torch.float32, dev)
    ring = rnd(1, pb[0].ml, NPH)
    k6 = K6.ConvTailsCuda(ring, pb)
    res = {"k6_event_us": _event_us(lambda: k6(377), 200),
           "device_us": {"k6_1traj": _device_us(lambda: k6(377))}}

    tails = [t.clone() for t in k6(377)]
    baths = [b.replace(noise=rnd(1, NMD, b.nc)) for b in pb]
    p = rnd(1, NPH)
    cur, etot = torch.zeros((1, 2), device=dev), torch.zeros((1,), device=dev)
    f1 = K7.BathForce(baths, 1, NPH, NMD, F.DT, dev)
    res["device_us"]["k7_1traj"] = _device_us(
        lambda: f1.pred(p, p, p, ring, 0, pb[0].ml - 1, tails, 3, cur, etot))

    fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp())
    fb = [b.replace(noise=rnd(128, F.NMD, b.nc)) for b in fr.baths]
    pp = rnd(128, fr.nph)
    rg = pp[:, None].clone()
    cur2, etot2 = (torch.zeros((128, 2), device=dev),
                   torch.zeros((128,), device=dev))
    f128 = K7.BathForce(fb, 128, fr.nph, F.NMD, F.DT, dev)
    res["device_us"]["k7_flagship_128"] = _device_us(
        lambda: f128.pred(pp, pp, pp, rg, 0, 0, [None, None], 3, cur2,
                          etot2))

    r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
    r.block, r.nstart, r.nstop, r.npie = None, 0, 2, 2
    r.CalPowerSpec()
    r.Run()                                            # warm-up
    res["run_steps_per_s"] = []
    for _ in range(2):
        r.outdir = tempfile.mkdtemp()    # Run skips runs it finds finished
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.Run()
        torch.cuda.synchronize()
        res["run_steps_per_s"].append(2 * NMD / (time.perf_counter() - t0))

    res["flagship_traj_steps_per_s"] = {}
    for n in (128, 1024):
        fr.RunEnsemble(n, block=None)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr.RunEnsemble(n, block=None)
        torch.cuda.synchronize()
        res["flagship_traj_steps_per_s"][n] = \
            n * F.NMD / (time.perf_counter() - t0)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
