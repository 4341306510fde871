"""Times of the plain GLE step's kernels and entry points on the card.

    python -m sclmd_tpu_torch.tools.plain_bench [--label NAME] [--sweep]
        [--workload plain|flagship_mb|graph_sweep]

Needs a CUDA card. Measures the package it is imported from, so two
versions are compared by running this file from the root of each
checkout in turn, in one call on one card (parent, change, change,
parent; for the parent: ``PYTHONPATH=. python
<this tree>/sclmd_tpu_torch/tools/plain_bench.py --label parent`` from
the root of its ``git archive``). Prints the card's name and power limit
and one JSON line:

* ``k7``: K7 at its three shapes (``primary_1``: one trajectory on the
  primary junction's phonon baths with K6's tails; ``flagship_128`` and
  ``flagship_<chunk>``: the flagship's electron baths at 128
  trajectories and at the chunk size of its 1024-trajectory run), each
  stage (``pred``, ``corr``, ``last``): ``event_us`` (CUDA events over
  200 back-to-back calls, which is the host's enqueue time once the
  kernel is shorter than that), ``device_us`` (the profiler's mean
  device duration over 50 launches) and ``enqueue_us`` (host clock per
  call, no synchronise);
* ``k6``: K6 at the primary shapes for 1 and 37 trajectories, the same
  three times (``device_us`` per kernel name: the parent's has two);
* ``noop_device_us``: an empty kernel's device duration, where the
  package has one;
* ``segment``: 2048 plain steps of ``md.run_segment`` on the primary
  junction at one trajectory: ``host_s`` (the loop's host clock, no
  synchronise: what the host needs to enqueue the steps) and ``wall_s``
  (with the closing synchronise); ``flagship_segment``: the same for the
  flagship's 1024 steps at 128 and 1024 trajectories (the part of
  ``RunEnsemble`` that runs the kernels, without its draws and files);
* ``run_steps_per_s``: three ``md.Run`` calls on the primary junction (no
  block, 2 runs x 2048 steps in two segments, power spectra on), runner
  set-up outside the window, after a warm-up call;
* ``flagship_noise``: one chunk's draws and noise synthesis on the
  flagship at 128 and 1024 trajectories (``tools.noise_bench.noise_times``);
* ``flagship_traj_steps_per_s``: ``RunEnsemble(block=None)`` on the
  harmonic flagship at 128 and 1024 trajectories, five calls each after a
  warm-up.

``--workload flagship_mb`` measures the many-body flagship instead (the
C/H force driver through ``AddPotential``):

* ``k5``: K5 at 128 trajectories and at the chunk size of the
  1024-trajectory run: ``event_us``, ``device_us``, ``enqueue_us`` as
  above, ``twin_us`` (the autograd twin on the card, CUDA events over 10
  calls) and the work of one evaluation (``kernels.ch_force.work_counts``);
  with the launch plan and the kernel's phase stamps (``phase_cycles``:
  SM cycles of the staging, phases A, B, C and the gather, medians over
  the trajectory groups);
* ``flagship_mb_segment``: 1024 plain steps of ``md.run_segment`` at 128
  and 1024 trajectories (``host_s``, ``wall_s``);
* ``flagship_mb_traj_steps_per_s``: ``RunEnsemble`` at 128 and 1024
  trajectories, five calls each after a warm-up, and beside it
  ``flagship_traj_steps_per_s``, the harmonic flagship in the same call.

``--workload graph_sweep`` times one segment of ``md.run_segment``
(``host_s``, ``wall_s`` as above) eagerly and for each group length of
``kernels.step_graph`` in ``GRAPH_SWEEP`` (``GRAPH_STEPS`` set for the
run): ``run_segment``, the primary chain's 1024 steps at one trajectory
(a segment of the benchmark's ``md.Run``), and ``flagship_mb_segment``,
the many-body flagship's 1024 steps at the chunk size of its
1024-trajectory run.

``--sweep`` with ``flagship_mb`` adds ``k5_sweep``: K5's device time at
128 and at the 1024 chunk for each number of threads per trajectory
group and of groups per CTA that fit (the results agree bitwise). With
the plain workload it adds ``k7_sweep``: K7's predictor device time at
each shape for every number of trajectories per CTA the kernel is built
for; and
``k6_keep_sweep``: K6's device time per step at one trajectory for
several shares of L2 that the kernel slab is asked to stay in (0: every
tap is asked to leave first; 1: as much of the slab as L2 holds).
"""

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

from sclmd_tpu_torch.tools.noise_bench import noise_times

STAGES = ("pred", "corr", "last")


def event_us(fn, reps=200):
    """Mean microseconds per call between two CUDA events."""
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


def enqueue_us(fn, reps=200):
    """Host microseconds per call, no synchronise inside the window."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def device_us(fn, reps=50,
              names=("bath_force", "conv_tails", "noop", "ch_force")):
    """Profiler device microseconds per launch, by kernel name: the mean
    over the launches the trace recorded. The profiler sometimes drops
    records; a trace that kept fewer than half of the calls is taken
    again, and three such in a row raise."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if any(n in e.key for n in names)]
        if found and all(2 * e.count >= reps for e in found):
            return {e.key[:60]: e.device_time_total / e.count for e in found}
    raise RuntimeError("device_us: the profiler recorded "
                       f"{[(e.key[:40], e.count) for e in found]} for {reps} "
                       "calls")


def times(fn):
    dev = device_us(fn)
    return {"event_us": event_us(fn), "device_us": sum(dev.values()),
            "enqueue_us": enqueue_us(fn), "kernels": dev}


class K7Case:
    """K7's operands for one evaluation of every stage: a state, a
    history ring, noise on the baths, K6 tails where a bath has them."""

    def __init__(self, baths, ntraj, nph, nmd, dt, dev, seed, **force_kw):
        from sclmd_tpu_torch.kernels import bath_force as K7
        gen = torch.Generator(device=dev).manual_seed(seed)

        def rnd(*shape, scale=1.0):
            return scale * torch.randn(shape, device=dev, generator=gen)

        self.baths = [b.replace(noise=rnd(ntraj, nmd, b.nc, scale=0.01))
                      for b in baths]
        self.p, self.q, self.x = (rnd(ntraj, nph, scale=0.05)
                                  for _ in range(3))
        self.pf, self.pf2 = rnd(ntraj, nph), rnd(ntraj, nph)
        self.mlr = max(b.ml for b in baths)
        self.ring = rnd(ntraj, self.mlr, nph, scale=0.05)
        self.tails = [rnd(ntraj, b.nc, 2, scale=1e-3) if b.ml > 2 else None
                      for b in baths]
        self.mask = torch.ones(nph, device=dev)
        self.mask[: nph // 10] = 0.0
        self.cur = torch.zeros((ntraj, 1, len(baths)), device=dev)
        self.etot = torch.zeros((ntraj, 1), device=dev)
        self.dt, self.nmd, self.ntraj, self.nph = dt, nmd, ntraj, nph
        # step 0 of a segment from global step 3: ring head 0, push row
        # mlr - 1, noise rows 3 and 4
        self.force = K7.BathForce(self.baths, ntraj, nph, nmd, dt, dev,
                                  t0=3, **force_kw)
        # a predictor's outputs, for the correctors' inputs
        self.ph, self.qt = (t.clone() for t in self.stage_call("pred", True))

    def stage_call(self, stage, kernel: bool):
        """One evaluation of a stage, by the kernel or its twin."""
        from sclmd_tpu_torch.kernels import bath_force as K7
        head, push = 0, (self.mlr - 1) % self.mlr
        f, ops = self.force, self.force.ops
        if stage == "pred":
            if kernel:
                return f.pred(self.p, self.q, self.pf, self.ring, 0,
                              self.tails, self.cur, self.etot)
            return K7.pred_plain(self.p, self.q, self.pf, self.ring, head,
                                 push, ops, self.tails, 3, self.dt,
                                 self.cur[:, 0], self.etot[:, 0])
        mask = self.mask if stage == "last" else None
        if kernel:
            return f.corr(self.x, self.qt, self.pf2, self.p, self.ph,
                          self.tails, 0, mask=mask)
        return K7.corr_plain(self.x, self.qt, self.pf2, self.p, self.ph, ops,
                             self.tails, 4, self.dt, mask)


def k7_cases(dev, **force_kw):
    """K7's three main-path shapes: name -> K7Case."""
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools.primary import DT, NMD, NPH, primary_baths

    fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp())
    chunk = max(F.chunk_sizes(fr._build_system(), 1024))
    cases = {"primary_1": K7Case(primary_baths(torch.float32, dev), 1, NPH,
                                 NMD, DT, dev, 10, **force_kw)}
    for n in sorted({128, chunk}):
        cases[f"flagship_{n}"] = K7Case(fr.baths, n, fr.nph, F.NMD, F.DT,
                                        dev, n, **force_kw)
    return cases


def segment_times(r, ntraj, nsteps):
    """Host enqueue time and wall time of ``nsteps`` plain steps of
    ``ntraj`` trajectories of the runner ``r``'s system, three samples
    after a warm-up."""
    from sclmd_tpu_torch.md import run_segment, thermal_init
    from sclmd_tpu_torch.ops.noise import sample_noise_from_r
    from sclmd_tpu_torch.parallel.ensemble import bath_factors

    dev = r.device
    gen = torch.Generator(device=dev).manual_seed(12)
    facs = bath_factors(r.baths, dev)
    system = r._build_system().replace(baths=tuple(
        b.replace(noise=sample_noise_from_r(
            torch.randn((ntraj,) + tuple(sd.shape), dtype=sd.dtype,
                        device=dev, generator=gen), ev, sd, r.dt, r.nmd))
        for b, (ev, sd) in zip(r.baths, facs)))
    st = thermal_init(torch.rand((ntraj, r.nph), dtype=r.dtype, device=dev,
                                 generator=gen), system, r.hw, r.U, r.T)
    out = []
    for _ in range(4):                    # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_segment(system, st, nsteps, t0=0)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out.append({"host_s": host, "wall_s": time.perf_counter() - t0})
    return out[1:]


def ensemble_rates(r, nsteps, sizes=(128, 1024), reps=5) -> dict:
    """Trajectory-steps/s of ``RunEnsemble(block=None)`` on the runner
    ``r``: ``reps`` calls per size after a warm-up."""
    out = {}
    for n in sizes:
        r.RunEnsemble(n, block=None)                  # warm-up
        out[n] = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.RunEnsemble(n, block=None)
            torch.cuda.synchronize()
            out[n].append(n * nsteps / (time.perf_counter() - t0))
    return out


GRAPH_SWEEP = (2, 4, 8, 16, 32, 64)


def graph_sweep(dev, res):
    """The ``graph_sweep`` workload, into ``res``."""
    from sclmd_tpu_torch.kernels import step_graph as SG
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools.primary import NMD, primary_runner

    r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
    fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp(),
                           many_body=True)
    chunk = max(F.chunk_sizes(fr._build_system(), 1024))
    keep, out = SG.GRAPH_STEPS, {}
    try:
        for g in ("eager",) + GRAPH_SWEEP:
            # a group longer than any segment: every step eager
            SG.GRAPH_STEPS = 1 << 30 if g == "eager" else g
            out[g] = {"run_segment": segment_times(r, 1, NMD // 2),
                      "flagship_mb_segment": segment_times(fr, chunk,
                                                           F.NMD)}
    finally:
        SG.GRAPH_STEPS = keep
    res["graph_sweep"] = out
    res["flagship_chunk"] = chunk


K5_SWEEP_THREADS = (128, 256, 384, 512, 768)
K5_SWEEP_GROUPS = (1, 2, 4, 6, 8)


def many_body(dev, res, sweep=False):
    """The ``flagship_mb`` workload: K5's times and the many-body
    flagship's segment and ensemble rates, into ``res``."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.tools import flagship as F

    fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp(),
                           many_body=True)
    drv = fr.pforce
    gen = torch.Generator(device=dev).manual_seed(21)
    chunk = max(F.chunk_sizes(fr._build_system(), 1024))
    cuda = drv.kernel.cuda
    res["k5"] = {"work": K5.work_counts(cuda.pack)}
    qs = {n: 0.3 * torch.randn((n, fr.nph), device=dev, generator=gen)
          for n in sorted({128, chunk})}
    for n, q in qs.items():
        res["k5"][n] = times(lambda: drv.force_torch(q))
        res["k5"][n]["twin_us"] = event_us(lambda: drv.kernel.plain(q), 10)
        res["k5"][n]["plan"] = cuda.plan(n)
        res["k5"][n]["phase_cycles"] = cuda.phase_cycles(q)
    if sweep:
        res["k5_sweep"] = {}
        k = K5.CHForceCuda(cuda.pack, dev)
        for n, q in qs.items():
            for tt in K5_SWEEP_THREADS:
                for tpc in K5_SWEEP_GROUPS if n > 128 else (1,):
                    try:
                        k._reshape(threads=tt, tpc=tpc).plan(n)
                    except ValueError:        # does not fit
                        continue
                    res["k5_sweep"][f"{n} tt{tt} tpc{tpc}"] = sum(
                        device_us(lambda: k(q)).values())
    res["flagship_mb_segment"] = {n: segment_times(fr, n, F.NMD)
                                  for n in (128, 1024)}
    res["flagship_mb_traj_steps_per_s"] = ensemble_rates(fr, F.NMD)
    res["flagship_traj_steps_per_s"] = ensemble_rates(
        F.flagship_runner(torch.float32, dev, tempfile.mkdtemp()), F.NMD)


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("plain_bench: needs a CUDA device")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--workload", default="plain",
                    choices=["plain", "flagship_mb", "graph_sweep"])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--no-e2e", action="store_true",
                    help="kernel times only")
    args = ap.parse_args(argv)
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import build
    from sclmd_tpu_torch.kernels import conv_tails as K6
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools.primary import (NMD, NPH, primary_baths,
                                               primary_runner)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    res = {"label": args.label, "device": smi}
    if args.workload == "flagship_mb":
        many_body(dev, res, args.sweep)
        print(json.dumps(res), flush=True)
        return
    if args.workload == "graph_sweep":
        graph_sweep(dev, res)
        print(json.dumps(res), flush=True)
        return
    res.update(k7={}, k6={})
    gen = torch.Generator(device=dev).manual_seed(5)

    lib = build.load()
    if hasattr(lib, "bath_force_noop"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        res["noop_device_us"] = sum(device_us(
            lambda: lib.bath_force_noop(stream)).values())

    pb = primary_baths(torch.float32, dev)
    for n, step in ((1, 623), (37, 995)):
        ring = 0.05 * torch.randn((n, pb[0].ml, NPH), device=dev,
                                  generator=gen)
        k6 = K6.ConvTailsCuda(ring, pb)
        res["k6"][n] = times(lambda: k6(step))

    for name, c in k7_cases(dev).items():
        res["k7"][name] = {s: times(lambda: c.stage_call(s, True))
                           for s in STAGES}
        res["k7"][name]["tile"] = getattr(c.force, "tile", None)

    if args.sweep:
        res["k7_sweep"] = {}
        for tile in K7.TILES:
            for name, c in k7_cases(dev, tile=tile).items():
                key = f"{name} tt{tile}"
                res["k7_sweep"][key] = sum(device_us(
                    lambda: c.stage_call("pred", True)).values())
        ring = 0.05 * torch.randn((1, pb[0].ml, NPH), device=dev,
                                  generator=gen)
        res["k6_keep_sweep"] = {}
        for share in (0.0, 0.4, 0.55, 0.7, 0.85, 1.0):
            k6 = K6.ConvTailsCuda(ring, pb, keep_l2_share=share)
            res["k6_keep_sweep"][share] = sum(device_us(
                lambda: k6(623), reps=200).values())

    if not args.no_e2e:
        r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
        fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp())
        res["segment"] = segment_times(r, 1, NMD)
        res["flagship_segment"] = {n: segment_times(fr, n, F.NMD)
                                   for n in (128, 1024)}
        r.block, r.nstart, r.nstop, r.npie = None, 0, 2, 2
        r.CalPowerSpec()
        r.Run()                                            # warm-up
        res["run_steps_per_s"] = []
        for _ in range(3):
            r.outdir = tempfile.mkdtemp()  # Run skips runs it finds finished
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.Run()
            torch.cuda.synchronize()
            res["run_steps_per_s"].append(
                2 * NMD / (time.perf_counter() - t0))

        res["flagship_noise"] = {n: noise_times(fr, n) for n in (128, 1024)}
        res["flagship_traj_steps_per_s"] = ensemble_rates(fr, F.NMD)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
