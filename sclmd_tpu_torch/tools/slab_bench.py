"""Times of the slabs' force kernels (K9 on the silicon slab, K10 analytic
and tabulated on the gold slab) and of a one-segment slab ensemble, for
the tree it is run from.

    python -m sclmd_tpu_torch.tools.slab_bench [--reps 20] [--label L]
        [--kernels-only] [--sweep] [--out FILE]

Needs a CUDA card. An A/B against another commit runs this file from a
``git archive`` of that commit with the archive first on ``PYTHONPATH``
(it then imports that commit's package, which needs the drivers,
``kernels.{sw,eam}_force.work_counts`` and ``tools.slab`` of PR 9 or
later), in turns with this tree's run, in one call:

    (cd _checkout/parent && PYTHONPATH=. python \\
        ../../sclmd_tpu_torch/tools/slab_bench.py --label parent)

Prints one JSON line per case, then the whole record (also written to
``--out``), beside the card's name and power limit. Per force case at
the ensemble's 64 trajectories of thermal displacements (0.05 angstrom
rms, a seeded draw): ``ms`` the force call (CUDA events, mean of
``--reps`` calls after a warm-up), ``bound_ms`` (``work_counts``'
operations at the float32 peak, or q, f and the table's bytes at HBM's
rate), the device time of each kernel of the call (``kernel_us``,
profiler), and the cutoff tests' agreement across each warp's 32
trajectories (``lanes``); with ``--sweep`` (this tree's kernels only)
the force call's time at each launch shape of the centre pass, each
with the same bits as the plan's (``sweep``). Without ``--kernels-only``: the seconds of
``RunEnsemble(64, nsteps=1024)`` in one segment (no checkpoint) on the
silicon and the analytic gold slab, after a warm-up call.
"""

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

PEAK_F32, PEAK_HBM = 67e12, 3.35e12
NTRAJ, NSTEPS, AMP = 64, 1024, 0.05
CASES = (("sw", "sw_force"), ("eam", "eam_force"), ("eam_tab", "eam_force"))


def event_ms(fn, reps):
    """Milliseconds per call (CUDA events) after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def thermal_q(drv, ntraj, dev, seed, amp=AMP):
    """Displacements of ``amp`` angstrom rms per coordinate, in q."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    conv = torch.as_tensor(drv.conv, dtype=torch.float32, device=dev)
    return amp * torch.randn((ntraj, 3 * drv.number), device=dev,
                             generator=gen) / conv


def kernel_us(fn, calls=5) -> dict:
    """Device microseconds per call of each kernel ``fn`` launches, from a
    profiler trace of ``calls`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            out[e.key[:60]] = e.device_time_total / calls
    return out


def lane_agreement(pack, q, rc) -> dict:
    """How the cutoff tests of a slot table agree across the 32
    trajectories of a warp (groups of consecutive trajectories, the
    last one short where the batch is): per (slot, group) test, whether
    some lane takes the slot (r < rc) and whether all its lanes do.
    ``live``: share of tests some lane takes; ``divergent``: share of the
    live tests that some lane does not take; ``idle_lanes``: share of the
    lanes of live tests that do not take the slot."""
    dev = q.device
    na = pack["na"]
    conv = torch.as_tensor(pack["conv"], device=dev)
    u = (conv * q.double()).reshape(q.shape[0], na, 3)
    si = torch.as_tensor(pack["slot_i"], device=dev)
    sj = torch.as_tensor(pack["slot_j"], device=dev)
    d0 = torch.as_tensor(pack["d0"], device=dev)
    cell = torch.as_tensor(pack["cell"], device=dev)
    live = divergent = idle = lanes = 0
    for g0 in range(0, q.shape[0], 32):
        ug = u[g0:g0 + 32]
        d = d0 + ug[:, sj] - ug[:, si]
        per = cell > 0
        d[..., per] -= cell[per] * torch.round(d[..., per] / cell[per])
        inside = torch.linalg.norm(d, dim=-1) < rc           # (lanes, ns)
        n_in = inside.sum(0)
        took = n_in > 0
        live += int(took.sum())
        divergent += int((took & (n_in < ug.shape[0])).sum())
        idle += int((ug.shape[0] - n_in[took]).sum())
        lanes += ug.shape[0] * int(took.sum())
    tests = pack["ns"] * -(-q.shape[0] // 32)
    return {"tests": tests, "live": live / tests,
            "divergent": divergent / max(live, 1),
            "idle_lanes": idle / max(lanes, 1)}


def force_case(kind, name, dev, reps):
    from importlib import import_module
    from sclmd_tpu_torch.tools import slab as SL
    mod = import_module(f"sclmd_tpu_torch.kernels.{name}")
    drv = SL.slab_driver(kind, torch.float32, dev)
    pack = drv.kernel.cuda.pack
    q = thermal_q(drv, NTRAJ, dev, 18 if kind == "sw" else 19)
    w = mod.work_counts(pack)
    ops, nbytes = NTRAJ * w["ops"], NTRAJ * w["bytes"] + w["table_bytes"]
    rc = pack["params"]["rc"] if kind == "sw" else pack["rc"]
    return {"case": kind, "kernel": name, "ntraj": NTRAJ,
            "ms": event_ms(lambda: drv.force_torch(q), reps),
            "bound_ms": 1e3 * max(ops / PEAK_F32, nbytes / PEAK_HBM),
            "flops": ops, "bytes": nbytes,
            "kernel_us": kernel_us(lambda: drv.force_torch(q)),
            "lanes": lane_agreement(pack, q, rc)}, drv


def sweep_case(drv, reps) -> dict:
    """The force call's time at each launch shape of the centre pass (1, 2
    or 4 centres a block where it fits, and the wide route), each held
    bitwise against the plan's own."""
    from sclmd_tpu_torch.kernels import slots
    kern = drv.kernel.cuda
    q = thermal_q(drv, NTRAJ, drv.device, 7)
    own = kern.plan
    want = drv.force_torch(q)
    per_warp = kern.smem_per_warp(kern.pack)
    plans = [slots.Plan(w, w * per_warp, False) for w in (1, 2, 4)
             if w * per_warp <= slots.SMEM_MAX]
    out = {}
    for plan in plans + [slots.Plan(slots.MAX_WARPS, 0, True)]:
        kern.plan = plan
        same = bool(torch.equal(drv.force_torch(q), want))
        name = "wide" if plan.wide else f"wpb{plan.wpb}"
        out[name] = {"ms": event_ms(lambda: drv.force_torch(q), reps),
                     "same_bits": same}
    kern.plan = own
    return out


def run_case(kind, drv, dev) -> dict:
    from sclmd_tpu_torch.tools import slab as SL
    r = SL.slab_runner(kind, torch.float32, dev, tempfile.mkdtemp(),
                       driver=drv)
    r.RunEnsemble(NTRAJ, nsteps=NSTEPS)          # warm-up: same shapes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means = r.RunEnsemble(NTRAJ, nsteps=NSTEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"case": kind, "e2e_npie1_s": wall,
            "traj_steps_per_s": NTRAJ * NSTEPS / wall,
            "finite": bool(np.isfinite(means).all())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("slab_bench: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"label": args.label, "device": torch.cuda.get_device_name(0),
           "smi": smi, "forces": [], "runs": []}
    drivers = {}
    for kind, name in CASES:
        rec, drivers[kind] = force_case(kind, name, dev, args.reps)
        if args.sweep:
            rec["sweep"] = sweep_case(drivers[kind], args.reps)
        print(json.dumps(rec), flush=True)
        out["forces"].append(rec)
    if not args.kernels_only:
        for kind in ("sw", "eam"):
            rec = run_case(kind, drivers[kind], dev)
            print(json.dumps(rec), flush=True)
            out["runs"].append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
