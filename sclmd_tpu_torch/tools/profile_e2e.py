"""Where the time of a run goes on the card.

    python -m sclmd_tpu_torch.tools.profile_e2e --out DIR \\
        [--workload primary|flagship|flagship_mb|run] [--ntraj 256 1024]

Workloads: ``primary``, ``RunEnsemble`` on the primary junction with
the blocked integrator (K1, K2); ``flagship``, ``RunEnsemble`` on the
harmonic flagship with the plain step (K7); ``flagship_mb``, the same
on the many-body flagship (the C/H force driver: K5 twice a step, K7
three times); ``run``, ``md.Run`` of one
2048-step run in two segments on the primary junction with the plain
step (K6, K7; ``--ntraj`` is ignored).

Needs a CUDA card. For each trajectory count: one warm-up call, one
untraced call timed on the host clock (``torch.cuda.synchronize`` inside
the window), then one call under ``torch.profiler`` with a span around
each layer (draws; within them noise synthesis, K3's launch or twin
``noise_synth``, the C2R stage ``noise_c2r``, the thermal start
``thermal_init`` and K3b's ``init_draws`` within it; the integrators, the
potential force, K1 with its near- and far-tap launches, K2, K5, K6, K7, the
output files). From the trace it
reports:

* ``wall_s``: untraced and traced host wall time of the call;
* ``device_busy_ms``: the union of all kernel, copy and memset intervals
  on the card, and ``idle_share`` = 1 - busy / traced wall;
* per span: host time (the span on the CPU) and device time (the union
  of the device work launched inside it);
* the ten device kernels with the most time;
* ``kappa_writers`` (ensemble workloads): the call's kappa files written
  in turns by the runner's raw-syscall writer and by buffered ``open()``.

Writes ``summary_<workload>.json`` and one Chrome trace per count to
``--out`` and
prints the summary as JSON lines, after the card's name and power limit.
"""

import argparse
import functools
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

SPANS = {
    # label: ("module" or "module:Class", attribute) wrapped while the
    # profiler runs
    "draw_chunk": ("sclmd_tpu_torch.parallel.ensemble", "draw_chunk"),
    "noise_synthesis": ("sclmd_tpu_torch.parallel.ensemble",
                        "schedule_noise"),
    "noise_synth": ("sclmd_tpu_torch.kernels.noise_synth",
                    "noise_halfspectrum"),
    "noise_c2r": ("sclmd_tpu_torch.kernels.noise_synth", "c2r_series"),
    "init_draws": ("sclmd_tpu_torch.kernels.noise_synth",
                   "thermal_amplitudes"),
    "thermal_init": ("sclmd_tpu_torch.md:ThermalStart", "states"),
    "run_segment_blocked": ("sclmd_tpu_torch.parallel.ensemble",
                            "run_segment_blocked"),
    "run_segment": ("sclmd_tpu_torch.parallel.ensemble", "run_segment"),
    "run_segment_Run": ("sclmd_tpu_torch.md", "run_segment"),
    "potential_force": ("sclmd_tpu_torch.md:GLESystem", "potential_force"),
    "K1_gle_block": ("sclmd_tpu_torch.md", "gle_block"),
    "K1_near": ("sclmd_tpu_torch.kernels.gle_block", "gle_near_cuda"),
    "K1_far": ("sclmd_tpu_torch.kernels.gle_block", "gle_far_cuda"),
    "K2_block_corr": ("sclmd_tpu_torch.kernels.block_corr", "block_corr"),
    "K5_ch_force": ("sclmd_tpu_torch.kernels.ch_force:CHForceCuda",
                    "__call__"),
    "K6_conv_tails": ("sclmd_tpu_torch.kernels.conv_tails:ConvTailsCuda",
                      "__call__"),
    "K7_bath_force": ("sclmd_tpu_torch.kernels.bath_force:BathForce",
                      "_launch"),
    "Run_noise": ("sclmd_tpu_torch.md:md", "_draw_noise"),
    "Run_postrun": ("sclmd_tpu_torch.md:md", "_postrun"),
    "kappa_files": ("sclmd_tpu_torch.md:md", "_write_kappa_files"),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_ms(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1000.0


def _wrap_spans():
    """Wrap each span's function in ``record_function``; returns undo."""
    import importlib

    undo = []
    for label, (owner, attr) in SPANS.items():
        mod, _, cls = owner.partition(":")
        obj = importlib.import_module(mod)
        obj = getattr(obj, cls) if cls else obj
        fn = getattr(obj, attr)

        def wrapped(*a, _fn=fn, _label="host:" + label, **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)

        setattr(obj, attr, functools.wraps(fn)(wrapped))
        undo.append((obj, attr, fn))
    return lambda: [setattr(o, a, f) for o, a, f in undo]


def summarise(trace_path, wall_traced):
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in DEVICE_CATS]
    busy = _union_ms(dev)
    spans = {}
    for label in SPANS:
        name = "host:" + label
        host = [e for e in events if e["name"] == name
                and e.get("cat") == "user_annotation"]
        gpu = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e["name"] == name and e.get("cat") == "gpu_user_annotation"]
        spans[label] = {"calls": len(host),
                        "host_ms": sum(e["dur"] for e in host) / 1000.0,
                        "device_ms": _union_ms(gpu)}
    per_kernel = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = per_kernel.setdefault(e["name"][:80], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1000.0
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall_traced * 1000.0),
            "spans": spans,
            "top_kernels": [{"name": n, "calls": c, "ms": ms}
                            for n, (c, ms) in top]}


def workload(name: str, dev):
    """(call(ntraj), trajectory-steps of one call(ntraj)) of a workload."""
    if name in ("flagship", "flagship_mb"):
        from sclmd_tpu_torch.tools import flagship as F
        r = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp(),
                              many_body=name == "flagship_mb")
        return (lambda n: r.RunEnsemble(n, nsteps=F.NMD, block=None),
                lambda n: n * F.NMD)
    from sclmd_tpu_torch.tools.primary import BLOCK, NMD, primary_runner
    if name == "primary":
        r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
        return (lambda n: r.RunEnsemble(n, nsteps=NMD, block=BLOCK),
                lambda n: n * NMD)

    r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
    r.block, r.nstart, r.nstop, r.npie = None, 0, 1, 2
    r.CalPowerSpec()

    def run(n):
        # a fresh directory each time: Run skips runs it finds finished
        r.outdir = tempfile.mkdtemp()
        r.Run()
    return run, lambda n: NMD


def kappa_writers_ms(ntraj: int, nb: int = 2, reps: int = 3) -> dict:
    """Milliseconds to write the ``ntraj`` x ``nb`` kappa files of one
    ``RunEnsemble`` call, in turns: by the buffered ``open()`` the runner
    used before (``open_ms``), by its raw ``os.open``/``os.write`` writer
    (``md._write_text``) into a fresh directory (``raw_ms``) and over the
    files of the call before (``raw_again_ms``, as a runner's repeated
    calls do), and by that writer on 8 threads (``raw_8threads_ms``; the
    syscalls release the interpreter lock). The same bytes each time."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.md import _write_text

    means = np.random.default_rng(0).normal(size=(ntraj, nb)) * 1e-6

    def line(j, i):
        return "%i %f    %f \n" % (j, 300.0, means[j, i] * units.CURCOF)

    def buffered(d):
        for j in range(ntraj):
            for i in range(nb):
                with open(os.path.join(d, f"kappa.300.bath{i}.run{j}.dat"),
                          "w") as f:
                    f.write(line(j, i))

    def raw(d):
        for j in range(ntraj):
            for i in range(nb):
                _write_text(os.path.join(
                    d, f"kappa.300.bath{i}.run{j}.dat"), line(j, i))

    def threaded(d):
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda j: [_write_text(os.path.join(
                d, f"kappa.300.bath{i}.run{j}.dat"), line(j, i))
                for i in range(nb)], range(ntraj)))

    out = {"files": ntraj * nb, "open_ms": [], "raw_ms": [],
           "raw_again_ms": [], "raw_8threads_ms": []}
    for _ in range(reps):
        again = tempfile.mkdtemp()
        raw(again)
        for key, fn in (("open_ms", buffered), ("raw_ms", raw),
                        ("raw_again_ms", raw), ("raw_8threads_ms", threaded)):
            d = again if key == "raw_again_ms" else tempfile.mkdtemp()
            t0 = time.perf_counter()
            fn(d)
            out[key].append(1e3 * (time.perf_counter() - t0))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="primary",
                    choices=["primary", "flagship", "flagship_mb", "run"])
    ap.add_argument("--ntraj", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--out", required=True,
                    help="directory for the traces and the summary")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_e2e: needs a CUDA device")
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    call, steps = workload(args.workload, torch.device("cuda", 0))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    summary = {"device": smi, "workload": args.workload}
    counts = [1] if args.workload == "run" else args.ntraj
    for n in counts:
        call(n)                                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(n)
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t0]
        undo = _wrap_spans()
        try:
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(n)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        finally:
            undo()
        path = os.path.join(args.out, f"trace_{args.workload}_{n}.json")
        prof.export_chrome_trace(path)
        summary[n] = {"wall_s": {"untraced": walls[0], "traced": walls[1]},
                      "traj_steps_per_s_untraced": steps(n) / walls[0],
                      **summarise(path, walls[1])}
        if args.workload != "run":
            summary[n]["kappa_writers"] = kappa_writers_ms(n)
        print(json.dumps({"ntraj": n, **summary[n]}), flush=True)
    with open(os.path.join(args.out, f"summary_{args.workload}.json"),
              "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
