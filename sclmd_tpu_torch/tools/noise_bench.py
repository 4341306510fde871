"""Times of noise synthesis on the card: K3 at each trajectory-group
count its launch plan allows, beside the plan's own choice and the
library composition, at the main path's shapes.

    python -m sclmd_tpu_torch.tools.noise_bench [--reps 10]

Needs a CUDA card. Prints the card's name and power limit and one JSON
line with, for each case (the primary junction's 256-trajectory chunk,
md.Run's one-trajectory window, the flagship's chunks of its 128- and
1024-trajectory runs, the periodic sheet's 128 trajectories):

* ``plan``: ``kernels.noise_synth.launch_plan``'s choice;
* ``k3_ms``: K3 per trajectory-group count that fits (CUDA events, mean
  of ``--reps`` calls after a warm-up), each count's half spectrum held
  bitwise against the plan's (only the work-to-thread map changes);
* ``library_ms``: ``library_draw_product`` (no single PyTorch call
  computes K3's function);
* ``draws``: ``noise_times`` of the case's runner.

``event_ms`` and ``noise_times`` are also the draw timings of
``tools.plain_bench`` and ``tools.blocked_bench``.
"""

import argparse
import json
import subprocess
import tempfile

import torch


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


def noise_times(r, n, reps=5) -> dict:
    """Milliseconds (CUDA events) to make one chunk's noise for every
    bath of the runner ``r`` at ``n`` trajectories, thermal phases
    included (``draws_ms``: ``parallel.ensemble.draw_chunk``, K3 and K3b
    and the C2R transforms), and ``k3_ms``, K3 alone for the first
    bath."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.parallel import ensemble as E
    dev = r.device
    facs = E.bath_factors(r.baths, dev)
    ev, sd = facs[0]
    return {"draws_ms": event_ms(
                lambda: E.draw_chunk(facs, 5, 0, n, r.nph, dev, r.dtype,
                                     r.dt, r.nmd), reps),
            "k3_ms": event_ms(
                lambda: K3.noise_halfspectrum_cuda(ev, sd, 5, 0, 0, n),
                reps)}


def library_draw_product(ev, std, n):
    """The library's composition of K3's work: ``torch.randn`` x std, then
    ``torch.matmul`` (one matrix) or ``torch.einsum`` (a per-frequency
    batch). Other draws than the schedule's; the same shapes and
    products."""
    h, nc = std.shape
    x = (torch.randn((n, h, nc), device=std.device) * std).to(ev.dtype)
    if ev.ndim == 2:
        return torch.matmul(x, ev.T)
    return torch.einsum("wij,twj->twi", ev, x)


def group_sweep(ev, std, lo, hi, reps) -> dict:
    """K3's plan, its milliseconds per trajectory-group count and the
    library composition's, at one window."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    h, nc = std.shape
    batch = ev.ndim == 3
    nsm = torch.cuda.get_device_properties(std.device).multi_processor_count
    plan = K3.launch_plan(nc, hi - lo, h, batch, nsm)
    ref = K3.noise_halfspectrum_cuda(ev, std, 5, 0, lo, hi, plan=plan)
    k3_ms = {}
    for g in range(1, K3.MAX_GROUPS + 1):
        p = K3.launch_plan(nc, hi - lo, h, batch, nsm, groups=g)
        if p["groups"] != g:
            break
        got = K3.noise_halfspectrum_cuda(ev, std, 5, 0, lo, hi, plan=p)
        if not torch.equal(got, ref):
            raise AssertionError(f"K3 at {g} groups differs from its plan")
        k3_ms[g] = event_ms(
            lambda: K3.noise_halfspectrum_cuda(ev, std, 5, 0, lo, hi, plan=p),
            reps)
    return {"plan": plan, "k3_ms": k3_ms,
            "library_ms": event_ms(
                lambda: library_draw_product(ev, std, hi - lo), reps)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("noise_bench: needs a CUDA device")

    from sclmd_tpu_torch.parallel.ensemble import bath_factors
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools import primary as P
    from sclmd_tpu_torch.tools import sheet as S

    dev = torch.device("cuda", 0)
    out = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), "cases": {}}
    pr = P.primary_runner(torch.float32, dev, tempfile.mkdtemp())
    fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp())
    sr = S.sheet_runner(torch.float32, dev, tempfile.mkdtemp())
    fchunks = {n: max(F.chunk_sizes(fr._build_system(), n))
               for n in (128, 1024)}
    cases = {"primary_256": (pr, 0, 256), "run_window": (pr, 1, 2),
             **{f"flagship_{c}": (fr, 0, c) for c in fchunks.values()},
             "sheet_128": (sr, 0, 128)}
    for name, (r, lo, hi) in cases.items():
        ev, std = bath_factors(r.baths, dev)[0]
        res = group_sweep(ev, std, lo, hi, args.reps)
        res["draws"] = noise_times(r, hi - lo, args.reps)
        out["cases"][name] = res
        print(json.dumps({name: res}), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
