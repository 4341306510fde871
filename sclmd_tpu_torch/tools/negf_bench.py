"""Times of the NEGF stack on the card: the harmonic flagship's Caroli
sweep (``tools.flagship.flagship_bpt``: nd 483, leads of 150, 4,001
points, complex128) and what its batched solve does at other batch
counts.

    python -m sclmd_tpu_torch.tools.negf_bench [--reps 3] [--out FILE]

Needs a CUDA card. Prints one JSON line per case, then the whole record
(also written to ``--out``), beside the card's name and power limit:

- ``sweep``: ``gettm`` in seconds (host clock, after a warm-up sweep) at
  solve groups of 32 (the port's ``negf.SOLVE_GROUP``) and larger ones
  (the module's group set for the measurement and restored), each with
  its largest difference in T from the groups of 32, over max T; the
  bound is ``negf_flops`` of the sweep at the FP64 tensor-core peak;
- ``batches``: per linear-algebra backend torch offers (``default``,
  ``cusolver``, ``magma``) and batch count, ``torch.linalg.solve_ex``'s
  milliseconds per matrix on the grid's first matrices (CUDA
  events, mean of ``--reps``) and whether the LU and the solution of
  the first 32 have the bits they have in a batch of 32.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

PEAK_FP64_TC = 67e12          # H100 SXM data sheet, dense FP64 tensor core
GROUPS = (32, 128, 512, 4032)
COUNTS = (1, 8, 32, 33, 64, 128, 512, 4001)
LIBS = ("default", "cusolver", "magma")


def negf_flops(nd, nl):
    """Real operations of one frequency point: the complex LU (8/3 nd^3)
    and the solves for the nl left-bath columns (8 nd^2 nl)."""
    return 8.0 / 3.0 * nd ** 3 + 8.0 * nd ** 2 * nl


def events_ms(fn, reps):
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


def sweep_cases(b, groups=GROUPS):
    """``gettm`` at each solve group (the chunk built at once equal to
    the group), against the groups of 32."""
    from sclmd_tpu_torch import negf as N
    nd, nl = b.nd, len(b.dofatomofbath[0])
    npts = b.intnum + 1
    keep = (N.SOLVE_GROUP, b.batch_size)
    out, ref = [], None
    try:
        for g in groups:
            N.SOLVE_GROUP, b.batch_size = g, g
            b.gettm()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tm = b.gettm()[:, 1].copy()
            s = time.perf_counter() - t0
            ref = tm if ref is None else ref
            flops = negf_flops(nd, nl) * npts
            rec = {"case": "sweep", "group": g, "s": s,
                   "ms_per_point": 1e3 * s / npts,
                   "bound_ms": 1e3 * flops / PEAK_FP64_TC,
                   "share_of_bound": flops / PEAK_FP64_TC / s,
                   "rel_diff_vs_32": float(np.abs(tm - ref).max()
                                           / np.abs(ref).max())}
            print(json.dumps(rec), flush=True)
            out.append(rec)
            torch.cuda.empty_cache()
    finally:
        N.SOLVE_GROUP, b.batch_size = keep
    return out


def batch_cases(b, reps, counts=COUNTS, libs=LIBS):
    """``solve_ex`` per backend and batch count on the first frequencies
    of the grid (the flagship's matrix is regular at w = 0), with the
    bits of the first 32 against a batch of 32."""
    ws = torch.as_tensor(np.linspace(0, b.maxomega, b.intnum + 1),
                         device=b.device)
    sel = b._sel(b.dofatomofbath[0])
    chosen = torch.backends.cuda.preferred_linalg_library()
    out = []
    try:
        for lib in libs:
            try:
                torch.backends.cuda.preferred_linalg_library(lib)
            except RuntimeError as e:      # a backend this build lacks
                out.append({"case": "batch", "lib": lib,
                            "error": str(e)[:200]})
                continue
            ref = None
            for nb in sorted(counts, key=lambda n: n != 32):
                a = b._amatrix(ws[:nb])
                rhs = b._unit_columns(sel, nb)
                lu = torch.linalg.lu_factor_ex(a)[0]
                x = torch.linalg.solve_ex(a, rhs)[0]
                ms = events_ms(lambda: torch.linalg.solve_ex(a, rhs), reps)
                m = min(nb, 32)
                if ref is None:
                    ref = (lu[:32].clone(), x[:32].clone())
                rec = {"case": "batch", "lib": lib, "count": nb, "ms": ms,
                       "ms_per_matrix": ms / nb,
                       "lu_bits_as_32": bool(torch.equal(lu[:m], ref[0][:m])),
                       "x_bits_as_32": bool(torch.equal(x[:m], ref[1][:m])),
                       "x_rel_diff": float((x[:m] - ref[1][:m]).abs().max()
                                           / ref[1][:m].abs().max())}
                print(json.dumps(rec), flush=True)
                out.append(rec)
                del a, rhs, lu, x
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.preferred_linalg_library(chosen)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("negf_bench: no CUDA device")
    from sclmd_tpu_torch.tools.flagship import flagship_bpt
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    b = flagship_bpt(dev)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi,
           "nd": b.nd, "n_left": len(b.dofatomofbath[0]),
           "points": b.intnum + 1, "sweep": sweep_cases(b),
           "batches": batch_cases(b, args.reps)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
