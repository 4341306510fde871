"""Time kernel K1 at each trajectory tile, at the primary shapes.

    python -m sclmd_tpu_torch.tools.k1_sweep [--ntraj 256 512] [--reps 3]

Needs a CUDA card. For each trajectory count it times one 256-step block
(CUDA events, mean of ``--reps`` calls after a warm-up) with 1, 2 and 4
trajectories per CTA, and prints one JSON line per count with the times,
the tile ``gle_block.tile_size`` picks, and the largest difference of
each tile's outputs from that tile's (the tile changes no summation
order, so it is 0). The card's name and power limit come first.
"""

import argparse
import json
import subprocess

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ntraj", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_sweep: needs a CUDA device")
    import tempfile

    from sclmd_tpu_torch.kernels import gle_block as K1
    from sclmd_tpu_torch.tools.primary import (NC, NPH, block_operands,
                                               primary_runner)

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
    gen = torch.Generator(device=dev).manual_seed(1)
    pick = K1.tile_size
    for n in args.ntraj:
        _, ops, _ = block_operands(r, n, 7, gen)
        chosen = pick(n, NPH, 2, NC, dev)
        ref = K1.gle_block_cuda(*ops)
        ms, diff = {}, {}
        for tt in (1, 2, 4):
            K1.tile_size = lambda *a, _tt=tt: _tt
            try:
                out = K1.gle_block_cuda(*ops)
                diff[tt] = max(float((x - y).abs().max()) for x, y in
                               zip((out.p, out.q, out.cur, out.etot),
                                   (ref.p, ref.q, ref.cur, ref.etot)))
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    K1.gle_block_cuda(*ops)
                stop.record()
                torch.cuda.synchronize()
                ms[tt] = start.elapsed_time(stop) / args.reps
            finally:
                K1.tile_size = pick
        print(json.dumps({"ntraj": n, "tile_chosen": chosen,
                          "ms_per_block": ms, "max_abs_diff": diff}),
              flush=True)


if __name__ == "__main__":
    main()
