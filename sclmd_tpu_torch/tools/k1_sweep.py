"""Time kernel K1 (near- and far-tap kernels) at each sub-block length
and trajectory tile, at the primary shapes.

    python -m sclmd_tpu_torch.tools.k1_sweep [--ntraj 256 512]
        [--sub 8 12 16 32 64] [--tiles 1 2 4] [--reps 3]

Needs a CUDA card. For each trajectory count it times one 256-step block
(CUDA events, mean of ``--reps`` calls after a warm-up) at every
sub-block length S and trajectory tile, and prints one JSON line per
count with the milliseconds per block (null where a tile does not fit
shared memory), the sub-block length and tile the wrappers pick, and
the largest relative difference of each setting's outputs from the
whole-block plain twin. The card's name and power limit come first.
"""

import argparse
import json
import subprocess

import torch


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ntraj", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--sub", type=int, nargs="+",
                    default=[8, 12, 16, 32, 64])
    ap.add_argument("--tiles", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_sweep: needs a CUDA device")
    import tempfile

    from sclmd_tpu_torch.kernels import gle_block as K1
    from sclmd_tpu_torch.tools.primary import (BLOCK, NC, NPH,
                                               block_operands,
                                               primary_runner)

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
    gen = torch.Generator(device=dev).manual_seed(1)

    def timed(sub, tt):
        """(block output, ms per block) at sub-block ``sub`` and tile
        ``tt``; None for a tile past shared memory."""
        saved = K1.sub_steps, K1.tile_size
        K1.sub_steps = lambda block: min(block, sub)
        K1.tile_size = lambda *a: tt
        try:
            try:
                out = K1.gle_block_cuda(*ops)
                torch.cuda.synchronize()
            except RuntimeError:
                return None
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                K1.gle_block_cuda(*ops)
            stop.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(stop) / args.reps
        finally:
            K1.sub_steps, K1.tile_size = saved

    for n in args.ntraj:
        _, ops, _ = block_operands(r, n, 7, gen)
        ref = K1.gle_block_plain(*ops)
        sub = K1.sub_steps(BLOCK)
        chosen = {"sub": sub, "tile": K1.tile_size(n, NPH, 2, NC, sub, dev)}
        ms, err = {}, {}
        for sub in args.sub:
            for tt in args.tiles:
                key = f"S{sub}_T{tt}"
                res = timed(sub, tt)
                ms[key] = err[key] = None
                if res is not None:
                    out, ms[key] = res
                    err[key] = max(_rel(getattr(out, k), getattr(ref, k))
                                   for k in ("p", "q", "cur", "etot"))
        print(json.dumps({"ntraj": n, "chosen": chosen,
                          "ms_per_block": ms, "rel_err": err}), flush=True)


if __name__ == "__main__":
    main()
