"""Time the blocked path's kernels and ``RunEnsemble`` at the primary
shapes, for comparing two trees of the port on one card.

    python -m sclmd_tpu_torch.tools.blocked_bench [--label NAME]
        [--ntraj 256 512] [--e2e 256 1024]

Needs a CUDA card. Measures the package it is imported from, so two
trees that both have ``tools.noise_bench`` are compared by running this
file from the root of each checkout (``PYTHONPATH=.`` and the file's
path). Prints one JSON line: the
card's name and power limit, K1 milliseconds per 256-step block and K2
milliseconds per call at each ``--ntraj`` (CUDA events, mean of
repetitions after a warm-up, on the operands chip_smoke.py checks), the
einsum that computes K2's function, the chunk's draws and noise synthesis
(``tools.noise_bench.noise_times``), and the host wall time and
trajectory-steps per second of ``RunEnsemble`` at each ``--e2e`` count
(nsteps 2048, block 256, after one warm-up call of each size).
"""

import argparse
import json
import subprocess
import tempfile
import time

import torch

from sclmd_tpu_torch.tools.noise_bench import event_ms, noise_times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--ntraj", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--e2e", type=int, nargs="+", default=[256, 1024])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("blocked_bench: needs a CUDA device")

    from sclmd_tpu_torch.kernels import block_corr as K2
    from sclmd_tpu_torch.kernels import gle_block as K1
    from sclmd_tpu_torch.tools.primary import (BLOCK, NMD, block_operands,
                                               primary_runner)

    dev = torch.device("cuda", 0)
    out = {"label": args.label, "device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), "kernels": {}, "e2e": {}}
    r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
    gen = torch.Generator(device=dev).manual_seed(1)
    for n in args.ntraj:
        _, ops, corr = block_operands(r, n, 7, gen)
        khat, hhat = corr[0]
        out["kernels"][n] = {
            "k1_ms_per_block": event_ms(lambda: K1.gle_block_cuda(*ops), 3),
            "k2_ms": event_ms(lambda: K2.block_corr_freq_cuda(khat, hhat), 20),
            "einsum_ms": event_ms(lambda: torch.einsum(
                "fab,tfb->tfa", khat, torch.conj(hhat)), 20),
            "noise": noise_times(r, n)}
        del ops, corr, khat, hhat
    r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
    for n in args.e2e:
        r.RunEnsemble(n, nsteps=NMD, block=BLOCK)
    for n in args.e2e:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.RunEnsemble(n, nsteps=NMD, block=BLOCK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["e2e"][n] = {"s": wall, "traj_steps_per_s": n * NMD / wall}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
