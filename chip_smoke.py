"""Smoke run of the PyTorch/CUDA port on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with a CUDA card and ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda).

Phases (each prints one line; any failure raises, so the exit code is
not 0 and no result line is printed):

1. device name and power limit (nvidia-smi); full-fp32 precision pinned;
2. build of the hand-written kernels (nvcc, sm_90a) and its seconds;
3. K2 ``block_corr_freq`` against its plain twin at the primary shapes
   (nf 1025, nc 90), at every chunk size phase 5 runs (256 and 512
   trajectories, from ``auto_chunk``);
4. K1 ``gle_block`` against its plain twin over one 256-step block at
   the same chunk sizes, which reach one- and two-trajectory tiles;
5. the main path: ``md.md`` with two phonon baths, then
   ``RunEnsemble(256)`` and ``RunEnsemble(1024)`` at nsteps 2048,
   block 256, after one warm-up call of each, with the kernels' launch
   counters read around it;
6. ``fused_chunk`` with 4 trajectories x 512 steps and injected draws,
   on the card (kernels) and on the CPU (plain twins, float64);
7. kernel and twin times at each chunk size (CUDA events).

The workload is the primary junction of bench.py
(``sclmd_tpu_torch.tools.primary``): a 100-atom harmonic chain (nph 300),
two non-local phonon baths of 90 DOFs with 1000 memory taps, nmd 2048,
dt 0.25/0.658, T 300 K +- 5 %. The line before the last is the card's
name and power limit; the last line is the result JSON.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Tolerances: float32 kernels against their float32 twins (phases 3, 4)
# and against float64 CPU runs (phase 6). Sums run in another order on
# the card, so agreement is to float32 rounding; the error is measured
# relative to the largest magnitude of each compared quantity, since
# individual heat-current samples pass through zero.
RTOL = 1e-4
SIZES = (256, 1024)     # RunEnsemble trajectory counts of phase 5


def rel_err(a, b):
    """(max |a-b| / max |b|, max |a-b|), complex compared as re/im."""
    a, b = (torch.view_as_real(x) if x.is_complex() else x for x in (a, b))
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300)), \
        float((a - b).abs().max())


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    import sclmd_tpu_torch
    from sclmd_tpu_torch.kernels import block_corr as K2
    from sclmd_tpu_torch.kernels import build
    from sclmd_tpu_torch.kernels import gle_block as K1
    from sclmd_tpu_torch.parallel.ensemble import bath_factors, fused_chunk
    from sclmd_tpu_torch.tools.primary import (BLOCK, NC, NMD, NPH, T,
                                               block_operands, chunk_sizes,
                                               primary_runner)

    dev = torch.device("cuda", 0)

    # 1. device and precision
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    assert sclmd_tpu_torch.precision_pinned(), "TF32 is not disabled"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    print(json.dumps({"phase": 1, "device": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "tf32": False}), flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    with open(lib_path[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(json.dumps({"phase": 2, "build_s": build_s,
                      "nvcc_s": build.build_seconds, "ptxas": ptxas}),
          flush=True)

    # 3, 4. K2 and K1 against their twins at every chunk shape that
    # phase 5's RunEnsemble calls give them (thermal start, real noise,
    # pre-block tails of a random history)
    gen = torch.Generator(device=dev).manual_seed(1)
    r = primary_runner(torch.float32, dev, tempfile.mkdtemp())
    shapes = sorted({n for ntraj in SIZES
                     for n in chunk_sizes(r._build_system(), ntraj)})
    operands, k1_abs, k2_abs, tiles = {}, 0.0, 0.0, {}
    for n in shapes:
        _, args, corr = block_operands(r, n, 7, gen)
        khat, hhat = corr[0]
        operands[n] = (args, khat, hhat)
        k2_rel, err = rel_err(K2.block_corr_freq_cuda(khat, hhat),
                              K2.block_corr_freq_plain(khat, hhat))
        k2_abs = max(k2_abs, err)
        print(json.dumps({"phase": 3, "shape": list(hhat.shape),
                          "rel_err": k2_rel, "max_abs_err": err,
                          "rtol": RTOL}), flush=True)
        assert k2_rel <= RTOL, f"K2 disagrees with its twin: {k2_rel}"

        tiles[n] = K1.tile_size(n, NPH, 2, NC, dev)
        k1_out = K1.gle_block_cuda(*args)
        k1_ref = K1.gle_block_plain(*args)
        k1_errs = {name: rel_err(getattr(k1_out, name),
                                 getattr(k1_ref, name))
                   for name in ("p", "q", "pf", "qprev", "cur", "etot")}
        for i, (a_, b_) in enumerate(zip(k1_out.rings, k1_ref.rings)):
            k1_errs[f"ring{i}"] = rel_err(a_, b_)
        k1_rel = max(v[0] for v in k1_errs.values())
        k1_abs = max(k1_abs, max(v[1] for v in k1_errs.values()))
        print(json.dumps({"phase": 4, "ntraj": n, "tile": tiles[n],
                          "rel_err_max": k1_rel, "rtol": RTOL}), flush=True)
        assert k1_rel <= RTOL, f"K1 disagrees with its twin: {k1_errs}"
        del k1_out, k1_ref
    # the kernel's multi-trajectory tiles (per-tile indexing, ragged
    # tiles) are on the main path at these sizes on a 132-SM card
    assert max(tiles.values()) > 1, tiles

    # 5. the main path through the user's entry points
    outdir = tempfile.mkdtemp()
    r = primary_runner(torch.float32, dev, outdir)
    for ntraj in SIZES:     # warm-up of every chunk shape timed below
        r.RunEnsemble(ntraj, nsteps=NMD, block=BLOCK)
    torch.cuda.synchronize()
    K1.reset_count()
    K2.reset_count()
    e2e = {}
    for ntraj in SIZES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means = r.RunEnsemble(ntraj, nsteps=NMD, block=BLOCK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert means.shape == (ntraj, 2) and np.isfinite(means).all()
        e2e[ntraj] = {"s": wall, "traj_steps_per_s": ntraj * NMD / wall,
                      "J_left": float(means[:, 0].mean()),
                      "J_right": float(means[:, 1].mean())}
    launches = {"gle_block": K1.launches, "block_corr_freq": K2.launches}
    assert launches["gle_block"] > 0 and launches["block_corr_freq"] > 0, \
        launches
    nfiles = len([f for f in os.listdir(outdir) if f.startswith("kappa.")])
    assert nfiles == max(SIZES) * 2, nfiles
    print(json.dumps({"phase": 5, "launches": launches, "e2e": e2e}),
          flush=True)

    # 6. the same chunk on the card and on the CPU, injected draws
    rng = np.random.default_rng(11)
    rs_np = [rng.standard_normal((4,) + np.shape(b.nstd)) for b in r.baths]
    us_np = rng.uniform(size=(4, NPH))
    out = []
    for dtype, device in ((torch.float32, dev), (torch.float64, "cpu")):
        rr = primary_runner(dtype, device, tempfile.mkdtemp())
        out.append(fused_chunk(
            rr._build_system(), bath_factors(rr.baths, device),
            [torch.as_tensor(x, dtype=dtype, device=device) for x in rs_np],
            torch.as_tensor(us_np, dtype=dtype, device=device),
            rr.hw, rr.U, T, 512, 0, BLOCK, 128))
        assert bool(out[-1][2])
    (fg, sg, _), (fc, sc, _) = out
    cur_rel = rel_err(sg, sc)[0]
    p_rel, q_rel = rel_err(fg.p, fc.p)[0], rel_err(fg.q, fc.q)[0]
    print(json.dumps({"phase": 6, "cur_rel": cur_rel, "p_rel": p_rel,
                      "q_rel": q_rel, "rtol": RTOL}), flush=True)
    assert max(cur_rel, p_rel, q_rel) <= RTOL, (sg, sc)

    # 7. kernel and twin times at each chunk shape (phase 4's operands)
    times = {}
    for n, (args, khat, hhat) in operands.items():
        times[n] = {
            "gle_block": cuda_ms(lambda: K1.gle_block_cuda(*args), 5),
            "gle_block_plain": cuda_ms(lambda: K1.gle_block_plain(*args), 2),
            "block_corr_freq": cuda_ms(
                lambda: K2.block_corr_freq_cuda(khat, hhat), 20),
            "block_corr_freq_plain": cuda_ms(
                lambda: K2.block_corr_freq_plain(khat, hhat), 20)}
    print(json.dumps({"phase": 7, "ms": times}), flush=True)

    # the per-kernel line gives the times at the smallest chunk shape
    t = times[shapes[0]]
    kernels = [
        {"name": "gle_block", "route": "cuda",
         "source": "sclmd_tpu_torch/csrc/gle_block.cu",
         "replaces": "sclmd_tpu/md.py:532", "launches": launches["gle_block"],
         "max_abs_err": k1_abs, "ms": t["gle_block"],
         "plain_ms": t["gle_block_plain"]},
        {"name": "block_corr_freq", "route": "cuda",
         "source": "sclmd_tpu_torch/csrc/block_corr.cu",
         "replaces": "sclmd_tpu/baths.py:593",
         "launches": launches["block_corr_freq"], "max_abs_err": k2_abs,
         "ms": t["block_corr_freq"], "plain_ms": t["block_corr_freq_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
