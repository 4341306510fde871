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
4. K1 at the same chunk sizes: the near-tap kernel (``gle_near``, one
   sub-block) and the far-tap kernel (``gle_far``, one update) each
   against its twin on the same tensors, then one 256-step block of the
   pair (``gle_block_cuda``) against the whole-block twin
   ``gle_block_plain``; the sizes reach two- and four-trajectory tiles;
5. the main path: ``md.md`` with two phonon baths, then
   ``RunEnsemble(256)`` and ``RunEnsemble(1024)`` at nsteps 2048,
   block 256, after one warm-up call of each, with the kernels' launch
   counters read around it (K3 once per bath and chunk, K3b once per
   chunk) and no ``torch.Generator`` made;
6. ``fused_chunk`` with 4 trajectories x 512 steps and injected draws,
   on the card (kernels) and on the CPU (plain twins, float64);
7. kernel, twin and library times (CUDA events) at each chunk size: K1's
   near and far kernels over one block (all their launches of a block),
   K2 per call; K6 at the primary shapes for one trajectory and for 37;
   K7's three stages at its three main-path shapes (one trajectory on
   the primary junction, the flagship at each chunk size of phase 10),
   with the profiler's device duration (``device_ms``) beside the event
   time, which for so short a kernel is the host's time to enqueue it;
   K5 at each chunk size of phase 13, with its float32 twin's time;
   K3 at every chunk shape of phases 5, 10 and 15 (and phase 16's other
   cases) by events and by the profiler's device time, with its twin,
   the C2R stage on its output (one cuFFT plan and the hand transpose
   ``noise_transpose``, also timed alone against torch's transpose), the
   whole ``schedule_noise``, and the library composition ``torch.randn``
   + ``torch.matmul``/``torch.einsum`` + ``hfft``, and the C2R stage's
   one-call counterpart ``torch.fft.hfft`` on the same half spectrum
   (alone, and made contiguous in the stage's layout); K3b at each thermal
   start by device and event time, with its twin, the composition
   ``torch.rand`` + the same formula, and the whole start (K3b and the
   product); with the least time the card could take for each
   (``bound_ms``; K3's products as 3xTF32 on the tensor cores);
8. K6 ``conv_tails`` and K7 ``bath_force`` against their twins: K6 at
   the primary shapes for one trajectory and a ragged batch of 37; K7
   on the primary phonon baths with K6's tails at one trajectory and at
   37, at the flagship shapes at each chunk size of phase 10, and on a
   biased electron bath;
9. the plain path through ``md.Run`` on the primary junction (no block,
   nmd 2048, runs 0 and 1 in two segments each, power spectra on),
   after a warm-up run, with K6/K7 and K3/K3b launch counters read
   around it;
10. ``RunEnsemble`` on the plain path (no block) on the harmonic
   flagship at 128 and 1024 trajectories, nsteps 1024, after a warm-up
   of each, with K7's and K3/K3b's launch counters read around it; the
   same calls on a runner with the two leads' temperatures swapped give
   the heat currents' sign from common random numbers;
11. 512 plain steps of the ``md.Run`` path (primary, one trajectory) and
   of the flagship ensemble chunk (4 trajectories), injected draws, on
   the card (kernels) and on the CPU (twins, float64);
12. K5 ``ch_force`` at each chunk size of phase 13, at thermal
   displacements: against its autograd twin in float64 on the CPU, and
   against the same twin in float32 on the card; repeated calls agree
   bitwise; then a periodic C/H sheet (``graphene_ribbon(3, 3)`` with its
   cell) and a ribbon whose carbon table is 20 wide (skin 2.5 angstrom),
   each at 128 trajectories against its float64 twin, bitwise repeats,
   exactly zero at rest;
13. ``RunEnsemble`` on the many-body flagship (the C/H force driver
   through ``AddPotential``: K5 twice a step, K7 three times) at 128 and
   1024 trajectories, nsteps 1024, after a warm-up of each, with both
   launch counters (and K3/K3b's) read around it, a bounded kinetic
   energy at the end,
   and the heat currents' sign from a runner with swapped temperatures on
   the same draws;
14. 48 many-body steps of a 4-trajectory flagship chunk, injected draws,
   on the card (K5, K7) and on the CPU (twins, float64);
15. K8, the Tersoff-only entry of the same kernel, on its runner path:
   the periodic 192-atom graphene sheet (``tools.sheet``: a single-element
   ``TersoffDriver`` in float32 with its lattice cell, through
   ``AddPotential``) against its float64 twin at 128 trajectories of
   thermal displacements (bitwise repeat, zero at rest) with its kernel,
   twin and bound times; ``RunEnsemble(128)`` with the launch counters
   read around it (K3; no K3b: the sheet starts at rest); 48 steps of a
   4-trajectory chunk on the card and in float64 on the CPU, injected
   draws;
16. K3 ``noise_synth`` and K3b ``init_draw`` against their twins (the
   same Philox integers; float64 Box-Muller and product on the card) at
   the primary junction's factors (one matrix, nc 90, nmd 2048), the
   flagship's (one matrix, nc 150, nmd 1024), the sheet's (one matrix,
   nc 48, nmd 1024), a per-frequency batch of the primary's widths and
   a random proportional spectrum of nc 37 (padded to 40), at every
   chunk shape of phases 5, 10 and 15 and at md.Run's one-trajectory
   window of phase 9: the scaled draw within 1e-6 of its largest value
   (``draw_only``), the folded half spectrum and its series within RTOL
   of their largest, the edge rows real, bitwise repeats and the same
   bits at every launch shape the plan allows, ``noise_transpose``
   bitwise its twin; K3b's uniforms bitwise,
   its amplitudes within 1e-6 of the float64 twin's, the start (K3b and
   the product) within RTOL of ``thermal_init`` on the same uniforms;
   one trajectory's series bitwise the same from a chunk of 256 and one
   of 64; the sample variance and lag-1 autocorrelation of a
   1024-trajectory draw within 5 standard errors of the values the
   factors give;
17. the correctness gate: the MD-vs-NEGF thermal conductance of the
   harmonic flagship (``antithetic_run`` with the periodic warm start,
   256 trajectories, nmd 2^14, T 300 K, delta T 10 %, seed 11, float32)
   against ``j_nat`` of ``scripts/flagship_negf.npz``: ``|dev_pct| <= 2``
   and ``sem_pct <= 1``, with the deviation from phase 20's ``j_nat``
   beside it (phase 20 runs before it);
18. K9 ``sw_force`` on the 3,456-atom silicon slab of
   ``sclmd_tpu_torch.tools.slab`` (nph 10,368, a table 16 wide, periodic
   cell): against its float32 twin on the card and its float64 twin on
   the CPU at 4 trajectories of thermal displacements (force and energy
   within RTOL of the largest), bitwise repeats, zero at rest; at the
   run's 64 trajectories and at 65 (a last warp of one lane) against its
   float32 twin again, a bitwise repeat, trajectories run alone with the
   same bits as in the batch, the wide route (rows from global memory)
   with the same bits, how the cutoff tests of a warp's 32 trajectories
   agree (``tools.slab_bench.lane_agreement``), its time, its twin's
   and its bound, and PR 9's kernel timed in the same call where a tree
   of that commit is found (``_checkout/parent`` or ``git archive``: the
   "earlier" column, before and after phases 18 and 19); on small
   periodic, open and truncated diamond cells and powers that are not
   integers, at 1, 37, 64 and 65 trajectories, against its float64 twin
   (force within RTOL, energy within 1e-5 of the largest), bitwise
   repeats, zero at rest; K3 at the slab's bath
   factors (nc 864, U read from global memory) and 64 trajectories
   against its twins as phase 16 holds it, and timed; K7 at the slab's
   shapes and 64 trajectories on its unstaged route, against its twins
   and timed; then
   ``RunEnsemble(64, nsteps=1024, npie=2, checkpoint=True)`` with the
   launch counters read around it (K9 twice a step, K7 three times, all
   on its unstaged route, K3 once per bath; no K6: baths of memory
   length 1 read no history): finite currents, ``MDE.npz``, the same
   means within RTOL from one segment, a second call after the kappa
   files are deleted resuming from ``MDE.npz`` (no K9 launch, the same
   means and files), another chunk refused as a stale checkpoint, the
   lanes' agreement at the run's end state (``MDE.npz``), and the heat
   current's sign from the same draws at swapped lead temperatures;
19. K10 ``eam_force`` on the 1,728-atom gold slab (nph 5,184, analytic
   Sutton-Chen and its ``sutton_chen_tables`` tabulation): each mode
   against its twins as in phase 18 (small fcc cells: periodic, open,
   truncated, powf powers, tabulated, two elements), the tabulated force
   within the splines' own error (the two float64 twins' difference) of
   the analytic one at the same geometry, K3 at nc 432, K7 (staged), the
   analytic slab through every check of phase 18's run, and the
   tabulated one through ``RunEnsemble(64, npie=2, checkpoint=True)``
   with its launch counts;
20. the harmonic flagship's NEGF on the card (``negf.bpt`` from the
   committed ``dyn_ev2``, nd 483 after 120 fixed DOFs, leads of 150,
   4,001 points, complex128 ``torch.linalg`` solves in groups of 32; no
   hand kernel): T(w) within 1e-9 of max T of the committed ``tm`` at every
   point, ``landauer_current_natural``'s ``j_nat`` and
   ``thermalconductance`` within 1e-9 relative of the committed values,
   the whole grid in one chunk within 1e-12 of max T of the chunks of
   32 (the solves take groups of 32 either way); the sweep's seconds
   after a warm-up against its bound (the LU and the column solves'
   operations at the FP64 tensor-core peak), one group's solve and
   assembly alone;
21. ``selfenergy.sig`` at examples/runsig.py's configuration (the
   graphene strip, layers of four atoms, 401 points) on the card against
   the CPU, complex128: Sigma_L, Sigma_R and T within 1e-10 of their
   largest magnitudes and the same decimation count for each frequency
   at w > 0 (w = 0 is printed: it is ill-conditioned in the reference
   itself), timed after a warm-up; then ``RunEnsemble(512)`` of an
   8-atom chain between two lead-block phonon baths
   (``phbath(K00=, K01=, V01=)``, semi-infinite chain leads, mode "K")
   on the blocked path (K1, K2, K3, K3b launched), and the heat current's
   sign from the same draws at swapped lead temperatures;
22. the Lambda pipeline (``postprocess.lambda_pipeline``) and
   ``postprocess.hssigma.kaverage_extract`` on the card (complex128
   ``torch.linalg``, ``torch.fft`` and complex GEMMs; no hand kernel):
   the spectral functions, ``wideband``, every array of ``full_lambda``
   and ``kaverage_extract`` at 4 k points against the CPU within 1e-9 of
   their largest values, at examples/current_induced/rundp.py's model
   with 24 orbitals, 12 modes and 512 energies; then at 96 orbitals, 60
   modes and 2048 energies ``LambdaPipeline.write`` timed by section
   (the spectral functions, ``wideband``, each of the ten correlations)
   against its FP64 bound, with ``mode_chunk``, the peak memory and the
   invariants (eta symmetric, xim and zeta2 antisymmetric, LamEqu
   real-symmetric, zero outside the hwcut mask); ``kaverage_extract`` at
   8 k points, 96 orbitals, 512 energies, timed;
23. the harmonic flagship with a third electron bath on its 183 centre
   DOFs at T 300 K, bias 0.5 (``tools.flagship.biased_flagship_runner``;
   its five matrices from ``LambdaPipeline.wideband`` on the card at
   rundp's model with 96 orbitals and the 183 DOFs as modes, scaled to
   the leads' friction, written with ``WritewbLambda`` and read back):
   ``RunEnsemble(256)`` with K7 three times a step (the biased bath on
   its wind/Berry route), K3 per bath and chunk (the leads proportional,
   the centre on the per-frequency route), K3b per chunk, no
   ``torch.Generator``, bounded kinetic energy; ``calHF(bathnum=3)`` and
   ``calTC(delta=0.1, bathnum=3)`` on its 768 kappa files against the
   run's mean currents to the files' printed precision; 48 steps of 2
   trajectories on the card against float64 on the CPU within 1e-4 of the
   largest; K3's per-frequency route on this bath's factors (nf 513, nc
   183) against its twins as phase 16 holds it, and timed.

The workloads are the primary junction of bench.py
(``sclmd_tpu_torch.tools.primary``: a 100-atom harmonic chain, nph 300,
two non-local phonon baths of 90 DOFs with 1000 memory taps, nmd 2048,
dt 0.25/0.658, T 300 K +- 5 %) and its harmonic flagship
(``sclmd_tpu_torch.tools.flagship``: the 201-atom C/H junction, nph 603,
two electron baths of 150 DOFs, 120 DOFs fixed, nmd 1024; many-body:
the same junction with ``CHDriver`` forces on the npz geometry), and the
periodic graphene sheet of ``sclmd_tpu_torch.tools.sheet``, and the
silicon and gold slabs of ``sclmd_tpu_torch.tools.slab``. The line
before the last is the card's name and power limit; the last line is
the result JSON; the line before it lists every kernel with its
launches on the main path, error against its twin, time, twin time,
library time (one PyTorch call computing the same function, where there
is one) and bound.
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
# K3's scaled draw against its float64 twin: float32 logf/sincospif
# against float64 libm, a few float32 roundings of values up to ~5.8
DRAW_RTOL = 1e-6
# the cross-check gate (phase 17): MD within 2 % of NEGF, resolved to 1 %
GATE_DEV_PCT, GATE_SEM_PCT = 2.0, 1.0
SIZES = (256, 1024)     # RunEnsemble trajectory counts of phase 5
FLAG_SIZES = (128, 1024)  # plain-path RunEnsemble counts of phases 10, 13
SHEET_NTRAJ = 128       # RunEnsemble trajectories on the sheet, phase 15
# K5 against its twins (phase 12). The float64 twin on the CPU is the
# yardstick, at RTOL of the largest force. The float32 twin on the card
# rounds each 50-angstrom coordinate to 4e-6 angstrom before it takes a
# bond's difference, which the kernel does not (it adds displacements to
# reference difference vectors): the two float32 results differ by that
# rounding, ~1e-5 in the force's units against forces of ~0.2
K5_TWIN32_RTOL = 1e-3
# a trajectory's kinetic energy at the end of a many-body run: 483 free
# DOFs at 300 K hold ~20 eV, zero-point motion included; a force
# that is a little wrong heats the junction by orders of magnitude
KE_BOUND = 100.0
# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W):
# float32 outside the tensor cores, TF32 on them, and HBM bandwidth. A
# bound is the larger of the operations over the peak of their type and
# the bytes over HBM's rate; a 3xTF32 kernel (K2, the far taps) does
# three TF32 products for each float32 product
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_HBM = 3.35e12
# FP64 on the tensor cores (the same data sheet): the NEGF solves' peak
PEAK_FP64_TC = 67e12
# the flagship's NEGF on the card (phase 20) against the committed sweep
# that the JAX package made on the CPU in float64: T(w) within 1e-9 of
# max T at every point, j_nat and kappa_bpt within 1e-9 relative (the
# same Caroli solve with the DOFs in another order moves T by 4e-12 of
# max T, so rounding alone stays 250 times inside); the sweep in chunks
# of 32 against one chunk of all 4,001 points within 1e-12 of max T
NEGF_RTOL, NEGF_BATCH_RTOL = 1e-9, 1e-12
# the decimation on the card against the CPU, both complex128 (phase 21)
SIG_RTOL = 1e-10
# the Lambda pipeline and kaverage_extract on the card against the CPU,
# both complex128 (phase 22), each output relative to its largest value
LAMBDA_RTOL = 1e-9
# phase 22's shapes: (orbitals, modes, energies, k points) of the card
# against the CPU; (orbitals, modes, energies, mode_chunk) of the full
# size; (k points, orbitals, energies) of kaverage_extract at full size
LAMBDA_SMALL = (24, 12, 512, 4)
LAMBDA_FULL = (96, 60, 2048, 8)
KAVERAGE_FULL = (8, 96, 512)


def bound_ms(ops, nbytes, peak=PEAK_F32):
    return 1e3 * max(ops / peak, nbytes / PEAK_HBM)


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


class GeneratorCount:
    """Counts the ``torch.Generator`` objects made while it is active (the
    main path must make none: its draws are K3's and K3b's)."""

    def __enter__(self):
        self.n, self.real = 0, torch.Generator

        def make(*a, **k):
            self.n += 1
            return self.real(*a, **k)

        torch.Generator = make
        return self

    def __exit__(self, *exc):
        torch.Generator = self.real


def k3_counts():
    from sclmd_tpu_torch.kernels import noise_synth as K3
    return {"noise_synth": K3.launches, "init_draw": K3.launches_init,
            "noise_transpose": K3.launches_transpose}


def reset_k3():
    from sclmd_tpu_torch.kernels import noise_synth as K3
    K3.reset_count()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    import sclmd_tpu_torch
    from sclmd_tpu_torch.kernels import block_corr as K2
    from sclmd_tpu_torch.kernels import build
    from sclmd_tpu_torch.kernels import gle_block as K1
    from sclmd_tpu_torch.md import thermal_init
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
        ptxas = [ln.strip() for ln in f
                 if any(w in ln for w in ("entry function", "registers",
                                          "spill"))]
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
    operands, tiles = {}, {}
    errs = {"block_corr_freq": 0.0, "gle_near": 0.0, "gle_far": 0.0}
    for n in shapes:
        _, args, corr = block_operands(r, n, 7, gen)
        khat, hhat = corr[0]
        operands[n] = (args, khat, hhat)
        k2_rel, err = rel_err(K2.block_corr_freq_cuda(khat, hhat),
                              K2.block_corr_freq_plain(khat, hhat))
        errs["block_corr_freq"] = max(errs["block_corr_freq"], err)
        print(json.dumps({"phase": 3, "shape": list(hhat.shape),
                          "rel_err": k2_rel, "max_abs_err": err,
                          "rtol": RTOL}), flush=True)
        assert k2_rel <= RTOL, f"K2 disagrees with its twin: {k2_rel}"

        sub = K1.sub_steps(BLOCK)
        tiles[n] = K1.tile_size(n, NPH, 2, NC, sub, dev)
        pair = check_k1(args, sub, tiles[n], gen)
        for k in ("gle_near", "gle_far"):
            errs[k] = max(errs[k], pair[k][1])
        out, ref = K1.gle_block_cuda(*args), K1.gle_block_plain(*args)
        k1_errs = {name: rel_err(getattr(out, name), getattr(ref, name))
                   for name in ("p", "q", "pf", "qprev", "cur", "etot")}
        for i, (a_, b_) in enumerate(zip(out.rings, ref.rings)):
            k1_errs[f"ring{i}"] = rel_err(a_, b_)
        k1_rel = max(v[0] for v in k1_errs.values())
        print(json.dumps({"phase": 4, "ntraj": n, "sub": sub,
                          "tile": tiles[n],
                          "near_rel_err": pair["gle_near"][0],
                          "far_rel_err": pair["gle_far"][0],
                          "block_rel_err_max": k1_rel, "rtol": RTOL}),
              flush=True)
        assert max(k1_rel, pair["gle_near"][0], pair["gle_far"][0]) <= \
            RTOL, f"K1 disagrees with its twins: {pair}, {k1_errs}"
        del out, ref
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
    reset_k3()
    e2e = {}
    with GeneratorCount() as gens:
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
    launches = {"gle_near": K1.launches_near, "gle_far": K1.launches_far,
                "block_corr_freq": K2.launches, **k3_counts()}
    assert min(launches.values()) > 0, launches
    nchunks = sum(len(chunk_sizes(r._build_system(), n)) for n in SIZES)
    assert launches["noise_synth"] == 2 * nchunks and \
        launches["init_draw"] == nchunks and \
        launches["noise_transpose"] == 2 * nchunks, launches
    assert gens.n == 0, f"{gens.n} torch.Generator made on the main path"
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
        system = rr._build_system()
        out.append(fused_chunk(
            system, bath_factors(rr.baths, device),
            [torch.as_tensor(x, dtype=dtype, device=device) for x in rs_np],
            512, 0, BLOCK, 128, states=thermal_init(
                torch.as_tensor(us_np, dtype=dtype, device=device), system,
                rr.hw, rr.U, T)))
        assert bool(out[-1][2])
    (fg, sg, _), (fc, sc, _) = out
    cur_rel = rel_err(sg, sc)[0]
    p_rel, q_rel = rel_err(fg.p, fc.p)[0], rel_err(fg.q, fc.q)[0]
    print(json.dumps({"phase": 6, "cur_rel": cur_rel, "p_rel": p_rel,
                      "q_rel": q_rel, "rtol": RTOL}), flush=True)
    assert max(cur_rel, p_rel, q_rel) <= RTOL, (sg, sc)

    # 7. kernel, twin and library times at each chunk shape (phase 4's
    # operands; K6 and K7 at the operands phase 8 checks)
    plain_ops = plain_step_operands(dev)
    times = {n: k1_k2_times(*ops) for n, ops in operands.items()}
    times["conv_tails"] = {n: k6_times(*ops)
                           for n, ops in plain_ops["k6"].items()}
    times["bath_force"] = {name: k7_times(c)
                           for name, c in plain_ops["k7_main"].items()}
    k5_ops = k5_operands(dev)
    times["ch_force"] = {n: k5_times(k5_ops["driver"], q)
                         for n, q in k5_ops["q"].items()}
    k3_ops = k3_operands(dev)
    times["noise_synth"] = {name: k3_times(*c)
                            for name, c in k3_ops["k3"].items()}
    times["init_draw"] = {name: k3b_times(*c)
                          for name, c in k3_ops["k3b"].items()}
    print(json.dumps({"phase": 7, "ms": times}), flush=True)

    # 8. K6 and K7 against their twins
    k6_abs, k7_abs = check_plain_kernels(plain_ops)

    # 9. md.Run, 10. RunEnsemble on the plain path, 11. card against CPU
    run_launches = phase_run(dev)
    ens_launches = phase_flagship(dev)
    phase_card_vs_cpu(dev)

    # 12. K5 against its twins, 13. the many-body flagship, 14. card vs CPU
    k5_abs = max(check_k5(k5_ops), check_k5_geometries(dev))
    mb_launches = phase_many_body(dev)
    phase_many_body_card_vs_cpu(dev)

    # 15. K8 on the periodic sheet
    k8 = phase_tersoff_sheet(dev)

    # 16. K3 and K3b against their twins; 20. the flagship's NEGF on the
    # card, whose j_nat 17, the cross-check gate, reads beside the
    # committed one (its bar)
    k3_abs = check_noise_synth(k3_ops)
    negf = phase_negf(dev)
    phase_crosscheck(dev, negf["j_nat"])

    # 18. the silicon slab (K9), 19. the gold slab (K10); PR 9's kernels
    # timed before and after them on the same inputs (the "earlier"
    # column, where a tree of that commit is found)
    tree, why = parent_tree()
    before = earlier_slab_times(tree)
    k9 = phase_si_slab(dev)
    k10 = phase_gold_slab(dev)
    after = earlier_slab_times(tree)
    now = {"sw": k9["times"]["kernel"], "eam": k10["times"]["kernel"],
           "eam_tab": k10["times_tab"]["kernel"]}
    earlier = {"commit": PARENT, "tree": why or "found", "before": before,
               "after": after, "now": now,
               "sectors_per_request": "not measured (no ncu run)"}
    if before and after and "error" not in before and "error" not in after:
        earlier["speedup"] = {k: (before[k] + after[k]) / 2 / now[k]
                              for k in now}
    print(json.dumps({"phase": 19, "earlier": earlier}), flush=True)

    # 21. the lead-block decimation against the CPU, and RunEnsemble
    # under two lead-block phonon baths
    phase_lead_blocks(dev)

    # 22. the Lambda pipeline and HSSigma on the card; 23. the flagship
    # under a biased centre bath from the pipeline (K7's bias route, K3's
    # per-frequency route) and its kappa files read back
    phase_lambda(dev, smi)
    p23 = phase_current_induced(dev, smi)

    # the per-kernel line gives the times at the smallest chunk shape
    t = times[shapes[0]]
    # K6 at one trajectory; K7 at one primary trajectory (two thirds of
    # its launches), the mean of its three stages
    k6_t = times["conv_tails"][1]
    k7_t = times["bath_force"]["primary_1"]["mean"]
    k5_t = times["ch_force"][min(times["ch_force"])]
    # K3 at the primary junction's smallest chunk; K3b at the flagship's
    # largest (the widest thermal start)
    k3_t = times["noise_synth"][f"primary_{shapes[0]}"]
    k3b_t = times["init_draw"]["flagship_1024"]
    # the series' layout kernel at the flagship's largest chunk
    tr_t = times["noise_synth"]["flagship_1024"]["transpose"]
    main_runs = [launches, run_launches, ens_launches, mb_launches,
                 k8["launches"], k9["launches"], k10["launches"],
                 p23["launches"]]

    def row(name, source, replaces, launches_, err, tm):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": tm["kernel"],
                "plain_ms": tm["plain"], "bound_ms": tm["bound"],
                "bound_by": tm["bound_by"], "library_ms": tm["library"]}

    kernels = [
        row("gle_near", "sclmd_tpu_torch/csrc/gle_block.cu",
            "sclmd_tpu/md.py:532", launches["gle_near"], errs["gle_near"],
            t["gle_near"]),
        row("gle_far", "sclmd_tpu_torch/csrc/gle_far.cu",
            "sclmd_tpu/md.py:551", launches["gle_far"], errs["gle_far"],
            t["gle_far"]),
        row("block_corr_freq", "sclmd_tpu_torch/csrc/block_corr.cu",
            "a5170d2:sclmd_tpu/ops/kernels.py:54",
            launches["block_corr_freq"], errs["block_corr_freq"],
            t["block_corr_freq"]),
        row("conv_tails", "sclmd_tpu_torch/csrc/conv_tails.cu",
            "a5170d2:sclmd_tpu/ops/kernels.py:127",
            run_launches["conv_tails"], k6_abs, k6_t),
        row("bath_force", "sclmd_tpu_torch/csrc/bath_force.cu",
            "a5170d2:sclmd_tpu/ops/kernels.py:98",
            run_launches["bath_force"] + ens_launches["bath_force"]
            + mb_launches["bath_force"] + k9["launches"]["bath_force"]
            + k10["launches"]["bath_force"]
            + p23["launches"]["bath_force"],
            max(k7_abs, k9["baths"]["k7_abs_err"],
                k10["baths"]["k7_abs_err"]), k7_t),
        row("ch_force", "sclmd_tpu_torch/csrc/ch_force.cu",
            "sclmd_tpu/models/tersoff.py:186", mb_launches["ch_force"],
            k5_abs, k5_t),
        row("tersoff_force", "sclmd_tpu_torch/csrc/ch_force.cu",
            "sclmd_tpu/models/tersoff.py:160",
            k8["launches"]["tersoff_force"], k8["abs"], k8["times"]),
        row("noise_synth", "sclmd_tpu_torch/csrc/noise_synth.cu",
            "sclmd_tpu/ops/noise.py:186",
            sum(c["noise_synth"] for c in main_runs),
            max(k3_abs["noise_synth"], k9["baths"]["k3_abs_err"],
                k10["baths"]["k3_abs_err"], p23["k3_abs"]), k3_t),
        row("init_draw", "sclmd_tpu_torch/csrc/noise_synth.cu",
            "sclmd_tpu/md.py:120",
            sum(c["init_draw"] for c in main_runs), k3_abs["init_draw"],
            k3b_t),
        row("noise_transpose", "sclmd_tpu_torch/csrc/noise_synth.cu",
            "sclmd_tpu/ops/noise.py:205",
            sum(c["noise_transpose"] for c in main_runs),
            max(k3_abs["noise_transpose"], k9["baths"]["transpose_abs_err"],
                k10["baths"]["transpose_abs_err"], p23["transpose_abs"]),
            tr_t),
        row("sw_force", "sclmd_tpu_torch/csrc/sw_force.cu",
            "sclmd_tpu/models/sw.py:63", k9["launches"]["sw_force"],
            k9["abs"], k9["times"]),
        row("eam_force", "sclmd_tpu_torch/csrc/eam_force.cu",
            "sclmd_tpu/models/eam.py:72", k10["launches"]["eam_force"],
            k10["abs"], k10["times"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# --- K1 (near and far taps) and K2 ------------------------------------------
def check_k1(args, sub, tt, gen):
    """Phase 4: K1's near kernel over the second sub-block of a block and
    its far kernel over the update after it, each against its twin on the
    same tensors (earlier rows of the ring random). Returns per kernel
    (relative, absolute) largest error."""
    from sclmd_tpu_torch.kernels import gle_block as K1
    p, q, pf, dyn, mask, baths, t0, nmd, dt, free, block = args
    got, want = (K1.BlockState(p, q, pf, baths, block) for _ in range(2))
    for r0, r1 in zip(got.rings, want.rings):
        r0.normal_(generator=gen).mul_(0.05)
        r1.copy_(r0)
    b0, ns = sub, min(sub, block - sub - 1)
    run = (dyn, mask, baths, t0, nmd, dt, free, block, b0, ns)
    K1.gle_near_cuda(got, *run, sub=sub, tt=tt)
    K1.gle_near_plain(want, *run)
    # (qprev is written at the block's last step only)
    near = [rel_err(getattr(got, k), getattr(want, k))
            for k in ("p", "q", "pf", "cur", "etot")]
    near += [rel_err(g, w) for g, w in zip(got.rings, want.rings)]
    for g, w in zip(got.rings, want.rings):   # the far kernel's own error
        g.copy_(w)
    K1.gle_far_cuda(baths, got.rings, got.Os, block, b0, ns)
    for b, r, O in zip(baths, want.rings, want.Os):
        K1.gle_far_plain(b.kin, r, O, block, b0, ns)
    far = [rel_err(g, w) for g, w in zip(got.Os, want.Os)]
    return {k: (max(e[0] for e in v), max(e[1] for e in v))
            for k, v in (("gle_near", near), ("gle_far", far))}


def _timed(kernel, plain, library, flops, nbytes, reps, plain_reps,
           tf32x3=False):
    """Times and the bound; ``tf32x3``: the kernel's products run as
    three TF32 tensor-core products each."""
    ops, peak = (3 * flops, PEAK_TF32) if tf32x3 else (flops, PEAK_F32)
    return {"kernel": cuda_ms(kernel, reps),
            "plain": cuda_ms(plain, plain_reps),
            "library": None if library is None else cuda_ms(library, reps),
            "bound": bound_ms(ops, nbytes, peak), "flops": flops,
            "bytes": nbytes,
            "bound_by": "operations" if ops / peak >= nbytes / PEAK_HBM
            else "bytes"}


def k1_k2_times(args, khat, hhat):
    """Phase 7 at one chunk shape: K1's near and far kernels over one
    block (all the launches of each in a block), K2 per call; each with
    its twin, the library call where there is one, and its bound from
    this run's shapes (matrix products counted; each input read once and
    each output written once)."""
    from sclmd_tpu_torch.kernels import block_corr as K2
    from sclmd_tpu_torch.kernels import gle_block as K1
    p, q, pf, dyn, mask, baths, t0, nmd, dt, free, block = args
    ntraj, nph = p.shape
    ncs = [b.kin.shape[0] for b in baths]
    sub = K1.sub_steps(block)
    tt = K1.tile_size(ntraj, nph, len(baths), max(ncs), sub, p.device)
    subs = K1.sub_blocks(block)
    st = K1.BlockState(p, q, pf, baths, block)
    for r in st.rings:
        r.normal_().mul_(0.05)

    def near(kernel):
        s_ = K1.BlockState(p, q, pf, baths, block)
        for b0, ns in subs:
            if kernel:
                K1.gle_near_cuda(s_, dyn, mask, baths, t0, nmd, dt, free,
                                 block, b0, ns, sub, tt)
            else:
                K1.gle_near_plain(s_, dyn, mask, baths, t0, nmd, dt, free,
                                  block, b0, ns)

    def far(kernel):
        for b0, ns in subs[:-1]:
            if kernel:
                K1.gle_far_cuda(baths, st.rings, st.Os, block, b0, ns)
            else:
                for b, r, O in zip(baths, st.rings, st.Os):
                    K1.gle_far_plain(b.kin, r, O, block, b0, ns)

    # the library form of the far taps: one torch.matmul per update and
    # bath on the block-Toeplitz operand and the ring rows, both
    # materialised beforehand (not timed)
    gemms = []
    for b, r, nc in zip(baths, st.rings, ncs):
        taps = b.kin.view(nc, block + 1, nc).permute(1, 0, 2)
        for b0, ns in subs[:-1]:
            s_ = torch.arange(b0 + ns, block + 1, device=p.device)
            i_ = torch.arange(ns, device=p.device)
            A = taps[s_[:, None] - b0 - i_[None, :] - 1]  # (s, i, a, b)
            A = A.permute(0, 2, 1, 3).reshape(-1, ns * nc).contiguous()
            Bm = r[:, block - 1 - b0 - i_].reshape(ntraj, ns * nc).T
            gemms.append((A, Bm.contiguous()))

    def far_library():
        for A, Bm in gemms:
            torch.matmul(A, Bm)

    f_near = ntraj * sum(
        2 * nph * nph * (1 if free else 2) +
        sum(2 * nc * nc * (2 * (s % sub) + 1) + 6 * nc * nc for nc in ncs)
        for s in range(block))
    b_near = 4 * (nph * nph + nph + 7 * ntraj * nph
                  + ntraj * block * (len(baths) + 1)
                  + sum(sub * nc * nc + nc * nc + 2 * ntraj * (block + 1) * nc
                        + ntraj * block * nc for nc in ncs))
    f_far = sum(2 * (block + 1 - b0 - ns) * nc * ns * nc * ntraj
                for b0, ns in subs[:-1] for nc in ncs)
    b_far = 4 * sum(block * nc * nc + ntraj * block * nc
                    + 2 * ntraj * (block + 1) * nc for nc in ncs)
    nf, nc2 = khat.shape[0], khat.shape[1]
    out = {
        "sub": sub, "tile": tt,
        "gle_near": _timed(lambda: near(True), lambda: near(False), None,
                           f_near, b_near, 3, 1),
        "gle_far": _timed(lambda: far(True), lambda: far(False),
                          far_library, f_far, b_far, 3, 1, tf32x3=True),
        "block_corr_freq": _timed(
            lambda: K2.block_corr_freq_cuda(khat, hhat),
            lambda: K2.block_corr_freq_plain(khat, hhat),
            lambda: torch.einsum("fab,tfb->tfa", khat, torch.conj(hhat)),
            8 * nf * ntraj * nc2 * nc2,
            8 * (nf * nc2 * nc2 + 2 * ntraj * nf * nc2), 20, 20,
            tf32x3=True),
        "gle_block_pair": cuda_ms(lambda: K1.gle_block_cuda(*args), 3),
        "gle_block_plain": cuda_ms(lambda: K1.gle_block_plain(*args), 1),
    }
    del gemms
    return out


def k6_times(ring, head, baths, k6):
    """K6 at one trajectory count: kernel, twin, and the library form,
    one torch.matmul per bath of the tap slab with the history unrolled
    as the JAX package lays it out (materialised beforehand)."""
    from sclmd_tpu_torch.kernels import conv_tails as K6
    ntraj, mlr, _ = ring.shape
    gemms = []
    for b in baths:
        nc, ml = b.nc, b.ml
        idx = (head + torch.arange(ml, device=ring.device)) % mlr
        old = ring.index_select(1, idx)[:, :, b.cols]
        Bm = torch.stack([old[:, 1:ml - 1], old[:, 0:ml - 2]], dim=3)
        gemms.append((b.kernel_im[:, 2 * nc:].contiguous(),
                      Bm.reshape(ntraj, (ml - 2) * nc, 2).contiguous()))

    def library():
        for A, Bm in gemms:
            torch.matmul(A, Bm)

    flops = sum(ntraj * 2 * 2 * b.nc * (b.ml - 2) * b.nc for b in baths)
    nbytes = 4 * sum(b.nc * (b.ml - 2) * b.nc + ntraj * (b.ml - 1) * b.nc
                     + 2 * ntraj * b.nc for b in baths)
    step = (-head) % mlr              # the segment step at that head
    return _timed(lambda: k6(step),
                  lambda: K6.conv_tails_plain(ring, head, baths), library,
                  flops, nbytes, 50, 20)


def k7_times(c):
    """K7's three stages at one shape: kernel (CUDA events, and the
    profiler's device duration: where the two differ by more than a
    tenth the event loop timed the host, and ``kernel`` is the device
    duration; where the profiler's trace lost most launches three times
    over, ``device`` repeats the event time) and twin (no single library call computes it); bound from
    the matrices and the vectors the stage reads and writes. ``mean``
    averages the stages."""
    from sclmd_tpu_torch.tools.plain_bench import STAGES, device_us
    ops = c.force.ops
    ncs = [op.bath.nc for op in ops]
    nmat = [op.MT.shape[0] // nc for op, nc in zip(ops, ncs)]
    flops = c.ntraj * sum(2 * nc * nc * k for nc, k in zip(ncs, nmat))
    gathered = sum(nc * (k - 1) for nc, k in zip(ncs, nmat))
    tails = sum(nc for nc, t in zip(ncs, c.tails) if t is not None)
    vectors = {   # (ntraj, nph) vectors read and written, then the rest
        "pred": 3 + 3, "corr": 3 + 1, "last": 4 + 2}
    out = {}
    for stage in STAGES:
        nbytes = 4 * (sum(nc * nc * k for nc, k in zip(ncs, nmat))
                      + c.ntraj * (vectors[stage] * c.nph + gathered
                                   + sum(ncs) + tails)
                      + (c.ntraj * (len(ncs) + 1) if stage == "pred" else 0)
                      + (c.nph if stage == "last" else 0))
        t = _timed(lambda: c.stage_call(stage, True),
                   lambda: c.stage_call(stage, False), None, flops, nbytes,
                   200, 20)
        t["event"] = t["kernel"]
        try:
            t["device"] = 1e-3 * sum(device_us(
                lambda: c.stage_call(stage, True)).values())
        except RuntimeError as e:    # three traces without the launches
            print(json.dumps({"phase": 7, "stage": stage, "profiler": str(e)}),
                  flush=True)
            t["device"] = t["event"]
        if abs(t["event"] - t["device"]) > 0.1 * t["device"]:
            t["kernel"] = t["device"]
        out[stage] = t
    out["mean"] = {
        k: (sum(out[s][k] for s in STAGES) / len(STAGES)
            if isinstance(out["pred"][k], float) else out["pred"][k])
        for k in out["pred"]}
    out["tile"] = c.force.tile
    return out


# --- the plain GLE step: K6 and K7 -------------------------------------------
def k7_outputs(c, kernel: bool):
    """Every output of the three stages, by the kernel or the twins."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    ring0 = c.ring.clone()
    fbs = [torch.zeros((c.ntraj, b.nc), device=c.p.device) for b in c.baths]
    f_out = torch.zeros_like(c.p)
    # step 0 of K7Case's segment: head 0, push row mlr - 1, rows 3 and 4
    head, push = 0, (c.mlr - 1) % c.mlr
    if kernel:
        ph, qt = c.force.pred(c.p, c.q, c.pf, c.ring, 0, c.tails, c.cur,
                              c.etot, fbs)
        pc, _ = c.force.corr(c.x, qt, c.pf2, c.p, ph, c.tails, 0)
        pl, ql = c.force.corr(c.x, qt, c.pf2, c.p, ph, c.tails, 0,
                              mask=c.mask, f_out=f_out)
    else:
        args = (c.force.ops, c.tails)
        ph, qt = K7.pred_plain(c.p, c.q, c.pf, c.ring, head, push, *args,
                               3, c.dt, c.cur[:, 0], c.etot[:, 0], fbs)
        pc, _ = K7.corr_plain(c.x, qt, c.pf2, c.p, ph, *args, 4, c.dt)
        pl, ql = K7.corr_plain(c.x, qt, c.pf2, c.p, ph, *args, 4, c.dt,
                               c.mask, f_out)
    out = dict(pthalf=ph, qtt=qt, p_corr=pc, p_last=pl, q_last=ql,
               f=f_out, cur=c.cur.clone(), etot=c.etot.clone(),
               pushed=c.ring[:, push].clone(),
               **{f"fb{i}": fb for i, fb in enumerate(fbs)})
    c.ring.copy_(ring0)
    return out


def plain_step_operands(dev):
    """K6's and K7's operands at the shapes the plain path gives them."""
    from sclmd_tpu_torch.kernels import conv_tails as K6
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools.plain_bench import K7Case
    from sclmd_tpu_torch.tools.primary import DT, NMD, NPH, primary_baths

    gen = torch.Generator(device=dev).manual_seed(5)
    pb = primary_baths(torch.float32, dev)
    k6 = {}
    for n, head in ((1, 377), (37, 5)):
        ring = 0.05 * torch.randn((n, pb[0].ml, NPH), device=dev,
                                  generator=gen)
        k6[n] = (ring, head, pb, K6.ConvTailsCuda(ring, pb))
    fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp())
    fsys = fr._build_system()
    sizes = sorted({n for ntraj in FLAG_SIZES
                    for n in F.chunk_sizes(fsys, ntraj)})
    k7 = {"primary_1": K7Case(pb, 1, NPH, NMD, DT, dev, 10)}
    k7.update({f"flagship_{n}": K7Case(fr.baths, n, fr.nph, F.NMD, F.DT,
                                       dev, n) for n in sizes})
    # a biased electron bath pair: random wind, renormalisation, Berry
    rng = np.random.default_rng(3)
    from sclmd_tpu_torch import baths as B
    biased = [B.ebath(b.cids, b.T, F.DT, F.NMD, wmax=1.0, bias=0.1,
                      efric=b.efric.double().cpu().numpy(),
                      exim=0.01 * rng.normal(size=(b.nc, b.nc)),
                      zeta1=0.01 * rng.normal(size=(b.nc, b.nc)),
                      zeta2=0.01 * rng.normal(size=(b.nc, b.nc)),
                      dtype=torch.float32, device=dev, factorize=False)
              for b in fr.baths]
    return {"k6": k6, "k7_main": k7,
            "k7_biased": K7Case(biased, 128, fr.nph, F.NMD, F.DT, dev, 9),
            "k7_phonon": K7Case(pb, 37, NPH, NMD, DT, dev, 10)}


def check_plain_kernels(ops):
    """Phase 8: K6 and K7 against their twins on the same tensors."""
    from sclmd_tpu_torch.kernels import conv_tails as K6

    k6_abs = k7_abs = 0.0
    for n, (ring, head, baths, k6) in ops["k6"].items():
        got = [t.clone() for t in k6((-head) % ring.shape[1])]
        want = K6.conv_tails_plain(ring, head, baths)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        k6_rel = max(e[0] for e in errs)
        k6_abs = max(k6_abs, max(e[1] for e in errs))
        print(json.dumps({"phase": 8, "kernel": "conv_tails", "ntraj": n,
                          "rel_err": k6_rel, "rtol": RTOL}), flush=True)
        assert k6_rel <= RTOL, f"K6 disagrees with its twin: {errs}"
    cases = list(ops["k7_main"].items())
    cases += [("biased_128", ops["k7_biased"]),
              ("phonon_tails_37", ops["k7_phonon"])]
    for name, c in cases:
        got, want = k7_outputs(c, True), k7_outputs(c, False)
        errs = {k: rel_err(got[k], want[k]) for k in want}
        k7_rel = max(e[0] for e in errs.values())
        k7_abs = max(k7_abs, max(e[1] for e in errs.values()))
        print(json.dumps({"phase": 8, "kernel": "bath_force", "case": name,
                          "tile": c.force.tile, "rel_err": k7_rel,
                          "rtol": RTOL}), flush=True)
        assert k7_rel <= RTOL, f"K7 disagrees with its twin: {errs}"
    return k6_abs, k7_abs


def phase_run(dev):
    """Phase 9: md.Run on the primary junction through the plain step."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import conv_tails as K6
    from sclmd_tpu_torch.tools.primary import NMD, primary_runner

    def runner(outdir, nstop):
        r = primary_runner(torch.float32, dev, outdir)
        r.block, r.nstart, r.nstop, r.npie = None, 0, nstop, 2
        r.CalPowerSpec()
        return r

    runner(tempfile.mkdtemp(), 1).Run()          # warm-up
    outdir = tempfile.mkdtemp()
    r = runner(outdir, 2)
    torch.cuda.synchronize()
    K6.reset_count()
    K7.reset_count()
    reset_k3()
    t0 = time.perf_counter()
    with GeneratorCount() as gens:
        r.Run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"conv_tails": K6.launches, "bath_force": K7.launches,
              **k3_counts()}
    nsteps = 2 * NMD
    # two runs of two baths' noise, one thermal start
    assert counts == {"conv_tails": nsteps, "bath_force": 3 * nsteps,
                      "noise_synth": 4, "init_draw": 1,
                      "noise_transpose": 4}, counts
    assert gens.n == 0, gens.n
    names = set(os.listdir(outdir))
    for j in (0, 1):
        want = {f"MD{j}.npz", f"power.300.run{j}.dat"} | {
            f"kappa.300.bath{i}.run{j}.dat" for i in (0, 1)}
        assert want <= names, (want - names)
        ck = np.load(os.path.join(outdir, f"MD{j}.npz"))
        assert int(ck["t"][0]) == (j + 1) * NMD
        for k in ("p", "q", "phis", "etot", "cur", "ps", "power"):
            assert np.isfinite(ck[k]).all(), (j, k)
        assert ck["ps"].shape == (NMD, 300) and ck["cur"].shape == (NMD, 2)
    print(json.dumps({"phase": 9, "launches": counts, "s": wall,
                      "steps_per_s": nsteps / wall}), flush=True)
    return counts


def phase_flagship(dev):
    """Phase 10: RunEnsemble on the plain path on the flagship."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.tools import flagship as F

    hot, cold = F.T * (1 + F.DELTA / 2), F.T * (1 - F.DELTA / 2)
    runs = {}
    for temps in ((hot, cold), (cold, hot)):
        r = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp(),
                              temps=temps)
        for ntraj in FLAG_SIZES:          # warm-up of every chunk shape
            r.RunEnsemble(ntraj, nsteps=F.NMD, block=None)
        torch.cuda.synchronize()
        K7.reset_count()
        reset_k3()
        e2e, means = {}, {}
        with GeneratorCount() as gens:
            for ntraj in FLAG_SIZES:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                means[ntraj] = r.RunEnsemble(ntraj, nsteps=F.NMD,
                                             block=None)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                assert means[ntraj].shape == (ntraj, 2)
                assert np.isfinite(means[ntraj]).all()
                e2e[ntraj] = {"s": wall,
                              "traj_steps_per_s": ntraj * F.NMD / wall,
                              "J_left": float(means[ntraj][:, 0].mean()),
                              "J_right": float(means[ntraj][:, 1].mean())}
        assert gens.n == 0, gens.n
        runs[temps] = (e2e, means, K7.launches, k3_counts())
    e2e, fwd, launches, k3 = runs[(hot, cold)]
    rev = runs[(cold, hot)][1]
    nchunks = sum(len(F.chunk_sizes(r._build_system(), n))
                  for n in FLAG_SIZES)
    assert launches == 3 * F.NMD * nchunks, launches
    assert k3 == {"noise_synth": 2 * nchunks, "init_draw": nchunks,
                  "noise_transpose": 2 * nchunks}, k3
    # common random numbers: both runners draw the same numbers, so the
    # half-difference keeps the current driven by the temperature
    # difference and cancels the fluctuations the two runs share
    n = max(FLAG_SIZES)
    j = (fwd[n] - rev[n]) / 2
    jl, jr = float(j[:, 0].mean()), float(j[:, 1].mean())
    sem = (j.std(axis=0) / np.sqrt(n)).tolist()
    print(json.dumps({"phase": 10, "launches": {"bath_force": launches,
                                                **k3},
                      "e2e": e2e, "J_left": jl, "J_right": jr,
                      "J_sem": sem}), flush=True)
    assert jl > 0 > jr, (jl, jr, sem)
    return {"bath_force": launches, **k3}


def phase_card_vs_cpu(dev):
    """Phase 11: 512 plain steps on the card and on the CPU (float64)."""
    from sclmd_tpu_torch.md import run_segment, thermal_init
    from sclmd_tpu_torch.ops.noise import sample_noise_from_r
    from sclmd_tpu_torch.parallel.ensemble import bath_factors, fused_chunk
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools.primary import DT, NMD, NPH, T, primary_runner

    rng = np.random.default_rng(12)
    out = {"run": [], "flagship": []}
    r0 = primary_runner(torch.float64, "cpu", tempfile.mkdtemp())
    rs_run = [rng.standard_normal((1,) + np.shape(b.nstd)) for b in r0.baths]
    u_run = rng.uniform(size=(1, NPH))
    f0 = F.flagship_runner(torch.float64, "cpu", tempfile.mkdtemp())
    rs_flag = [rng.standard_normal((4,) + np.shape(b.nstd))
               for b in f0.baths]
    u_flag = rng.uniform(size=(4, f0.nph))
    for dtype, device in ((torch.float32, dev), (torch.float64, "cpu")):
        def tens(x):
            return torch.as_tensor(x, dtype=dtype, device=device)
        r = primary_runner(dtype, device, tempfile.mkdtemp())
        facs = bath_factors(r.baths, device)
        system = r._build_system().replace(baths=tuple(
            b.replace(noise=sample_noise_from_r(tens(x), ev, sd, DT, NMD))
            for b, (ev, sd), x in zip(r.baths, facs, rs_run)))
        st = thermal_init(tens(u_run), system, r.hw, r.U, T)
        fin, ys = run_segment(system, st, 512, t0=0)
        out["run"].append((fin.p, fin.q, ys["cur"], ys["etot"]))
        fr = F.flagship_runner(dtype, device, tempfile.mkdtemp())
        fsys = fr._build_system()
        fin, sums, ok = fused_chunk(
            fsys, bath_factors(fr.baths, device),
            [tens(x) for x in rs_flag], 512, 0, None, 128,
            states=thermal_init(tens(u_flag), fsys, fr.hw, fr.U, F.T))
        assert bool(ok)
        out["flagship"].append((fin.p, fin.q, sums))
    errs = {name: max(rel_err(a, b)[0] for a, b in zip(*pair))
            for name, pair in out.items()}
    print(json.dumps({"phase": 11, "rel_err": errs, "rtol": RTOL}),
          flush=True)
    assert max(errs.values()) <= RTOL, errs


# --- the many-body flagship: K5 ----------------------------------------------
def k5_operands(dev):
    """K5's driver and its inputs at the shapes the many-body flagship
    gives it: thermal-start displacements (300 K, the runner's own
    ``thermal_init``) at each chunk size of phase 13."""
    from sclmd_tpu_torch.md import thermal_init
    from sclmd_tpu_torch.tools import flagship as F

    fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp(),
                           many_body=True)
    system = fr._build_system()
    gen = torch.Generator(device=dev).manual_seed(13)
    sizes = sorted({n for ntraj in FLAG_SIZES
                    for n in F.chunk_sizes(system, ntraj)})
    qs = {n: thermal_init(torch.rand((n, fr.nph), device=dev, generator=gen),
                          system, fr.hw, fr.U, F.T).q.contiguous()
          for n in sizes}
    return {"driver": fr.pforce, "q": qs}


def k5_times(drv, q):
    """K5 (or K8) at one chunk size: kernel (CUDA events and the profiler's
    device duration, as for K7), its float32 autograd twin on the card
    (no single library call computes it), and the bound: q read and f
    written once, and the operations this geometry needs
    (``kernels.ch_force.work_counts``) at the float32 peak."""
    from sclmd_tpu_torch.kernels.ch_force import work_counts
    from sclmd_tpu_torch.tools.plain_bench import device_us
    w = work_counts(drv.kernel.cuda.pack)
    n = q.shape[0]
    t = _timed(lambda: drv.force_torch(q), lambda: drv.kernel.plain(q), None,
               n * w["ops"], n * w["bytes"], 200, 5)
    t["event"] = t["kernel"]
    t["device"] = 1e-3 * sum(device_us(lambda: drv.force_torch(q)).values())
    if abs(t["event"] - t["device"]) > 0.1 * t["device"]:
        t["kernel"] = t["device"]
    t["work"] = w
    return t


def check_k5(ops):
    """Phase 12: K5 against the float64 twin on the CPU and the float32
    twin on the card, at every chunk size; returns the largest absolute
    error against the float64 twin."""
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    drv = ops["driver"]
    ref = CHDriver(drv.axyz, dtype=torch.float64, device="cpu")
    worst = 0.0
    for n, q in ops["q"].items():
        e, f = drv.energy_force_torch(q)
        again = drv.force_torch(q)
        torch.cuda.synchronize()
        # the CPU twin's (traj, 171, 8, 8) temporaries: 64 at a time
        qc = q.double().cpu()
        pairs = [ref.energy_force_torch(qc[i:i + 64])
                 for i in range(0, n, 64)]
        e64 = torch.cat([p[0] for p in pairs])
        f64 = torch.cat([p[1] for p in pairs])
        f32 = drv.kernel.plain(q)
        rel64, err = rel_err(f, f64)
        rel32 = rel_err(f, f32)[0]
        e_rel = rel_err(e, e64)[0]
        worst = max(worst, err)
        print(json.dumps({
            "phase": 12, "ntraj": n, "rel_err_float64_twin": rel64,
            "max_abs_err": err, "energy_rel_err": e_rel, "rtol": RTOL,
            "rel_err_float32_twin": rel32, "rtol_float32": K5_TWIN32_RTOL,
            "float32_twin_vs_float64": rel_err(f32, f64)[0],
            "largest_force": float(f64.abs().max()),
            "bitwise_repeat": bool(torch.equal(f, again))}), flush=True)
        assert rel64 <= RTOL and e_rel <= RTOL, \
            f"K5 disagrees with its float64 twin: {rel64}, {e_rel}"
        assert rel32 <= K5_TWIN32_RTOL, \
            f"K5 disagrees with its float32 twin: {rel32}"
        assert torch.equal(f, again), "K5 does not repeat bitwise"
    return worst


def phase_many_body(dev):
    """Phase 13: RunEnsemble on the many-body flagship."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.tools import flagship as F

    hot, cold = F.T * (1 + F.DELTA / 2), F.T * (1 - F.DELTA / 2)
    runs = {}
    for temps in ((hot, cold), (cold, hot)):
        r = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp(),
                              temps=temps, many_body=True)
        for ntraj in FLAG_SIZES:          # warm-up of every chunk shape
            r.RunEnsemble(ntraj, nsteps=F.NMD)
        torch.cuda.synchronize()
        K5.reset_count()
        K7.reset_count()
        reset_k3()
        e2e, means = {}, {}
        with GeneratorCount() as gens:
            for ntraj in FLAG_SIZES:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                means[ntraj] = r.RunEnsemble(ntraj, nsteps=F.NMD)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ke = r.energy(r.state)
                assert means[ntraj].shape == (ntraj, 2)
                assert np.isfinite(means[ntraj]).all()
                assert np.isfinite(ke) and 0.0 < ke < KE_BOUND, ke
                e2e[ntraj] = {"s": wall,
                              "traj_steps_per_s": ntraj * F.NMD / wall,
                              "kinetic_energy_end": ke,
                              "J_left": float(means[ntraj][:, 0].mean()),
                              "J_right": float(means[ntraj][:, 1].mean())}
        assert gens.n == 0, gens.n
        runs[temps] = (e2e, means, {"ch_force": K5.launches,
                                    "bath_force": K7.launches,
                                    **k3_counts()})
    e2e, fwd, launches = runs[(hot, cold)]
    rev = runs[(cold, hot)][1]
    nchunks = sum(len(F.chunk_sizes(r._build_system(), n))
                  for n in FLAG_SIZES)
    assert launches == {"ch_force": 2 * F.NMD * nchunks,
                        "bath_force": 3 * F.NMD * nchunks,
                        "noise_synth": 2 * nchunks,
                        "init_draw": nchunks,
                        "noise_transpose": 2 * nchunks}, launches
    n = max(FLAG_SIZES)
    j = (fwd[n] - rev[n]) / 2             # common random numbers
    jl, jr = float(j[:, 0].mean()), float(j[:, 1].mean())
    sem = (j.std(axis=0) / np.sqrt(n)).tolist()
    print(json.dumps({"phase": 13, "launches": launches, "e2e": e2e,
                      "ke_bound": KE_BOUND, "J_left": jl, "J_right": jr,
                      "J_sem": sem}), flush=True)
    assert jl > 0 > jr, (jl, jr, sem)
    return launches


def phase_many_body_card_vs_cpu(dev, nsteps=48):
    """Phase 14: a many-body flagship chunk on the card and on the CPU
    (float64), the same injected draws."""
    from sclmd_tpu_torch.md import thermal_init
    from sclmd_tpu_torch.parallel.ensemble import bath_factors, fused_chunk
    from sclmd_tpu_torch.tools import flagship as F

    rng = np.random.default_rng(14)
    f0 = F.flagship_runner(torch.float64, "cpu", tempfile.mkdtemp())
    rs = [rng.standard_normal((4,) + np.shape(b.nstd)) for b in f0.baths]
    us = rng.uniform(size=(4, f0.nph))
    out = []
    for dtype, device in ((torch.float32, dev), (torch.float64, "cpu")):
        fr = F.flagship_runner(dtype, device, tempfile.mkdtemp(),
                               many_body=True)
        system = fr._build_system()
        fin, sums, ok = fused_chunk(
            system, bath_factors(fr.baths, device),
            [torch.as_tensor(x, dtype=dtype, device=device) for x in rs],
            nsteps, 0, None, nsteps // 4, states=thermal_init(
                torch.as_tensor(us, dtype=dtype, device=device), system,
                fr.hw, fr.U, F.T))
        assert bool(ok)
        out.append((fin.p, fin.q, sums))
    errs = [rel_err(a, b)[0] for a, b in zip(*out)]
    print(json.dumps({"phase": 14, "nsteps": nsteps,
                      "rel_err": dict(zip(("p", "q", "cur_sum"), errs)),
                      "rtol": RTOL}), flush=True)
    assert max(errs) <= RTOL, errs


def _against_float64(drv, ref, q, phase, name):
    """A K5/K8 driver on the card against its float64 twin on the CPU at
    q: force and energy within RTOL of the largest, a bitwise repeat, and
    exactly zero at rest. Returns the largest absolute error."""
    e, f = drv.energy_force_torch(q)
    again = drv.force_torch(q)
    rest = drv.force_torch(torch.zeros_like(q))
    torch.cuda.synchronize()
    qc = q.double().cpu()
    pairs = [ref.energy_force_torch(qc[i:i + 64])
             for i in range(0, q.shape[0], 64)]
    e64 = torch.cat([p_[0] for p_ in pairs])
    f64 = torch.cat([p_[1] for p_ in pairs])
    rel, err = rel_err(f, f64)
    e_rel = rel_err(e, e64)[0]
    print(json.dumps({
        "phase": phase, "case": name, "ntraj": q.shape[0],
        "rel_err_float64_twin": rel, "max_abs_err": err,
        "energy_rel_err": e_rel, "rtol": RTOL,
        "largest_force": float(f64.abs().max()),
        "bitwise_repeat": bool(torch.equal(f, again)),
        "zero_at_rest": not bool(rest.any())}), flush=True)
    assert rel <= RTOL and e_rel <= RTOL, \
        f"{name}: the kernel disagrees with its float64 twin: {rel}, {e_rel}"
    assert torch.equal(f, again), f"{name}: no bitwise repeat"
    assert not rest.any(), f"{name}: force at rest is not zero"
    return err


def _thermal_q(drv, ntraj, dev, seed, amp=0.05):
    """Displacements of ``amp`` angstrom rms per coordinate, in q."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    conv = torch.as_tensor(drv.conv, dtype=torch.float32, device=dev)
    return amp * torch.randn((ntraj, 3 * drv.number), device=dev,
                             generator=gen) / conv


def check_k5_geometries(dev, ntraj=128):
    """Phase 12, the cases the redesign opened: a periodic cell, a table
    wider than 16, and the reference's large ribbon of 1,270 atoms, whose
    constants and working regions the kernel keeps in global memory."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver, terminate_with_h
    from sclmd_tpu_torch.models.tersoff import graphene_ribbon
    x0 = graphene_ribbon(3, 3)
    cell = np.array([x0[:, 0].max() + 1.42, 40.0, 20.0])
    ribbon = terminate_with_h([["C", *row] for row in graphene_ribbon(4, 3)])
    cases = {   # name: (atoms, driver options, trajectories, placement)
        "periodic_cell": (terminate_with_h([["C", *row] for row in x0],
                                           cell=cell), dict(cell=cell),
                          ntraj, "shared"),
        "wide_rows": (ribbon, dict(cutoff_skin=2.5), ntraj, "shared"),
        "large_ribbon": (terminate_with_h(
            [["C", *row] for row in graphene_ribbon(90, 6)]), {}, 32,
            "global"),
    }
    worst = 0.0
    for i, (name, (axyz, kw, n, place)) in enumerate(cases.items()):
        drv = CHDriver(axyz, dtype=torch.float32, device=dev, **kw)
        ref = CHDriver(axyz, dtype=torch.float64, device="cpu", **kw)
        width = drv.energy_fn.terms["nbr_c"].shape[1]
        assert drv.kernel.cuda is not None, name
        assert name != "wide_rows" or width > 16, width
        plan = drv.kernel.cuda.plan(n)
        assert plan["place"] == place, (name, plan["place"])
        before = K5.launches
        q = _thermal_q(drv, n, dev, 40 + i)
        worst = max(worst, _against_float64(drv, ref, q, 12, name))
        assert K5.launches == before + 3, (name, K5.launches - before)
        w = K5.work_counts(drv.kernel.cuda.pack)
        print(json.dumps({"phase": 12, "case": name, "atoms": len(axyz),
                          "place": place, "ntraj": n,
                          "ms": cuda_ms(lambda: drv.force_torch(q), 20),
                          "bound_ms": bound_ms(n * w["ops"], n * w["bytes"]),
                          "work": w}),
              flush=True)
    return worst


def phase_tersoff_sheet(dev, nsteps=48):
    """Phase 15: K8 on the periodic sheet: against its float64 twin, its
    times, RunEnsemble(128) with the launch counter read around it, and
    48 steps on the card against float64 on the CPU."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.parallel.ensemble import bath_factors, fused_chunk
    from sclmd_tpu_torch.tools import sheet as S
    from sclmd_tpu_torch.tools.flagship import chunk_sizes

    ntraj = SHEET_NTRAJ
    r = S.sheet_runner(torch.float32, dev, tempfile.mkdtemp())
    drv = r.pforce
    assert drv.kernel.cuda.pack["kind"] == "tersoff"
    ref = S.sheet_runner(torch.float64, "cpu", tempfile.mkdtemp()).pforce
    q = _thermal_q(drv, ntraj, dev, 15)
    err = _against_float64(drv, ref, q, 15, "tersoff_sheet")

    t = k5_times(drv, q)

    r.RunEnsemble(ntraj, nsteps=S.NMD)            # warm-up
    torch.cuda.synchronize()
    K5.reset_count()
    reset_k3()
    t0 = time.perf_counter()
    with GeneratorCount() as gens:
        means = r.RunEnsemble(ntraj, nsteps=S.NMD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert gens.n == 0, gens.n
    launches = K5.launches_tersoff
    k3 = k3_counts()
    # the sheet starts at rest: noise for its two baths, no phases
    nchunks = len(chunk_sizes(r._build_system(), ntraj))
    assert k3 == {"noise_synth": 2 * nchunks, "init_draw": 0,
                  "noise_transpose": 2 * nchunks}, k3
    ke = r.energy(r.state)
    assert means.shape == (ntraj, 2) and np.isfinite(means).all()
    assert np.isfinite(ke) and 0.0 < ke < KE_BOUND, ke
    # (the sheet's nmd is the flagship's, so are its chunks' rules)
    assert launches == 2 * S.NMD * len(chunk_sizes(r._build_system(), ntraj)) \
        and K5.launches == 0, launches

    rng = np.random.default_rng(15)
    rs = [rng.standard_normal((4,) + np.shape(b.nstd)) for b in r.baths]
    out = []
    for dtype, device in ((torch.float32, dev), (torch.float64, "cpu")):
        rr = S.sheet_runner(dtype, device, tempfile.mkdtemp())
        fin, sums, ok = fused_chunk(
            rr._build_system(), bath_factors(rr.baths, device),
            [torch.as_tensor(x, dtype=dtype, device=device) for x in rs],
            nsteps, 0, None, nsteps // 4)
        assert bool(ok)
        out.append((fin.p, fin.q, sums))
    errs = [rel_err(a, b)[0] for a, b in zip(*out)]
    print(json.dumps({
        "phase": 15, "launches": {"tersoff_force": launches, **k3},
        "e2e": {ntraj: {"s": wall, "traj_steps_per_s": ntraj * S.NMD / wall,
                        "kinetic_energy_end": ke}},
        "ms": t, "nsteps": nsteps,
        "rel_err": dict(zip(("p", "q", "cur_sum"), errs)), "rtol": RTOL}),
        flush=True)
    assert max(errs) <= RTOL, errs
    return {"launches": {"tersoff_force": launches, **k3}, "abs": err,
            "times": t}


# --- noise synthesis: K3 and K3b -------------------------------------------
K3_SEED = 2026


def batch_factors(nc, nmd, dev, seed=3):
    """Per-frequency (nmd/2+1, nc, nc) factors of a random Hermitian PSD
    that is not proportional across frequencies, complex64 and float32,
    as ``kernels.noise_synth.Factors``."""
    from sclmd_tpu_torch.kernels.noise_synth import Factors
    from sclmd_tpu_torch.ops.noise import factor_matrix, noise_factors
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc))
    h = nmd // 2 + 1
    w = np.linspace(0.0, 1.0, h)[:, None, None]
    m = base[None] * np.exp(-w) + 1j * w * base.T[None]
    psd = m @ np.conj(np.swapaxes(m, 1, 2)) + nc * np.eye(nc)[None]
    ev, std = noise_factors(psd, dtype=np.float32)
    ev = factor_matrix(ev)
    assert ev.ndim == 3, "the spectrum must not be proportional"
    return Factors(torch.as_tensor(ev, device=dev),
                   torch.as_tensor(std, device=dev))


def prop_factors(nc, nmd, dev, seed=4):
    """One (nc, nc) complex64 matrix of a random proportional spectrum and
    its float32 std, as ``kernels.noise_synth.Factors``."""
    from sclmd_tpu_torch.kernels.noise_synth import Factors
    from sclmd_tpu_torch.ops.noise import factor_matrix, noise_factors
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc))
    h = nmd // 2 + 1
    psd = (np.abs(rng.normal(size=h)) + 0.1)[:, None, None] * \
        (m @ m.conj().T + nc * np.eye(nc))[None]
    ev, std = noise_factors(psd, dtype=np.float32)
    ev = factor_matrix(ev)
    assert ev.ndim == 2, "the spectrum must be proportional"
    return Factors(torch.as_tensor(ev, device=dev),
                   torch.as_tensor(std, device=dev))


def k3_operands(dev):
    """K3's factors and windows at the shapes the main path gives it: the
    primary junction's baths (a scalar friction profile: one (90, 90)
    matrix, nmd 2048) at each chunk shape of phase 5, the flagship's
    electron baths (one (150, 150) matrix, nmd 1024) at each chunk shape
    of phase 10, the periodic sheet's (one (48, 48) matrix, nmd 1024) at
    the chunk shapes of phase 15's 128 trajectories, md.Run's window of
    phase 9 (run j = 1 of the primary: trajectories [1, 2)), the
    per-frequency batch path (the phonon baths of a matrix-valued friction
    profile; here a random PSD of the primary's widths, nc 90, nmd 2048)
    at phase 5's chunk shapes, and a random proportional spectrum of
    nc 37 (padded to 40) at 100 trajectories; K3b at the thermal starts
    of the runners' chunks and of md.Run (window [0, 1)). Each K3 case is
    (factors, dt, nmd, ntraj, lo), each K3b case (runner, ntraj, lo);
    phase 16 holds the runners' chunks at lo = 3, a window inside the
    ensemble."""
    from sclmd_tpu_torch.parallel.ensemble import bath_factors
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools import primary as P
    from sclmd_tpu_torch.tools import sheet as S

    pr = P.primary_runner(torch.float32, dev, tempfile.mkdtemp())
    fr = F.flagship_runner(torch.float32, dev, tempfile.mkdtemp())
    sr = S.sheet_runner(torch.float32, dev, tempfile.mkdtemp())
    pshapes = sorted({n for ntraj in SIZES
                      for n in P.chunk_sizes(pr._build_system(), ntraj)})
    fshapes = sorted({n for ntraj in FLAG_SIZES
                      for n in F.chunk_sizes(fr._build_system(), ntraj)})
    sshapes = sorted(set(F.chunk_sizes(sr._build_system(), SHEET_NTRAJ)))
    bfac = batch_factors(P.NC, P.NMD, dev)
    k3, k3b = {}, {}
    for name, r, shapes in (("primary", pr, pshapes),
                            ("flagship", fr, fshapes),
                            ("sheet", sr, sshapes)):
        fac = bath_factors(r.baths, dev)[0]
        for n in shapes:
            k3[f"{name}_{n}"] = (fac, r.dt, r.nmd, n, 3)
            if name != "sheet":         # the sheet starts at rest
                k3b[f"{name}_{n}"] = (r, n, 3)
    k3["run_window"] = (bath_factors(pr.baths, dev)[0], pr.dt, pr.nmd, 1, 1)
    k3b["run_window"] = (pr, 1, 0)
    for n in pshapes:
        k3[f"batch_{n}"] = (bfac, P.DT, P.NMD, n, 3)
    k3["narrow_37"] = (prop_factors(37, 1024, dev), 0.5, 1024, 100, 3)
    return {"k3": k3, "k3b": k3b}


def _k3(fac, dt, nmd, lo, hi, stream=0, **kw):
    from sclmd_tpu_torch.kernels import noise_synth as K3
    ev, std = fac
    return K3.noise_halfspectrum_cuda(ev, std, K3_SEED, stream, lo, hi,
                                      1.0 / (nmd * dt), packed=fac.packed,
                                      **kw)


def _device_ms(fn, name):
    """The profiler's device time of a launch of ``name`` (the event time
    of a few-microsecond kernel is the host's enqueue); None where three
    traces lost most launches."""
    from sclmd_tpu_torch.tools.plain_bench import device_us
    try:
        return 1e-3 * sum(device_us(fn, reps=20, names=(name,)).values())
    except RuntimeError as e:
        print(json.dumps({"phase": 7, "kernel": name, "profiler": str(e)}),
              flush=True)
        return None


def k3_times(fac, dt, nmd, n, lo=0):
    """K3 at one shape: kernel (events and the profiler's device time),
    its twin on the card (int64 Philox, the product as batched
    matrix-vector products), the C2R stage on K3's output (one cuFFT plan
    and the permute to (n, nmd, nc)), the whole ``schedule_noise``, and
    the library composition ``noise_bench.library_series``:
    ``torch.randn`` x std, ``torch.matmul`` (one matrix) or
    ``torch.einsum`` (a batch), ``torch.fft.hfft`` / (nmd dt) made
    contiguous (no single PyTorch call computes K3's function). Bound: U
    and std read once, the half spectrum written once; 4 nc^2 operations
    per (trajectory, frequency) in 3xTF32 on the tensor cores. The C2R
    stage's bound: the half spectrum read once and the series written
    once."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.ops.noise import schedule_noise
    from sclmd_tpu_torch.tools.noise_bench import library_series
    ev, std = fac
    h, nc = std.shape

    def kernel():
        return _k3(fac, dt, nmd, lo, lo + n)

    work = K3.work_counts(nc, h, n, ev.shape[0] if ev.ndim == 3 else 1)
    t = _timed(kernel, lambda: K3.halfspectrum_plain(
        ev, std, K3_SEED, 0, lo, lo + n, 1.0 / (nmd * dt)),
        None, work["flops"], work["bytes"], 10, 1, tf32x3=True)
    t["event"] = t["kernel"]
    t["device"] = _device_ms(kernel, "noise_synth")
    y = kernel()
    # in place on K3's buffer, as schedule_noise runs it (y overwritten)
    t["c2r"] = cuda_ms(lambda: K3.c2r_series(y, nmd, consume=True), 10)
    # the C2R stage's last kernel alone: (n, nc, nmd) -> (n, nmd, nc),
    # bound by one read and one write; the library call is torch's
    # transpose made contiguous (also its twin)
    xs = torch.empty((n, nc, nmd), device=std.device).normal_()
    t["transpose"] = _timed(
        lambda: K3.transpose(xs), lambda: K3.transpose_plain(xs),
        lambda: xs.transpose(-1, -2).contiguous(), 0, 8 * xs.numel(), 10,
        10)
    del xs
    t["c2r_bound"] = 1e3 * K3.c2r_bytes(nmd, n, nc) / PEAK_HBM
    # the C2R stage's one-call PyTorch counterpart on the same half
    # spectrum and batch: torch.fft.hfft along frequency, output (n, nc,
    # nmd); beside it the same made contiguous in the stage's (n, nmd, nc)
    y = kernel()
    t["c2r_library"] = cuda_ms(
        lambda: torch.fft.hfft(y, n=nmd, dim=-1), 10)
    t["c2r_library_layout"] = cuda_ms(
        lambda: torch.fft.hfft(y, n=nmd, dim=-1).transpose(-1, -2)
        .contiguous(), 10)
    t["c2r_library_name"] = "torch.fft.hfft"
    del y
    t["series"] = cuda_ms(lambda: schedule_noise(
        ev, std, K3_SEED, 0, lo, lo + n, dt, nmd, packed=fac.packed), 10)
    t["library_composition"] = cuda_ms(
        lambda: library_series(ev, std, n, dt, nmd), 10)
    t["library_name"] = ("torch.randn + " + ("torch.matmul" if ev.ndim == 2
                                             else "torch.einsum")
                         + " + torch.fft.hfft")
    t["plan"] = K3.launch_plan(nc, n, h, ev.ndim == 3,
                               torch.cuda.get_device_properties(
                                   std.device).multi_processor_count)
    return t


# Philox4x32-10 and the uniform, counted as 32-bit integer operations per
# value: ten rounds of two 32x32-bit products (hi and lo), two xors and
# key additions per four words, then shift, or and convert; then the
# sine and cosine (counted as 4 operations each) and 4 products
K3B_OPS_PER_VALUE = 10 * (4 + 4 + 2) / 4 + 3 + 12


def k3b_times(r, n, lo=0):
    """K3b at one thermal start (the runner's ``md.ThermalStart``):
    kernel by events and by the profiler's device time (``kernel`` is the
    device time where the two differ by a tenth: the event loop then
    timed the host), its twin on the card (the same integers; the
    formula in float32), and the library composition ``torch.rand`` then
    the same elementwise formula (other bits; no single PyTorch call
    computes the function); bound by the amplitudes written once and am,
    hw read once. ``start``: the whole start of the window (K3b, the
    product with the eigenvectors, the mask)."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    st = r._thermal_start(r.T)
    system = r._build_system()
    nm = st.am.numel()

    def kernel():
        return K3.thermal_amplitudes(K3_SEED, 2, lo, lo + n, st.am, st.hw)

    t = _timed(kernel, lambda: K3.thermal_amplitudes_plain(
        K3_SEED, 2, lo, lo + n, st.am, st.hw), None,
        K3B_OPS_PER_VALUE * n * nm, 4 * (2 * n * nm + 2 * nm), 50, 5)
    t["event"] = t["kernel"]
    t["device"] = _device_ms(kernel, "init_draw")
    if t["device"] is not None and \
            abs(t["event"] - t["device"]) > 0.1 * t["device"]:
        t["kernel"] = t["device"]
    t["library_composition"] = cuda_ms(lambda: K3.amplitudes_of(
        torch.rand((n, nm), device=st.am.device), st.am, st.hw), 50)
    t["start"] = cuda_ms(lambda: st.states(system, K3_SEED, 2, lo, lo + n),
                         20)
    return t


def _expected_lag_cov(ev, std, dt, nmd, lag):
    """The time-averaged covariance <x_c(t) x_c(t+lag)> of the series,
    averaged over channels, from the factors (host float64): the
    frequencies are independent, and a paired frequency m contributes
    2 E|xi_m|^2 cos(2 pi m lag / nmd) (the pseudo-covariance of a real
    draw oscillates in t and averages out over the period)."""
    U = ev.detach().cpu().to(torch.complex128).numpy()
    s2 = std.detach().double().cpu().numpy() ** 2            # (h+1, nc)
    h = nmd // 2
    if U.ndim == 2:
        P = s2 @ (np.abs(U) ** 2).T                           # (h+1, nc)
        R0 = (U.real ** 2) @ s2[0]
        Rh = (U.real ** 2) @ s2[h]
    else:
        P = np.einsum("wck,wk->wc", np.abs(U) ** 2, s2)
        R0 = (U[0].real ** 2) @ s2[0]
        Rh = (U[h].real ** 2) @ s2[h]
    m = np.arange(1, h)
    c = R0 + (-1) ** lag * Rh + 2 * (np.cos(2 * np.pi * m * lag / nmd)
                                     @ P[1:h])
    return float(c.mean()) / (nmd * dt) ** 2


def check_k3_case(phase, name, fac, dt, nmd, n, lo):
    """K3 at one shape against its twins: the draw, the folded half
    spectrum (float64 twin), the C2R series and the layout kernel; a
    bitwise repeat, the same bits at other launch shapes, real edge
    rows, and the C2R call leaving its input as it was. Returns the
    largest absolute errors of the half spectrum and of the transpose."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    ev, std = fac
    h, nc = std.shape
    y = _k3(fac, dt, nmd, lo, lo + n, stream=1)
    again = _k3(fac, dt, nmd, lo, lo + n, stream=1)
    shapes, same_bits = [], True
    full = K3.launch_plan(nc, n, h, ev.ndim == 3, nsm)
    for cw in sorted({1, max(1, full["cw"] // 2), full["cw"]}):
        p = K3.launch_plan(nc, n, h, ev.ndim == 3, nsm, cw=cw)
        grids = [p["grid"]] if ev.ndim == 3 else \
            sorted({p["grid"], max(1, p["grid"] // 3)})
        for grid in grids:
            shapes.append([cw, grid])
            same_bits &= bool(torch.equal(_k3(
                fac, dt, nmd, lo, lo + n, stream=1,
                plan=dict(p, grid=grid)), y))
    draw = _k3(fac, dt, nmd, lo, lo + n, stream=1, draw_only=True)
    want_draw = K3.draw_plain(std.double(), K3_SEED, 1, lo, lo + n)
    draw_rel = rel_err(draw, want_draw)[0]
    del draw, want_draw
    want = K3.halfspectrum_plain(ev.to(torch.complex128), std.double(),
                                 K3_SEED, 1, lo, lo + n,
                                 1.0 / (nmd * dt))
    xi_rel, xi_abs = rel_err(y, want)
    edges_real = not (y[..., 0].imag.any() or y[..., -1].imag.any())
    bitwise = bool(torch.equal(y, again))
    del again
    xs = torch.randn((n, nc, nmd), device=std.device)
    tr_abs = float((K3.transpose(xs) - K3.transpose_plain(xs)).abs()
                   .max())
    del xs
    # the public call leaves its input as it was; the main path's in
    # place run on K3's buffer gives the same bits
    y0 = y.clone()
    series = K3.c2r_series(y, nmd)
    input_kept = bool(torch.equal(y, y0))
    series_rel = rel_err(series, K3.c2r_plain(want, nmd))[0]
    in_place_same = bool(torch.equal(
        K3.c2r_series(y, nmd, consume=True), series))
    del want, y, y0, series
    out = {"phase": phase, "case": name, "ntraj": n, "lo": lo, "nc": nc,
           "factors": "batch" if ev.ndim == 3 else "one matrix",
           "plan": K3.launch_plan(nc, n, h, ev.ndim == 3, nsm),
           "draw_rel_err": draw_rel, "draw_rtol": DRAW_RTOL,
           "halfspectrum_rel_err": xi_rel, "series_rel_err": series_rel,
           "rtol": RTOL, "bitwise_repeat": bitwise,
           "edge_rows_real": edges_real, "transpose_abs_err": tr_abs,
           "launch_shapes_cw_grid": shapes,
           "same_bits_every_shape": same_bits,
           "c2r_input_kept": input_kept,
           "c2r_in_place_same_bits": in_place_same}
    print(json.dumps(out), flush=True)
    assert draw_rel <= DRAW_RTOL and xi_rel <= RTOL and \
        series_rel <= RTOL, out
    assert bitwise and same_bits and edges_real and tr_abs == 0.0 \
        and input_kept and in_place_same, out
    return xi_abs, tr_abs


def check_noise_synth(ops, nstat=1024):
    """Phase 16: K3 and K3b against their twins, bitwise repeats, the same
    bits at every launch shape, chunk invariance, and the statistics of a
    large draw. Returns the largest absolute errors (K3's folded half
    spectrum against its float64 twin; K3b's amplitudes against theirs)."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.md import thermal_init
    from sclmd_tpu_torch.ops import philox
    from sclmd_tpu_torch.ops.noise import schedule_noise
    worst = {"noise_synth": 0.0, "init_draw": 0.0, "noise_transpose": 0.0}
    for name, (fac, dt, nmd, n, lo) in ops["k3"].items():
        xi_abs, tr_abs = check_k3_case(16, name, fac, dt, nmd, n, lo)
        worst["noise_synth"] = max(worst["noise_synth"], xi_abs)
        worst["noise_transpose"] = max(worst["noise_transpose"], tr_abs)
    for name, (r, m, ulo) in ops["k3b"].items():
        st = r._thermal_start(r.T)
        nph, dev = st.am.numel(), st.am.device
        u = K3.init_uniforms_cuda(K3_SEED, 2, ulo, ulo + m, nph, dev)
        u_twin = philox.uniforms(K3_SEED, 2, ulo, ulo + m, nph, dev)
        amps = K3.thermal_amplitudes(K3_SEED, 2, ulo, ulo + m, st.am, st.hw)
        want = K3.thermal_amplitudes_plain(K3_SEED, 2, ulo, ulo + m,
                                           st.am.double(), st.hw.double())
        amp_rel, amp_abs = rel_err(amps, want)
        system = r._build_system()
        got = st.states(system, K3_SEED, 2, ulo, ulo + m)
        ref = thermal_init(u_twin, system, r.hw, r.U, r.T)
        start_rel = max(rel_err(got.p, ref.p)[0], rel_err(got.q, ref.q)[0])
        worst["init_draw"] = max(worst["init_draw"], amp_abs)
        out = {"phase": 16, "case": f"init_draw_{name}", "ntraj": m,
               "lo": ulo, "uniforms_bitwise": bool(torch.equal(u, u_twin)),
               "amplitudes_rel_err": amp_rel, "amplitudes_rtol": DRAW_RTOL,
               "start_rel_err": start_rel, "rtol": RTOL}
        print(json.dumps(out), flush=True)
        assert out["uniforms_bitwise"], out
        assert amp_rel <= DRAW_RTOL and start_rel <= RTOL, out
    for name in ("primary", "flagship", "batch"):
        fac, dt, nmd, *_ = next(v for k, v in ops["k3"].items()
                                if k.startswith(name))
        ev, std = fac

        def series(lo, hi, stream=0):
            return schedule_noise(ev, std, K3_SEED, stream, lo, hi, dt, nmd,
                                  packed=fac.packed)
        # one trajectory's series from a chunk of 256 and one of 64
        a, b = series(0, 256), series(192, 256)
        same = bool(torch.equal(a[200], b[8]) and torch.equal(a[192:], b))
        del a, b
        # statistics of a large draw against the factors' values
        x = series(0, nstat).double()
        v = (x * x).mean(dim=(1, 2))
        c1 = (x * torch.roll(x, -1, dims=1)).mean(dim=(1, 2))
        del x
        stats = {}
        for key, sample, lag in (("var", v, 0), ("lag1", c1, 1)):
            want = _expected_lag_cov(ev, std, dt, nmd, lag)
            got, se = float(sample.mean()), float(sample.std() / nstat ** 0.5)
            stats[key] = {"sample": got, "expected": want, "se": se,
                          "z": (got - want) / se}
        out = {"phase": 16, "case": f"{name}_statistics", "ntraj": nstat,
               "chunk_invariant": same, **stats}
        print(json.dumps(out), flush=True)
        assert same, out
        assert all(abs(s_["z"]) <= 5.0 for s_ in stats.values()), out
    return worst


def phase_crosscheck(dev, j_port, ntraj=256):
    """Phase 17: the MD-vs-NEGF thermal conductance of the harmonic
    flagship (``antithetic_run`` warm-started on the periodic attractor,
    float32 on the card) against the committed NEGF answer (the bar),
    and beside it against ``j_port``, phase 20's NEGF on the card."""
    from sclmd_tpu_torch import md as TMD
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.parallel import ensemble as TE
    from sclmd_tpu_torch.tools import flagship as F

    negf = np.load(F.NPZ)
    nmd, seed = 2 ** 14, 11
    TL, TR = F.T * (1 + F.DELTA / 2), F.T * (1 - F.DELTA / 2)

    def build(Ta, Tb):
        return F.flagship_runner(torch.float32, dev, tempfile.mkdtemp(),
                                 nmd=nmd, seed=seed, temps=(Ta, Tb))

    spent = {"jacobian_s": 0.0, "power_s": 0.0, "solve_s": 0.0}

    def timed(fn, key):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spent[key] += time.perf_counter() - t0
            return timed(out, "solve_s") if callable(out) else out
        return wrapped

    real = (TMD.gle_step_jacobian, TMD.period_power, TMD.fixed_point_solver)
    TMD.gle_step_jacobian = timed(real[0], "jacobian_s")
    TMD.period_power = timed(real[1], "power_s")
    TMD.fixed_point_solver = timed(real[2], "solve_s")
    reset_k3()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        j = TE.antithetic_run(build, TL, TR, ntraj, nsteps=nmd, seed=seed,
                              warm_start=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TMD.gle_step_jacobian, TMD.period_power, TMD.fixed_point_solver = real
    j_md, j_ref = float(j.mean()), float(negf["j_nat"])
    sem = float(j.std() / np.sqrt(len(j)))
    dev_pct = (j_md - j_ref) / j_ref * 100
    sem_pct = sem / abs(j_ref) * 100
    system = build(TL, TR)._build_system()
    nchunks = -(-ntraj // TE.auto_chunk(system, ntraj, nmd, None))
    out = {"phase": 17, "ntraj": ntraj, "nmd": nmd, "seed": seed,
           "dev_pct": dev_pct, "sem_pct": sem_pct,
           "kappa_md_nw_per_k": j_md / (F.T * F.DELTA) * units.CURCOF,
           "kappa_negf_nw_per_k": float(negf["kappa_nw_per_k"]),
           "j_md": j_md, "j_negf": j_ref, **spent, "wall_s": wall,
           "j_negf_port": j_port,
           "dev_pct_port": (j_md - j_port) / j_port * 100,
           "chunks": nchunks, "launches": k3_counts(),
           "dev_pct_bound": GATE_DEV_PCT, "sem_pct_bound": GATE_SEM_PCT}
    print(json.dumps(out), flush=True)
    # two baths, one synthesis per chunk and direction; zero starts
    assert out["launches"] == {"noise_synth": 2 * 2 * nchunks,
                               "init_draw": 0,
                               "noise_transpose": 2 * 2 * nchunks}, \
        out["launches"]
    assert np.isfinite(j).all(), j
    assert abs(dev_pct) <= GATE_DEV_PCT and sem_pct <= GATE_SEM_PCT, out


# --- the slabs: K9 (Stillinger-Weber) and K10 (EAM) -------------------------
SLAB_NTRAJ = 64           # RunEnsemble trajectories of phases 18 and 19
SLAB_NSTEPS, SLAB_NPIE = 1024, 2
SLAB_CHECK_NTRAJ = 4      # trajectories of the checks against the twins
# K9/K10 against their float64 twins: the energy sums ~1e3 terms of
# either sign, so it is held to 1e-5 of the largest, the force to RTOL
SLOT_ENERGY_RTOL = 1e-5
SLOT_NTRAJ = (1, 37, 64, 65)  # batch sizes of the small-cell checks
PARENT = "f915d1b"        # the commit whose K9/K10 the "earlier" column times


def slab_kernel_checks(dev, phase, name, drv, ref, mod, seed):
    """K9 or K10 on a slab at thermal displacements of SLAB_CHECK_NTRAJ
    trajectories: against its float32 twin on the card and its float64
    twin on the CPU (force and energy within RTOL of the largest), a
    bitwise repeat and zero at rest; at the RunEnsemble's SLAB_NTRAJ
    trajectories against its float32 twin again (force and energy within
    RTOL) with a bitwise repeat; then its times there with its float32
    twin's (no single library call computes it) and the bound: q read
    and f written once per trajectory, the table once, and the
    operations this geometry needs (``work_counts``) at the float32
    peak. Returns (the largest absolute error against either twin,
    times, q)."""
    q = _thermal_q(drv, SLAB_CHECK_NTRAJ, dev, seed)
    err = _against_float64(drv, ref, q, phase, name)
    e, f = drv.energy_force_torch(q)
    e32, f32 = drv.kernel.plain(q, energy=True)
    rel32, e_rel32 = rel_err(f, f32)[0], rel_err(e, e32)[0]
    print(json.dumps({"phase": phase, "case": name,
                      "rel_err_float32_twin": rel32,
                      "energy_rel_err_float32_twin": e_rel32,
                      "rtol": RTOL}), flush=True)
    assert rel32 <= RTOL and e_rel32 <= RTOL, \
        f"{name}: the kernel disagrees with its float32 twin: {rel32}, " \
        f"{e_rel32}"
    from sclmd_tpu_torch.kernels import slots
    from sclmd_tpu_torch.tools.slab_bench import lane_agreement
    kern = drv.kernel.cuda
    for n in (SLAB_NTRAJ, SLAB_NTRAJ + 1):
        qn = _thermal_q(drv, n, dev, seed + 1)
        e, f = drv.energy_force_torch(qn)
        e32, f32 = drv.kernel.plain(qn, energy=True)
        (rel_n, abs_n), e_rel_n = rel_err(f, f32), rel_err(e, e32)[0]
        bitwise = bool(torch.equal(drv.force_torch(qn), f))
        # a trajectory alone has the bits it has in the batch
        alone = all(torch.equal(drv.force_torch(qn[t_:t_ + 1])[0], f[t_])
                    for t_ in (0, 31, 32, n - 1))
        # the wide route: rows read from global memory, entries kept in
        # a global scratch
        kern.plan = slots.Plan(slots.MAX_WARPS, 0, True)
        wide = bool(torch.equal(drv.force_torch(qn), f))
        kern.plan = slots.launch_plan(kern.smem_per_warp(kern.pack))
        out = {"phase": phase, "case": name, "ntraj": n,
               "rel_err_float32_twin": rel_n,
               "max_abs_err_float32_twin": abs_n,
               "energy_rel_err_float32_twin": e_rel_n,
               "bitwise_repeat": bitwise, "alone_bitwise": alone,
               "wide_route_bitwise": wide, "plan": kern.plan._asdict(),
               "rtol": RTOL}
        print(json.dumps(out), flush=True)
        assert rel_n <= RTOL and e_rel_n <= RTOL and bitwise and alone \
            and wide, out
        err = max(err, abs_n)
        del e, f, e32, f32
    n = SLAB_NTRAJ
    qn = _thermal_q(drv, n, dev, seed + 1)
    rc = kern.pack["params"]["rc"] if "params" in kern.pack \
        else kern.pack["rc"]
    lanes = lane_agreement(kern.pack, qn, rc)
    w = mod.work_counts(kern.pack)
    t = _timed(lambda: drv.force_torch(qn), lambda: drv.kernel.plain(qn),
               None, n * w["ops"], n * w["bytes"] + w["table_bytes"], 20, 3)
    t["work"] = w
    t["lanes"] = lanes
    return err, t, q


def slot_small_cells(dev, phase, family):
    """K9 ("sw") or K10 ("eam") on small cells against their float64
    twins at each of SLOT_NTRAJ trajectories of 0.1 angstrom rms: force
    within RTOL and energy within SLOT_ENERGY_RTOL of the largest,
    bitwise repeats, zero at rest. SW: a periodic and an open
    ``diamond_cell(3, 2, 2)``, a table truncated to 10 (not symmetric),
    powers 4.5 and 0.25 (powf); EAM: a periodic ``fcc_cell(3, 3, 3)``
    of gold (cutoff 5.5), open, truncated to 30, powers 10.5 and 7.75,
    its tabulation, and a two-element table. Returns the largest
    absolute error."""
    from sclmd_tpu_torch.models import eam as E
    from sclmd_tpu_torch.models import sw as S
    if family == "sw":
        pos, cell = S.diamond_cell(3, 2, 2)
        axyz = [["Si", *p] for p in pos]
        real = dict(S.SW_PARAMS["Si"], p=4.5, q=0.25)
        cases = {"periodic": dict(cell=cell), "open": {},
                 "truncated": dict(cell=cell, max_nnei=10),
                 "powf": dict(cell=cell, params=real)}
        make = S.SWDriver
    else:
        pos, cell = E.fcc_cell(3, 3, 3, 4.08)
        real = dict(E.SUTTON_CHEN_PARAMS["Au"], n=10.5, m=7.75)
        tab = E.sutton_chen_tables("Au", rcut=5.5, rho_max=600.0)
        au = [["Au", *p] for p in pos]
        alloy = [[("Au", "Ag")[i % 2], *p] for i, p in enumerate(pos)]
        cases = {"periodic": dict(cell=cell, rcut=5.5),
                 "open": dict(rcut=5.5),
                 "truncated": dict(cell=cell, rcut=5.5, max_nnei=30),
                 "powf": dict(cell=cell, rcut=5.5, params=real),
                 "tabulated": dict(cell=cell, setfl=tab),
                 "alloy": dict(cell=cell, setfl=_alloy_setfl())}
        make = E.EAMDriver
    worst = 0.0
    for name, kw in cases.items():
        atoms = alloy if name == "alloy" else \
            (axyz if family == "sw" else au)
        drv = make(atoms, dtype=torch.float32, device=dev, **kw)
        ref = make(atoms, dtype=torch.float64, device="cpu", **kw)
        assert drv.kernel.cuda is not None, name
        res = {}
        for n in SLOT_NTRAJ:
            q = _thermal_q(drv, n, dev, 100 + n, amp=0.1)
            e, f = drv.energy_force_torch(q)
            again = drv.force_torch(q)
            rest = drv.force_torch(torch.zeros_like(q))
            torch.cuda.synchronize()
            e64, f64 = ref.energy_force_torch(q.double().cpu())
            (rel, err), e_rel = rel_err(f, f64), rel_err(e, e64)[0]
            res[n] = {"rel": rel, "energy_rel": e_rel,
                      "bitwise_repeat": bool(torch.equal(f, again)),
                      "zero_at_rest": not bool(rest.any())}
            worst = max(worst, err)
            assert rel <= RTOL and e_rel <= SLOT_ENERGY_RTOL and \
                res[n]["bitwise_repeat"] and res[n]["zero_at_rest"], \
                (family, name, n, res[n])
        print(json.dumps({"phase": phase, "case": f"{family}_{name}",
                          "atoms": len(atoms), "against_float64": res,
                          "rtol": RTOL, "energy_rtol": SLOT_ENERGY_RTOL}),
              flush=True)
    return worst


def _alloy_setfl():
    """A setfl dict of the Sutton-Chen sets of Au and Ag (cutoff 5.5) on
    one grid, the cross pair the mean of the two."""
    from sclmd_tpu_torch.models import eam as E
    tabs = [E.sutton_chen_tables(e, rcut=5.5, rho_max=600.0)
            for e in ("Au", "Ag")]
    t = dict(tabs[0])
    t.update(elements=["Au", "Ag"], mass=np.zeros(2),
             F=np.concatenate([x["F"] for x in tabs]),
             rho=np.concatenate([x["rho"] for x in tabs]),
             rphi=np.stack([tabs[0]["rphi"][0],
                            0.5 * (tabs[0]["rphi"][0] + tabs[1]["rphi"][0]),
                            tabs[1]["rphi"][0]]),
             pair_index=np.array([[0, 1], [1, 2]], np.int32))
    return t


def parent_tree():
    """(root, None) of a tree of PARENT, whose K9/K10 the "earlier"
    column times: this checkout's ``_checkout/parent``, or a ``git
    archive`` of the commit into a temporary directory; (None, why)
    where neither is found."""
    root = os.path.dirname(os.path.abspath(__file__))
    cand = os.path.join(root, "_checkout", "parent")
    if os.path.isfile(os.path.join(cand, "sclmd_tpu_torch", "tools",
                                   "slab.py")):
        return cand, None
    tmp = tempfile.mkdtemp()
    try:
        tar = subprocess.run(["git", "-C", root, "archive", PARENT],
                             capture_output=True, check=True,
                             timeout=120).stdout
        subprocess.run(["tar", "-x", "-C", tmp], input=tar, check=True,
                       timeout=120)
        return tmp, None
    except (OSError, subprocess.SubprocessError) as e:
        return None, f"no tree of {PARENT}: {type(e).__name__}"


def earlier_slab_times(tree):
    """PR 9's K9 and K10 times at the slabs' 64 trajectories (the same
    thermal displacements), from ``tools/slab_bench.py --kernels-only``
    of this tree run on ``tree``'s package in a process of its own;
    {case: ms}, or the reason it could not run."""
    if tree is None:
        return None
    bench = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "sclmd_tpu_torch", "tools", "slab_bench.py")
    env = dict(os.environ, PYTHONPATH=tree)
    res = subprocess.run([sys.executable, bench, "--kernels-only",
                          "--label", "parent"], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        return {"error": res.stderr[-2000:]}
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    return {f["case"]: f["ms"] for f in rec["forces"]}


def slab_runs(dev, phase, kind, drv, mod, name, full=True):
    """The slab's ``RunEnsemble(SLAB_NTRAJ, npie=SLAB_NPIE,
    checkpoint=True)`` with the launch counters read around it (the
    force kernel twice a step, K7 three times, on its unstaged route for
    a system too wide to stage, K3 once per bath; no K6: baths of memory
    length 1 read no history; no K3b: the slab starts at rest; no
    ``torch.Generator``): finite currents and ``MDE.npz``. With ``full``
    also: the same draws in one segment (``npie=1``) within RTOL; a
    second call in the same outdir after the kappa files are deleted
    resumes from ``MDE.npz`` (no force launch) with the same means and
    files; another chunk raises the stale-checkpoint ValueError; the
    same draws at swapped lead temperatures give heat flowing from the
    hot lead to the cold one."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import conv_tails as K6
    from sclmd_tpu_torch.tools import slab as SL
    from sclmd_tpu_torch.tools.slab_bench import lane_agreement

    hot, cold = SL.T * (1 + SL.DELTA / 2), SL.T * (1 - SL.DELTA / 2)
    outdir = tempfile.mkdtemp()
    t0 = time.perf_counter()
    r = SL.slab_runner(kind, torch.float32, dev, outdir, driver=drv)
    bath_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mod.reset_count()
    K7.reset_count()
    K6.reset_count()
    reset_k3()
    kw = dict(nsteps=SLAB_NSTEPS, npie=SLAB_NPIE)
    with GeneratorCount() as gens:
        t0 = time.perf_counter()
        means = r.RunEnsemble(SLAB_NTRAJ, checkpoint=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: mod.launches, "bath_force": K7.launches,
                "bath_force_wide": K7.launches_wide,
                "conv_tails": K6.launches, **k3_counts()}
    wide = r.nph > 9000
    assert gens.n == 0, gens.n
    assert launches == {name: 2 * SLAB_NSTEPS,
                        "bath_force": 3 * SLAB_NSTEPS,
                        "bath_force_wide": 3 * SLAB_NSTEPS if wide else 0,
                        "conv_tails": 0, "noise_synth": 2, "init_draw": 0,
                        "noise_transpose": 2}, launches
    ke = r.energy(r.state)
    assert means.shape == (SLAB_NTRAJ, 2) and np.isfinite(means).all()
    assert np.isfinite(ke) and ke > 0.0, ke
    ck = os.path.join(outdir, "MDE.npz")
    assert os.path.isfile(ck)
    pack = drv.kernel.cuda.pack
    with np.load(ck) as z:
        q_end = torch.as_tensor(z["q"], device=dev)
    lanes_end = lane_agreement(
        pack, q_end, pack["params"]["rc"] if "params" in pack else pack["rc"])
    del q_end
    out = {"phase": phase, "case": kind, "nph": r.nph,
           "bath_dofs": [b.nc for b in r.baths], "bath_setup_s": bath_s,
           "launches": launches,
           "e2e": {SLAB_NTRAJ: {
               "s": wall, "traj_steps_per_s": SLAB_NTRAJ * SLAB_NSTEPS / wall,
               "kinetic_energy_end": ke,
               "J_left": float(means[:, 0].mean()),
               "J_right": float(means[:, 1].mean())}},
           "checkpoint_mb": os.path.getsize(ck) / 2 ** 20,
           "lanes_end_state": lanes_end}
    if not full:
        print(json.dumps(out), flush=True)
        return launches

    r1 = SL.slab_runner(kind, torch.float32, dev, tempfile.mkdtemp(),
                        driver=drv)
    t0 = time.perf_counter()
    fused = r1.RunEnsemble(SLAB_NTRAJ, nsteps=SLAB_NSTEPS)
    torch.cuda.synchronize()
    out["e2e_npie1_s"] = time.perf_counter() - t0
    out["segmented_vs_one_rel"] = rel_err(torch.as_tensor(means),
                                          torch.as_tensor(fused))[0]
    assert out["segmented_vs_one_rel"] <= RTOL, out

    for f in os.listdir(outdir):
        if f.startswith("kappa."):
            os.remove(os.path.join(outdir, f))
    mod.reset_count()
    again = r.RunEnsemble(SLAB_NTRAJ, checkpoint=True, **kw)
    nfiles = len([f for f in os.listdir(outdir) if f.startswith("kappa.")])
    out["resumed"] = {"same_means": bool(np.array_equal(again, means)),
                      "force_launches": mod.launches, "kappa_files": nfiles}
    assert out["resumed"] == {"same_means": True, "force_launches": 0,
                              "kappa_files": 2 * SLAB_NTRAJ}, out
    try:
        r.RunEnsemble(SLAB_NTRAJ, checkpoint=True, chunk=SLAB_NTRAJ // 2,
                      **kw)
        raise AssertionError("a stale MDE.npz was not refused")
    except ValueError as e:
        assert "stale checkpoint" in str(e), e
        out["stale_refused"] = True

    rr = SL.slab_runner(kind, torch.float32, dev, tempfile.mkdtemp(),
                        temps=(cold, hot), driver=drv)
    rev = rr.RunEnsemble(SLAB_NTRAJ, **kw)
    j = (means - rev) / 2                     # common random numbers
    out["J_left"], out["J_right"] = float(j[:, 0].mean()), \
        float(j[:, 1].mean())
    out["J_sem"] = (j.std(axis=0) / np.sqrt(SLAB_NTRAJ)).tolist()
    print(json.dumps(out), flush=True)
    assert np.isfinite(rev).all() and out["J_left"] > 0 > out["J_right"], out
    return launches


def slab_bath_kernels(dev, phase, drv, kind):
    """K3 at the slab's bath factors (one proportional matrix, nc 864 or
    432, nmd 1024) at SLAB_NTRAJ trajectories against its twins, as
    phase 16 holds it (``check_k3_case``: at nc 864 U is read from global
    memory), and its times as phase 7 takes them; K7's three stages at
    the slab's shapes and SLAB_NTRAJ trajectories against their twins on
    the same tensors (every output within RTOL of its largest), the
    route they take (staged or not), and their times, as phase 7 takes
    them."""
    from sclmd_tpu_torch.parallel.ensemble import bath_factors
    from sclmd_tpu_torch.tools import slab as SL
    from sclmd_tpu_torch.tools.plain_bench import K7Case
    r = SL.slab_runner(kind, torch.float32, dev, tempfile.mkdtemp(),
                       driver=drv)
    fac = bath_factors(r.baths, dev)[0]
    k3_abs, tr_abs = check_k3_case(phase, f"{kind}_slab_nc{r.baths[0].nc}",
                                   fac, r.dt, r.nmd, SLAB_NTRAJ, 0)
    k3 = k3_times(fac, r.dt, r.nmd, SLAB_NTRAJ)
    c = K7Case(r.baths, SLAB_NTRAJ, r.nph, r.nmd, r.dt, dev, 18)
    got, want = k7_outputs(c, True), k7_outputs(c, False)
    k7_err = [rel_err(got[k], want[k]) for k in want]
    k7_rel = max(e[0] for e in k7_err)
    assert k7_rel <= RTOL, f"K7 at the slab's shapes: {k7_rel}"
    return {"k3": k3, "k3_abs_err": k3_abs, "transpose_abs_err": tr_abs,
            "k7": k7_times(c), "k7_rel_err": k7_rel,
            "k7_abs_err": max(e[1] for e in k7_err),
            "k7_staged": c.force.stages[0].staged,
            "k7_tile": c.force.tile}


def phase_si_slab(dev):
    """Phase 18: the 3,456-atom silicon slab under Stillinger-Weber
    forces, K9."""
    from sclmd_tpu_torch.kernels import sw_force as K9
    from sclmd_tpu_torch.tools import slab as SL

    t0 = time.perf_counter()
    drv = SL.slab_driver("sw", torch.float32, dev)
    ref = SL.slab_driver("sw", torch.float64, "cpu")
    setup_s = time.perf_counter() - t0
    assert drv.kernel.cuda is not None
    err, t, _ = slab_kernel_checks(dev, 18, "sw_slab", drv, ref, K9, 18)
    del ref
    err = max(err, slot_small_cells(dev, 18, "sw"))
    baths = slab_bath_kernels(dev, 18, drv, "sw")
    print(json.dumps({"phase": 18, "driver_setup_s": setup_s, "ms": t,
                      "baths": baths}), flush=True)
    assert baths["k7_staged"] == 0
    launches = slab_runs(dev, 18, "sw", drv, K9, "sw_force")
    return {"launches": launches, "abs": err, "times": t, "baths": baths}


def phase_gold_slab(dev):
    """Phase 19: the 1,728-atom gold slab under EAM forces, K10 in both
    modes: analytic Sutton-Chen and the same set tabulated."""
    from sclmd_tpu_torch.kernels import eam_force as K10
    from sclmd_tpu_torch.tools import slab as SL

    out, errs, q = {}, [], None
    drvs = {}
    for kind in ("eam", "eam_tab"):
        t0 = time.perf_counter()
        drv = SL.slab_driver(kind, torch.float32, dev)
        ref = SL.slab_driver(kind, torch.float64, "cpu")
        out[kind] = {"driver_setup_s": time.perf_counter() - t0}
        assert drv.kernel.cuda is not None
        assert drv.kernel.cuda.pack["mode"] == (kind == "eam_tab")
        err, t, q = slab_kernel_checks(dev, 19, f"gold_{kind}", drv, ref,
                                       K10, 19)
        out[kind]["ms"] = t
        errs.append(err)
        drvs[kind] = (drv, ref)
    # the tabulation against the analytic set at the same geometry (the
    # same seed gave both routes the same q): within the splines' own
    # error, measured between the two float64 twins, plus float32
    # rounding
    (an, an64), (tab, tab64) = drvs["eam"], drvs["eam_tab"]
    qc = q.double().cpu()
    spline_err = float((tab64.force_torch(qc) - an64.force_torch(qc))
                       .abs().max())
    f_an = an.force_torch(q)
    gap = float((tab.force_torch(q) - f_an).abs().max())
    bound = spline_err + RTOL * float(f_an.abs().max())
    out["tabulated_vs_analytic"] = {"max_abs": gap, "spline_err": spline_err,
                                    "bound": bound}
    errs.append(slot_small_cells(dev, 19, "eam"))
    baths = slab_bath_kernels(dev, 19, an, "eam")
    print(json.dumps({"phase": 19, **out, "baths": baths}), flush=True)
    assert gap <= bound, out["tabulated_vs_analytic"]
    del an64, tab64, drvs
    la = slab_runs(dev, 19, "eam", an, K10, "eam_force")
    lt = slab_runs(dev, 19, "eam_tab", tab, K10, "eam_force", full=False)
    launches = {k: la[k] + lt[k] for k in la}
    return {"launches": launches, "abs": max(errs),
            "times": out["eam"]["ms"], "times_tab": out["eam_tab"]["ms"],
            "baths": baths}


# --- the NEGF stack: complex128 torch.linalg on the card (no hand kernel) --
def phase_negf(dev):
    """Phase 20: the harmonic flagship's transmission on the card, full
    width (nd 483 after the 120 fixed DOFs, baths of 150, 4,001 points,
    complex128), from the committed ``dyn_ev2`` with the parameters of
    ``scripts/exp_crosscheck_flagship.py``: the fixed DOFs split in
    halves, maxomega 0.45 eV, damp 0.1 ps, then ``landauer_current_natural``
    at T 300 K, delta 0.1, and ``thermalconductance``; against the
    committed ``tm``, ``j_nat`` and ``kappa_bpt``. The sweep is timed
    after one warm-up sweep, against its bound (``negf_flops`` at the FP64
    tensor-core peak), with one group's solve and assembly alone; then
    the whole grid built in one chunk against chunks of 32. Returns
    {"j_nat": ...}."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.negf import SOLVE_GROUP, landauer_current_natural
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools.negf_bench import negf_flops

    ref = np.load(F.NPZ)
    t0 = time.perf_counter()
    b = F.flagship_bpt(dev)
    setup_s = time.perf_counter() - t0
    left = b.dofatomofbath[0]
    npts, nd, nl = b.intnum + 1, b.nd, len(left)
    b.gettm()                                        # warm-up sweep
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tmn = b.gettm().copy()                           # host: synchronised
    sweep_s = time.perf_counter() - t0
    ws_ev, tm = tmn[:, 0] * units.RPC, tmn[:, 1]
    assert np.allclose(ws_ev, ref["ws_ev"], rtol=1e-15, atol=0), "grid"
    err = np.abs(tm - ref["tm"])
    worst = int(np.argmax(err))
    tm_rel = float(err[worst] / np.abs(ref["tm"]).max())
    TL, TR = F.T * (1 + F.DELTA / 2), F.T * (1 - F.DELTA / 2)
    j_nat = float(landauer_current_natural(ws_ev, tm, TL, TR))
    kappa = b.thermalconductance(F.T, F.DELTA)
    j_rel = abs(j_nat - float(ref["j_nat"])) / abs(float(ref["j_nat"]))
    k_rel = abs(kappa - float(ref["kappa_bpt"])) / abs(float(ref["kappa_bpt"]))

    # one group's batched solve alone (the library call the sweep makes
    # once a group) and the assembly of its matrices
    w = torch.as_tensor(tmn[1:1 + SOLVE_GROUP, 0], device=dev)
    a = b._amatrix(w)
    rhs = b._unit_columns(b._sel(left), SOLVE_GROUP)
    solve_ms = cuda_ms(lambda: torch.linalg.solve_ex(a, rhs), 5)
    assemble_ms = cuda_ms(lambda: b._amatrix(w), 5)
    del a, rhs

    # the whole grid built in one chunk (15 GB of matrices) against
    # chunks of 32: the solves take the same groups either way
    b.batch_size = npts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tm_one = b.gettm()[:, 1]
    one_chunk_s = time.perf_counter() - t0
    b.batch_size = 32
    torch.cuda.empty_cache()
    batch_rel = float(np.abs(tm_one - tm).max() / np.abs(tm).max())

    flops = negf_flops(nd, nl) * npts
    nbytes = 8 * nd * nd + 8 * npts          # D read once, T written once
    bound = bound_ms(flops, nbytes, PEAK_FP64_TC)
    out = {"phase": 20, "nd": nd, "n_left": nl, "points": npts,
           "dtype": "complex128", "setup_s": setup_s, "sweep_s": sweep_s,
           "ms_per_point": 1e3 * sweep_s / npts,
           "groups": -(-npts // SOLVE_GROUP), "group": SOLVE_GROUP,
           "flops_per_point": negf_flops(nd, nl), "flops": flops,
           "bound_ms": bound, "bound_by": "operations"
           if flops / PEAK_FP64_TC > nbytes / PEAK_HBM else "bytes",
           "share_of_bound": bound / (1e3 * sweep_s),
           "solve_ms_per_group": solve_ms,
           "assemble_ms_per_group": assemble_ms,
           "library_ms": solve_ms * -(-npts // SOLVE_GROUP),
           "library_name": "torch.linalg.solve_ex",
           "linalg_library": str(torch.backends.cuda
                                 .preferred_linalg_library()),
           "one_chunk_s": one_chunk_s,
           "tm_rel_err": tm_rel, "tm_worst_point": worst,
           "tm_worst_w_ev": float(ws_ev[worst]), "max_t": float(tm.max()),
           "j_nat": j_nat, "j_nat_ref": float(ref["j_nat"]),
           "j_nat_rel": j_rel, "kappa_bpt": kappa,
           "kappa_bpt_ref": float(ref["kappa_bpt"]), "kappa_rel": k_rel,
           "batch_rel_err": batch_rel, "rtol": NEGF_RTOL,
           "batch_rtol": NEGF_BATCH_RTOL}
    print(json.dumps(out), flush=True)
    assert np.isfinite(tm).all() and tm[0] == 0.0, tm[:4]
    assert tm_rel <= NEGF_RTOL, out
    assert j_rel <= NEGF_RTOL and k_rel <= NEGF_RTOL, out
    assert batch_rel <= NEGF_BATCH_RTOL, out
    return {"j_nat": j_nat}


def _sig_pair(dev):
    """``sig`` at examples/runsig.py's configuration on ``dev`` and on the
    CPU: the graphene strip ``graphene_ribbon(8, 2)``, the port's float64
    ``TersoffDriver.dynmat``, layers g0/g1 of four atoms at a quarter of
    the strip, 0.12 eV, num 400, eta 0.164e-3."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.models.tersoff import TersoffDriver, graphene_ribbon
    from sclmd_tpu_torch.selfenergy import sig
    x = graphene_ribbon(8, 2)
    drv = TersoffDriver([["C", *row] for row in x], dtype=torch.float64,
                        device=dev)
    d_ps2 = drv.dynmat().numpy() / units.RPC ** 2
    lay = 3 * (drv.number // 4)
    g0 = list(range(lay, lay + 12))
    g1 = list(range(lay + 12, lay + 24))
    return [sig(d_ps2, 0.12, g0, g1, num=400, eta=0.164e-3, device=d)
            for d in (dev, "cpu")]


def _sig_sweeps(m):
    """getse("L"), getse("R"), gettm() and their seconds."""
    t0 = time.perf_counter()
    out = (m.getse("L"), m.getse("R"), m.gettm()[:, 1])
    return out, time.perf_counter() - t0


def phase_lead_blocks(dev, ntraj=512):
    """Phase 21: the decimation on the card against the CPU in float64
    (Sigma_L, Sigma_R, T within SIG_RTOL of their largest magnitudes at w
    > 0, the same iteration count for each frequency; w = 0 is printed:
    (w + i eta)^2 = -eta^2 is real there and the strip's layer block is
    indefinite, so that point is ill-conditioned in the reference
    itself), timed after one warm-up; then ``RunEnsemble`` of the 8-atom
    chain of tests/test_crosscheck.py's UseK tier with two lead-block
    phonon baths (``phbath(K00=, K01=, V01=)``: semi-infinite chain
    leads, mode "K"), float32, the blocked path, and the same draws at
    swapped lead temperatures: heat flows hot to cold."""
    from sclmd_tpu_torch import baths as B
    from sclmd_tpu_torch.kernels import block_corr as K2
    from sclmd_tpu_torch.kernels import gle_block as K1
    from sclmd_tpu_torch.md import md
    from sclmd_tpu_torch.models.harmonic import chain_dynmat

    card, cpu = _sig_pair(dev)
    _sig_sweeps(card)                                # warm-up
    got, card_s = _sig_sweeps(card)
    want, cpu_s = _sig_sweeps(cpu)
    errs = {}
    for name, g, w in zip(("sigma_L", "sigma_R", "tm"), got, want):
        errs[name] = float(np.abs(g[1:] - w[1:]).max() / np.abs(w[1:]).max())
        errs[name + "_w0"] = float(np.abs(g[0] - w[0]).max()
                                   / max(np.abs(w[0]).max(), 1e-300))
    niter = {d: (card.niter[d], cpu.niter[d]) for d in ("L", "R")}
    same_niter = all(np.array_equal(a[1:], b[1:]) for a, b in niter.values())
    out = {"phase": 21, "points": len(card.ep), "n_layer": len(card.K00),
           "decimation_and_tm_s": card_s, "cpu_s": cpu_s,
           "max_niter": int(max(a.max() for a, _ in niter.values())),
           "niter_w0": {d: [int(a[0]), int(b[0])] for d, (a, b)
                        in niter.items()},
           "same_niter_w_gt_0": same_niter, "rel_err": errs,
           "rtol": SIG_RTOL}

    k, nph, dt, T, delta, nmd, ml = 0.04, 8, 0.25 / 0.658, 300.0, 0.5, \
        2 ** 11, 128
    K00, K01, V01 = np.array([[2 * k]]), np.array([[-k]]), np.array([[-k]])
    hot, cold = T * (1 + delta / 2), T * (1 - delta / 2)

    def runner(temps):
        r = md(dt, nmd, T, dyn=chain_dynmat(nph, k).numpy(),
               dtype=torch.float32, seed=5, outdir=tempfile.mkdtemp(),
               device=dev)
        for cid, tt in zip(([0], [nph - 1]), temps):
            r.AddBath(B.phbath(tt, cid, np.sqrt(k), 400, dt, nmd, ml=ml,
                               K00=K00, K01=K01, V01=V01, mcof=2.2,
                               dtype=torch.float32, device=dev))
        return r

    fwd_r = runner((hot, cold))
    assert all(b.UseK() and b.mode == "K" for b in fwd_r.baths)
    K1.reset_count()
    K2.reset_count()
    reset_k3()
    t0 = time.perf_counter()
    fwd = fwd_r.RunEnsemble(ntraj, nsteps=nmd, block=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gle_near": K1.launches_near, "gle_far": K1.launches_far,
                "block_corr_freq": K2.launches, **k3_counts()}
    rev = runner((cold, hot)).RunEnsemble(ntraj, nsteps=nmd, block=64)
    j = (fwd - rev) / 2                       # common random numbers
    out["run"] = {"ntraj": ntraj, "nsteps": nmd, "s": wall,
                  "launches": launches,
                  "J_left": float(j[:, 0].mean()),
                  "J_right": float(j[:, 1].mean()),
                  "J_sem": (j.std(axis=0) / np.sqrt(ntraj)).tolist()}
    print(json.dumps(out), flush=True)
    assert max(v for kk, v in errs.items() if not kk.endswith("_w0")) \
        <= SIG_RTOL, errs
    assert same_niter, niter
    assert all(np.isfinite(x).all() for x in got), "non-finite sweep"
    assert min(launches.values()) > 0, launches
    assert np.isfinite(fwd).all() and np.isfinite(rev).all()
    assert out["run"]["J_left"] > 0 > out["run"]["J_right"], out["run"]


# --- the Lambda pipeline, HSSigma and the current-induced-force run --------
def _dict_err(got, want):
    """{key: max |got-want| / max |want|} over the keys of ``want``."""
    out = {}
    for k, w in want.items():
        g = got[k]
        g = g if torch.is_tensor(g) else torch.as_tensor(np.asarray(g))
        w = w if torch.is_tensor(w) else torch.as_tensor(np.asarray(w))
        out[k] = rel_err(g, w)[0]
    return out


def kaverage_model(n, nk, ne, seed=22):
    """k-resolved inputs of ``kaverage_extract``: rundp's model Hamiltonian
    (``n`` orbitals) with a k-dependent hopping, its leads on
    ``fft_order_grid(4.0, ne)`` scaled per k, uniform k weights."""
    from sclmd_tpu_torch.examples.current_induced.rundp import model
    H, S, E, SigL, SigR, _, _ = model(n_el=n, nm=1, ne=ne)
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, n)) * 0.1
    ks = np.linspace(0.0, np.pi, nk, endpoint=False)
    Hk = np.stack([H + np.cos(k) * (t + t.T) / 2
                   + 1j * np.sin(k) * (t - t.T) / 2 for k in ks])
    Sk = np.broadcast_to(S, (nk, n, n)).copy()
    fk = (1.0 + 0.1 * np.cos(ks))[None, :, None, None]
    return (Hk, Sk, SigL[:, None] * fk, SigR[:, None] * fk[..., ::-1, :, :],
            E, np.full(nk, 1.0 / nk))


def phase_lambda(dev, smi):
    """Phase 22: (a) the Lambda pipeline and ``kaverage_extract`` on the
    card against the CPU, both complex128, at rundp's model with 24
    orbitals, 12 modes, 512 energies (kaverage at 4 k points): every
    output within LAMBDA_RTOL of its largest value; (b) at full size (96
    orbitals, 60 modes, 2048 energies, hwcut 0.05, muL/muR +-0.25,
    mode_chunk 8) ``LambdaPipeline.write`` timed by section against its
    FP64 bound, its peak memory and the invariants (eta symmetric, xim and
    zeta2 antisymmetric, LamEqu real-symmetric, zero outside the hwcut
    mask); then ``kaverage_extract`` at 8 k points, 96 orbitals, 512
    energies, timed against its bound."""
    from sclmd_tpu_torch.examples.current_induced.rundp import model
    from sclmd_tpu_torch.postprocess import hssigma as HS
    from sclmd_tpu_torch.postprocess import lambda_pipeline as LP
    from sclmd_tpu_torch.utils.profiling import Tracer

    hwcut, muL, muR = 0.05, 0.25, -0.25
    small = LAMBDA_SMALL
    # (a) card against the CPU
    args = model(n_el=small[0], nm=small[1], ne=small[2])
    pls = [LP.LambdaPipeline(*args, device=d) for d in (dev, "cpu")]
    errs = {"spectral": _dict_err(pls[0].sp, pls[1].sp)}
    outs = [(p.wideband(hwcut), p.full_lambda(hwcut, muL, muR))
            for p in pls]
    errs["wideband"] = _dict_err(outs[0][0], outs[1][0])
    errs["full_lambda"] = _dict_err(outs[0][1], outs[1][1])
    kargs = kaverage_model(small[0], small[3], small[2])
    kav = [HS.kaverage_extract(*kargs, eta=1e-3, device=d)
           for d in (dev, "cpu")]
    errs["kaverage"] = _dict_err(kav[0], kav[1])
    worst = max(v for e in errs.values() for v in e.values())
    print(json.dumps({"phase": 22, "case": "card_vs_cpu", "n_el": small[0],
                      "nm": small[1], "ne": small[2], "nk": small[3],
                      "rel_err": errs,
                      "rtol": LAMBDA_RTOL, "card": smi}), flush=True)
    assert worst <= LAMBDA_RTOL, errs

    # (b) full size
    n_el, nm, ne, chunk = LAMBDA_FULL
    tr = Tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pl = LP.LambdaPipeline(*model(n_el=n_el, nm=nm, ne=ne), device=dev,
                           mode_chunk=chunk, tracer=tr)
    path = os.path.join(tempfile.mkdtemp(), "Lambda.npz")
    with tr.section("write", sync=torch.cuda.synchronize):
        full, wb = pl.write(path, hwcut, muL, muR)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    os.remove(path)
    secs = {k: v[1] for k, v in tr.stats.items()}
    flops = pl.flops()
    ops = flops["spectral_functions"] \
        + flops["correlations"] * flops["correlation"]
    bound_s = ops / PEAK_FP64_TC
    mask = LP._pair_mask(pl.hw, hwcut)

    def off_mask(x):
        x = np.asarray(x)
        return float(np.abs(x[..., ~mask]).max()) if (~mask).any() else 0.0

    def asym(x, sign):
        x = np.asarray(x)
        return float(np.abs(x - sign * np.swapaxes(x, -1, -2)).max()
                     / max(np.abs(x).max(), 1e-300))

    inv = {"eta_sym": asym(wb["eta"], 1), "xim_antisym": asym(wb["xim"], -1),
           "zeta2_antisym": asym(wb["zeta2"], -1),
           "lamequ_sym": asym(full["LamEqu"], 1),
           "lamequ_real": bool(np.isrealobj(full["LamEqu"])),
           "off_mask": max(off_mask(v) for k, v in
                           list(wb.items()) + list(full.items())
                           if k not in ("wl", "TR"))}
    out = {"phase": 22, "case": "full", "n_el": n_el, "nm": nm, "ne": ne,
           "mode_chunk": chunk, "s": wall, "sections_s": secs,
           "flops": ops, "flops_correlation": flops["correlation"],
           "bound_s": bound_s, "share_of_bound": bound_s / wall,
           "max_memory_allocated": peak, "invariants": inv,
           "masked_pairs": int((~mask).sum()), "card": smi}
    print(json.dumps(out), flush=True)
    assert inv["eta_sym"] <= 1e-12 and inv["xim_antisym"] <= 1e-12
    assert inv["zeta2_antisym"] == 0.0 and inv["lamequ_sym"] <= 1e-12
    assert inv["lamequ_real"] and inv["off_mask"] == 0.0, inv
    assert all(np.isfinite(np.asarray(v)).all() for v in full.values())

    # kaverage_extract at full size, after a warm-up
    nk, n, nek = KAVERAGE_FULL
    kargs = kaverage_model(n, nk, nek)
    HS.kaverage_extract(*kargs, eta=1e-3, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = HS.kaverage_extract(*kargs, eta=1e-3, device=dev)
    torch.cuda.synchronize()
    kwall = time.perf_counter() - t0
    kbound = HS.kaverage_flops(nek, nk, n) / PEAK_FP64_TC
    print(json.dumps({"phase": 22, "case": "kaverage", "nk": nk, "n": n,
                      "ne": nek, "s": kwall, "bound_s": kbound,
                      "share_of_bound": kbound / kwall, "card": smi}),
          flush=True)
    assert all(np.isfinite(v).all() for v in res.values())
    return {"write_s": secs["write"], "spectral_s":
            secs["spectral_functions"], "kaverage_s": kwall}


def phase_current_induced(dev, smi, ntraj=256, nwin=48):
    """Phase 23: the harmonic flagship with a third, biased electron bath
    on its 183 centre DOFs (``tools.flagship.biased_flagship_runner``):
    the matrices from ``LambdaPipeline.wideband`` on the card (rundp's
    model at 96 orbitals and the 183 DOFs as modes), written with
    ``WritewbLambda`` and read back; ``RunEnsemble(ntraj)`` with K7 on its
    bias-coefficient route and K3 on both routes, launches counted;
    ``calHF``/``calTC`` on its 3 x ntraj kappa files against the run's
    own mean currents to the files' printed precision; a window of
    ``nwin`` steps of 2 trajectories on the card against float64 on the
    CPU; K3's per-frequency route on this bath's factors against its
    twins, timed."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.md import thermal_init
    from sclmd_tpu_torch.parallel.ensemble import bath_factors, fused_chunk
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.utils.io import ReadwbLambda
    from sclmd_tpu_torch.utils.tools import calHF, calTC

    _, part, dyn = F.flagship_junction()
    centre = F.centre_dofs(part)
    assert len(centre) == len(dyn) - len(part["fixdofs"]) - len(
        part["ecatsl"]) - len(part["ecatsr"]) == 183, len(centre)
    wdir = tempfile.mkdtemp()
    wbf = os.path.join(wdir, "wbLambda.npz")
    t0 = time.perf_counter()
    m = F.write_centre_bath(wbf, dev, len(centre))
    wb_s = time.perf_counter() - t0
    back = ReadwbLambda(wbf)
    assert all(np.array_equal(a, m[k]) for a, k in zip(
        back[1:], ("eta", "xim", "xip", "zeta1", "zeta2")))

    r = F.biased_flagship_runner(torch.float32, dev, tempfile.mkdtemp(), wbf)
    system = r._build_system()
    bb = r.baths[2]
    assert bb.bias_terms and bb.nevecs.ndim == 3, "not the batch route"
    r.RunEnsemble(ntraj, nsteps=F.NMD, block=None)      # warm-up
    torch.cuda.synchronize()
    r.outdir = tempfile.mkdtemp()
    K7.reset_count()
    reset_k3()
    with GeneratorCount() as gens:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means = r.RunEnsemble(ntraj, nsteps=F.NMD, block=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert gens.n == 0, gens.n
    launches = {"bath_force": K7.launches, **k3_counts(),
                "noise_synth_batch": K3.launches_batch}
    ke = r.energy(r.state)
    chunks = F.chunk_sizes(system, ntraj)
    nch = len(chunks)
    assert launches == {"bath_force": 3 * F.NMD * nch,
                        "noise_synth": 3 * nch, "init_draw": nch,
                        "noise_transpose": 3 * nch,
                        "noise_synth_batch": nch}, launches
    assert means.shape == (ntraj, 3) and np.isfinite(means).all()
    assert np.isfinite(ke) and 0.0 < ke < KE_BOUND, ke

    # the kappa files read back: calHF's last running mean and calTC's
    # means against the in-memory currents (nW), each file value printed
    # with %f (within 5e-7)
    files = [f for f in os.listdir(r.outdir) if f.startswith("kappa.")]
    hf = calHF(bathnum=3, workdir=r.outdir)
    tc = calTC(0.1, bathnum=3, workdir=r.outdir)
    j = means[1:] * units.CURCOF
    hf_err = float(np.abs(hf[:, -1] - j.mean(axis=0)).max())
    kap = (j[:, 0] + j[:, 1] - j[:, 2]) / 4 / (0.1 * r.T)
    flux = -(j[:, 0] + j[:, 1] - j[:, 2]) / 4
    tc_err = {"conductance": abs(tc["conductance"][0] - kap.mean()),
              "flux": abs(tc["flux"][0] - flux.mean())}
    tol = {"heatflux": 5e-7, "conductance": 3 * 5e-7 / 4 / (0.1 * r.T),
           "flux": 3 * 5e-7 / 4}

    # card against the CPU: a window of the same system, the same draws
    rng = np.random.default_rng(23)
    f0 = F.biased_flagship_runner(torch.float64, "cpu", tempfile.mkdtemp(),
                                  wbf)
    rs = [rng.standard_normal((2,) + np.shape(b.nstd)) for b in f0.baths]
    us = rng.uniform(size=(2, f0.nph))
    win = []
    for dtype, device, fr in ((torch.float32, dev, r),
                              (torch.float64, "cpu", f0)):
        sysw = fr._build_system()
        fin, sums, ok = fused_chunk(
            sysw, bath_factors(fr.baths, device),
            [torch.as_tensor(x, dtype=dtype, device=device) for x in rs],
            nwin, 0, None, nwin // 4, states=thermal_init(
                torch.as_tensor(us, dtype=dtype, device=device), sysw,
                fr.hw, fr.U, F.T))
        assert bool(ok)
        win.append((fin.p, fin.q, sums))
    win_err = dict(zip(("p", "q", "cur_sum"),
                       (rel_err(a, b)[0] for a, b in zip(*win))))

    # K3's per-frequency route on this bath's factors (nf 513, nc 183)
    fac = bath_factors(r.baths, dev)[2]
    k3_abs = {}
    for n in sorted(set(chunks)):
        k3_abs[n] = check_k3_case(23, f"biased_centre_{n}", fac, r.dt,
                                  r.nmd, n, 3)
    k3_t = k3_times(fac, r.dt, r.nmd, chunks[0])
    out = {"phase": 23, "centre_dofs": len(centre), "bias": F.BIAS,
           "wideband_s": wb_s, "scale": m["scale"],
           "eta_raw_max": m["eta_raw_max"],
           "eta_eig": np.linalg.eigvalsh(m["eta"])[[0, -1]].tolist(),
           "ntraj": ntraj, "nsteps": F.NMD, "chunks": chunks, "s": wall,
           "traj_steps_per_s": ntraj * F.NMD / wall, "launches": launches,
           "kinetic_energy_end": ke, "ke_bound": KE_BOUND,
           "J_mean": means.mean(axis=0).tolist(), "kappa_files": len(files),
           "calHF_err": hf_err, "calTC_err": tc_err, "tol": tol,
           "window": {"nsteps": nwin, "ntraj": 2, "rel_err": win_err,
                      "rtol": RTOL},
           "k3_batch": {"ms": k3_t["kernel"], "device_ms": k3_t["device"],
                        "plain_ms": k3_t["plain"], "bound_ms": k3_t["bound"],
                        "series_ms": k3_t["series"],
                        "library_composition_ms":
                            k3_t["library_composition"],
                        "abs_err": {str(k): v[0] for k, v in k3_abs.items()}},
           "card": smi}
    print(json.dumps(out), flush=True)
    assert len(files) == 3 * ntraj, len(files)
    assert hf_err <= tol["heatflux"], hf_err
    assert all(tc_err[k] <= tol[k] for k in tc_err), tc_err
    assert max(win_err.values()) <= RTOL, win_err
    return {"launches": launches,
            "k3_abs": max(v[0] for v in k3_abs.values()),
            "transpose_abs": max(v[1] for v in k3_abs.values())}


if __name__ == "__main__":
    sys.exit(main())
