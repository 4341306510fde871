r"""The port's gates on the card: whole runner calls at the workloads'
full sizes (``sclmd_tpu_torch.tools``), the physics they must show and
the kernel launches they must make.

- the MD-vs-NEGF thermal conductance of the harmonic flagship within 2 %
  of the committed NEGF answer, resolved to 1 %;
- heat flowing from the hot lead to the cold one: the same draws at
  swapped lead temperatures (half the difference keeps the current the
  temperature difference drives and cancels the fluctuations the two
  runs share);
- the launches of each kernel around whole ``RunEnsemble``/``Run``
  calls, read from the calls' reports (``utils.profiling``), and no
  ``torch.Generator`` on the main path (its draws are K3's and K3b's);
- the colored noise's variance and lag-1 covariance against the values
  its factors give;
- full-size windows of the card's float32 steps against float64 on the
  CPU, the same injected draws;
- each kernel against its twins at the shapes the main path gives it:
  K1 and K2 at the primary junction's chunks, K3 and K3b at every
  workload's noise and thermal starts, K6 and K7 at the plain step's
  and the slabs' shapes, K5 at the many-body flagship's chunks, K8 on
  the sheet, K9 and K10 on the slabs;
- the slabs' segmented, checkpointed ensembles, resumed and refused;
- the flagship's NEGF against the committed sweep, ``sig`` against the
  CPU, the Lambda pipeline's invariants at full size, and ``calHF``/
  ``calTC`` on a biased ensemble's kappa files.

Every test here needs a CUDA device and skips without one. The file
imports no JAX; run it with the kernels' own tests:

    python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py tests/test_torch_card_gates.py
"""

import collections
import contextlib
import functools

import numpy as np
import pytest
import torch

from sclmd_tpu_torch.tools import chunk_sizes
from sclmd_tpu_torch.tools import flagship as F
from sclmd_tpu_torch.tools import primary as PJ
from sclmd_tpu_torch.tools import sheet as S
from sclmd_tpu_torch.tools import slab as SL
from sclmd_tpu_torch.utils import profiling as P
from test_torch_physics import (assert_kappa_files_read_back, batch_factors,
                                lead_block_chain, noise_z_scores,
                                proportional_factors)

pytestmark = pytest.mark.cuda

# float32 on the card against float64 on the CPU, relative to the largest
# magnitude of each compared quantity
RTOL = 1e-4
# a trajectory's kinetic energy at the end of a run: 483 free DOFs at
# 300 K hold ~20 eV, zero-point motion included; a force that is a little
# wrong heats the junction by orders of magnitude
KE_BOUND = 100.0
PRIMARY_SIZES = (256, 1024)     # RunEnsemble trajectories, primary junction
FLAG_SIZES = (128, 1024)        # and on the flagship's plain step
SHEET_NTRAJ = 128
NSTAT = 1024                    # trajectories of the noise statistics
K3_SEED = 2026
GATE_NTRAJ, GATE_NMD, GATE_SEED = 256, 2 ** 14, 11
GATE_DEV_PCT, GATE_SEM_PCT = 2.0, 1.0
SLAB_NTRAJ, SLAB_NSTEPS, SLAB_NPIE = 64, 1024, 2
LEAD_NTRAJ = 512
BIASED_NTRAJ = 256
# (orbitals, modes, energies, mode chunk) of the Lambda pipeline's write;
# (orbitals, modes, energies, k points) of the card against the CPU, and
# (k points, orbitals, energies) of kaverage_extract at full size
LAMBDA_FULL = (96, 60, 2048, 8)
LAMBDA_SMALL = (24, 12, 512, 4)
KAVERAGE_FULL = (8, 96, 512)
# the Lambda pipeline and kaverage_extract, card against CPU, both
# complex128, each output relative to its largest value
LAMBDA_RTOL = 1e-9
# the flagship's NEGF on the card against the committed sweep that the
# JAX package made on the CPU in float64: T(w) within 1e-9 of max T, j_nat
# and kappa within 1e-9 relative (the same Caroli solve with the DOFs in
# another order moves T by 4e-12 of max T); one chunk of all points
# against chunks of 32 within 1e-12
NEGF_RTOL, NEGF_BATCH_RTOL = 1e-9, 1e-12
SIG_RTOL = 1e-10                # the decimation, card against CPU
# K3's scaled draw against its float64 twin: float32 logf/sincospif
# against float64 libm, a few float32 roundings of values up to ~5.8
DRAW_RTOL = 1e-6
# K5 against its float32 twin on the card (the float64 twin on the CPU is
# the yardstick, at RTOL): the twin rounds each 50-angstrom coordinate to
# 4e-6 angstrom before it takes a bond's difference, which the kernel
# does not (it adds displacements to reference difference vectors)
K5_TWIN32_RTOL = 1e-3
SLAB_CHECK_NTRAJ = 4    # a slab's trajectories against its float64 twin


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = (torch.as_tensor(x) for x in (a, b))
    a, b = (torch.view_as_real(x) if x.is_complex() else x for x in (a, b))
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def launches(ncalls: int = 1) -> dict:
    """Each kernel's launches over the last ``ncalls`` runner calls (0 for
    a kernel whose module is not loaded)."""
    out = collections.defaultdict(int)
    for rep in P.reports()[-ncalls:]:
        for name, n in rep.counters.items():
            if name.startswith("launches."):
                out[name[len("launches."):]] += n
    return out


def _pick(got: dict, want: dict) -> dict:
    return {k: got[k] for k in want}


@contextlib.contextmanager
def no_generator():
    """Fails where a ``torch.Generator`` is made inside the block."""
    made, real = [], torch.Generator

    def make(*a, **k):
        made.append(a)
        return real(*a, **k)

    torch.Generator = make
    try:
        yield
    finally:
        torch.Generator = real
    assert not made, f"{len(made)} torch.Generator made on the main path"


def _hot_cold(mod):
    return mod.T * (1 + mod.DELTA / 2), mod.T * (1 - mod.DELTA / 2)


def _assert_hot_to_cold(fwd, rev, record_property):
    """Half the difference of the same draws at swapped temperatures: the
    left (hot in ``fwd``) lead gives heat, the right takes it."""
    assert np.isfinite(fwd).all() and np.isfinite(rev).all()
    j = (fwd - rev) / 2
    jl, jr = float(j[:, 0].mean()), float(j[:, 1].mean())
    record_property("J", [jl, jr])
    record_property("J_sem", (j.std(axis=0) / np.sqrt(len(j))).tolist())
    assert jl > 0 > jr, (jl, jr)


def _kinetic_energy_bounded(r):
    ke = r.energy(r.state)
    assert np.isfinite(ke) and 0.0 < ke < KE_BOUND, ke


# --- the primary junction: blocked RunEnsemble, md.Run --------------------
def test_primary_ensemble(cuda, tmp_path):
    """RunEnsemble(256) and (1024) on the blocked path after a warm-up of
    each: K1 and K2 launched, K3 once per bath and chunk, K3b once per
    chunk, no torch.Generator, a kappa file per bath and trajectory."""
    r = PJ.primary_runner(torch.float32, cuda, str(tmp_path))
    kw = dict(nsteps=PJ.NMD, block=PJ.BLOCK)
    for n in PRIMARY_SIZES:
        r.RunEnsemble(n, **kw)
    with no_generator():
        means = [r.RunEnsemble(n, **kw) for n in PRIMARY_SIZES]
    got = launches(len(PRIMARY_SIZES))
    system = r._build_system()
    nch = sum(len(chunk_sizes(system, n, PJ.NMD, PJ.BLOCK))
              for n in PRIMARY_SIZES)
    for n, m in zip(PRIMARY_SIZES, means):
        assert m.shape == (n, 2) and np.isfinite(m).all()
    assert min(got["K1_near"], got["K1_far"], got["K2"]) > 0, got
    want = {"K3": 2 * nch, "K3b": nch, "K3_transpose": 2 * nch}
    assert _pick(got, want) == want
    assert len(list(tmp_path.glob("kappa.*"))) == 2 * max(PRIMARY_SIZES)


def test_primary_run(cuda, tmp_path):
    """md.Run on the primary junction's plain step (runs 0 and 1, two
    segments each, power spectra) after a warm-up run: K6 once a step, K7
    three times, two baths' noise a run, one thermal start; its files
    and finite checkpoints."""

    def runner(outdir, nstop):
        r = PJ.primary_runner(torch.float32, cuda, str(outdir))
        r.block, r.nstart, r.nstop, r.npie = None, 0, nstop, 2
        r.CalPowerSpec()
        return r

    (tmp_path / "warm").mkdir()
    runner(tmp_path / "warm", 1).Run()
    r = runner(tmp_path, 2)
    with no_generator():
        r.Run()
    nsteps = 2 * PJ.NMD
    want = {"K6": nsteps, "K7": 3 * nsteps, "K3": 4, "K3b": 1,
            "K3_transpose": 4}
    assert _pick(launches(), want) == want
    for j in (0, 1):
        for name in [f"MD{j}.npz", f"power.300.run{j}.dat"] + [
                f"kappa.300.bath{i}.run{j}.dat" for i in (0, 1)]:
            assert (tmp_path / name).is_file(), name
        ck = np.load(tmp_path / f"MD{j}.npz")
        assert int(ck["t"][0]) == (j + 1) * PJ.NMD
        for k in ("p", "q", "phis", "etot", "cur", "ps", "power"):
            assert np.isfinite(ck[k]).all(), (j, k)
        assert ck["ps"].shape == (PJ.NMD, PJ.NPH)
        assert ck["cur"].shape == (PJ.NMD, 2)


# --- the flagship's plain step and the periodic sheet ---------------------
@pytest.mark.parametrize("many_body", [False, True])
def test_flagship_ensemble(cuda, tmp_path, record_property, many_body):
    """RunEnsemble(128) and (1024) on the harmonic or the many-body
    flagship (``CHDriver`` through ``AddPotential``) after a warm-up of
    each: K7 three times a step, K5 twice (many-body), K3 once per bath
    and chunk, K3b once per chunk, no torch.Generator, a bounded kinetic
    energy; the same calls at swapped lead temperatures: heat flows hot
    to cold."""
    hot, cold = _hot_cold(F)
    kw = dict(nsteps=F.NMD, block=None)
    means = []
    for temps in ((hot, cold), (cold, hot)):
        d = tmp_path / str(len(means))
        d.mkdir()
        r = F.flagship_runner(torch.float32, cuda, str(d), temps=temps,
                              many_body=many_body)
        for n in FLAG_SIZES:
            r.RunEnsemble(n, **kw)
        with no_generator():
            for n in FLAG_SIZES:
                m = r.RunEnsemble(n, **kw)
                assert m.shape == (n, 2) and np.isfinite(m).all()
                _kinetic_energy_bounded(r)
        means.append(m)
        if len(means) == 1:
            got = launches(len(FLAG_SIZES))
    system = r._build_system()
    nch = sum(len(chunk_sizes(system, n, F.NMD)) for n in FLAG_SIZES)
    want = {"K5": 2 * F.NMD * nch if many_body else 0,
            "K7": 3 * F.NMD * nch, "K3": 2 * nch, "K3b": nch,
            "K3_transpose": 2 * nch}
    assert _pick(got, want) == want
    _assert_hot_to_cold(*means, record_property)


def test_sheet_ensemble(cuda, tmp_path):
    """RunEnsemble(128) on the periodic graphene sheet after a warm-up:
    K8 (the Tersoff-only entry of K5) twice a step and no K5, K3 once per
    bath and chunk, no K3b (the sheet starts at rest), no
    torch.Generator, a bounded kinetic energy."""
    r = S.sheet_runner(torch.float32, cuda, str(tmp_path))
    assert r.pforce.kernel.cuda.pack["kind"] == "tersoff"
    r.RunEnsemble(SHEET_NTRAJ, nsteps=S.NMD)
    with no_generator():
        means = r.RunEnsemble(SHEET_NTRAJ, nsteps=S.NMD)
    nch = len(chunk_sizes(r._build_system(), SHEET_NTRAJ, S.NMD))
    want = {"K8": 2 * S.NMD * nch, "K5": 0, "K3": 2 * nch, "K3b": 0,
            "K3_transpose": 2 * nch}
    assert _pick(launches(), want) == want
    assert means.shape == (SHEET_NTRAJ, 2) and np.isfinite(means).all()
    _kinetic_energy_bounded(r)


# --- windows: float32 on the card against float64 on the CPU --------------
def _tens(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def _fused_pair(cuda, tmp_path, make, rng, ntraj, nsteps, block, thermal):
    """``fused_chunk`` on the system of ``make(dtype, device, outdir)``,
    on the card in float32 and on the CPU in float64: the same draws from
    ``rng`` and, with ``thermal``, the same start's uniforms (else at
    rest). Returns (p, q, current sums) of each."""
    from sclmd_tpu_torch.md import thermal_init
    from sclmd_tpu_torch.parallel.ensemble import bath_factors, fused_chunk
    out, rs, us = [], None, None
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        r = make(dtype, device, str(tmp_path))
        if rs is None:
            rs = [rng.standard_normal((ntraj,) + np.shape(b.nstd))
                  for b in r.baths]
            us = rng.uniform(size=(ntraj, r.nph)) if thermal else None
        system = r._build_system()
        fin, sums, ok = fused_chunk(
            system, bath_factors(r.baths, device),
            [_tens(x, dtype, device) for x in rs], nsteps, 0, block,
            nsteps // 4, states=None if us is None else thermal_init(
                _tens(us, dtype, device), system, r.hw, r.U, r.T))
        assert bool(ok)
        out.append((fin.p, fin.q, sums))
    return out


def _window_plain(cuda, tmp_path):
    """512 plain steps of md.Run's path (one primary trajectory), then of
    a 4-trajectory chunk of the harmonic flagship."""
    from sclmd_tpu_torch.md import run_segment, thermal_init
    from sclmd_tpu_torch.ops.noise import sample_noise_from_r
    from sclmd_tpu_torch.parallel.ensemble import bath_factors
    rng = np.random.default_rng(12)
    out, rs = [], None
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        r = PJ.primary_runner(dtype, device, str(tmp_path))
        if rs is None:
            rs = [rng.standard_normal((1,) + np.shape(b.nstd))
                  for b in r.baths]
            u = rng.uniform(size=(1, PJ.NPH))
        facs = bath_factors(r.baths, device)
        system = r._build_system().replace(baths=tuple(
            b.replace(noise=sample_noise_from_r(
                _tens(x, dtype, device), ev, sd, PJ.DT, PJ.NMD))
            for b, (ev, sd), x in zip(r.baths, facs, rs)))
        fin, ys = run_segment(system, thermal_init(
            _tens(u, dtype, device), system, r.hw, r.U, PJ.T), 512, t0=0)
        out.append((fin.p, fin.q, ys["cur"], ys["etot"]))
    flag = _fused_pair(cuda, tmp_path, F.flagship_runner, rng, 4, 512, None,
                       True)
    return [a + b for a, b in zip(out, flag)]


def _window_biased(cuda, tmp_path):
    """48 plain steps of two trajectories of the flagship under the biased
    centre bath (its wbLambda file at the default 2,048 energies)."""
    wbf = str(tmp_path / "wbLambda.npz")
    F.write_centre_bath(wbf, cuda, 183)
    return _fused_pair(
        cuda, tmp_path,
        lambda dtype, device, d: F.biased_flagship_runner(dtype, device, d,
                                                          wbf),
        np.random.default_rng(23), 2, 48, None, True)


WINDOWS = {   # name: the card's and the CPU's outputs
    "blocked": lambda c, t: _fused_pair(         # 4 primary trajectories
        c, t, PJ.primary_runner, np.random.default_rng(11), 4, 512,
        PJ.BLOCK, True),
    "plain": _window_plain,
    "many_body": lambda c, t: _fused_pair(       # K5 and K7
        c, t, functools.partial(F.flagship_runner, many_body=True),
        np.random.default_rng(14), 4, 48, None, True),
    "sheet": lambda c, t: _fused_pair(           # K8, from rest
        c, t, S.sheet_runner, np.random.default_rng(15), 4, 48, None,
        False),
    "biased": _window_biased,                     # K7's wind/Berry route
}


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_card_against_cpu(cuda, tmp_path, name):
    """Full-size windows on the card (float32, the kernels) against the
    CPU (float64, the twins) on the same injected draws: every state and
    current within RTOL of its largest magnitude."""
    card, cpu = WINDOWS[name](cuda, tmp_path)
    for i, (a, b) in enumerate(zip(card, cpu)):
        assert _rel(a, b) <= RTOL, (name, i)


# --- the kernels against their twins at the main path's shapes ------------
def _chunks(r, sizes, nsteps, block=None) -> list:
    """The chunk sizes of ``RunEnsemble(n, nsteps, block=block)`` on
    runner ``r`` for each n of ``sizes``."""
    system = r._build_system()
    return sorted({c for n in sizes
                   for c in chunk_sizes(system, n, nsteps, block)})


def _k1_pair(args, sub, tt, gen):
    """K1's near kernel over the second sub-block of a block and its far
    kernel over the update after it, each against its twin on the same
    tensors (the earlier rows of the rings random). Returns the largest
    relative error of each."""
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
    near = [_rel(getattr(got, k), getattr(want, k))
            for k in ("p", "q", "pf", "cur", "etot")]
    near += [_rel(g, w) for g, w in zip(got.rings, want.rings)]
    for g, w in zip(got.rings, want.rings):   # the far kernel's own error
        g.copy_(w)
    K1.gle_far_cuda(baths, got.rings, got.Os, block, b0, ns)
    for b, r, O in zip(baths, want.rings, want.Os):
        K1.gle_far_plain(b.kin, r, O, block, b0, ns)
    return max(near), max(_rel(g, w) for g, w in zip(got.Os, want.Os))


@pytest.mark.parametrize("ntraj", PRIMARY_SIZES)
def test_k1_k2_at_primary_chunks(cuda, tmp_path, ntraj):
    """K2 and K1 at each chunk of RunEnsemble(ntraj) on the primary
    junction (``tools.primary.block_operands``: a thermal start, the
    colored noise, the K2 tails of a random history): K2's contraction,
    K1's near and far kernels (``_k1_pair``) and one whole block of the
    pair against their twins, every output within RTOL; at the largest
    chunks the near kernel takes more than one trajectory a CTA."""
    from sclmd_tpu_torch.kernels import block_corr as K2
    from sclmd_tpu_torch.kernels import gle_block as K1
    gen = torch.Generator(device=cuda).manual_seed(1)
    r = PJ.primary_runner(torch.float32, cuda, str(tmp_path))
    sub = K1.sub_steps(PJ.BLOCK)
    tiles = []
    for n in _chunks(r, [ntraj], PJ.NMD, PJ.BLOCK):
        _, args, corr = PJ.block_operands(r, n, 7, gen)
        khat, hhat = corr[0]
        assert _rel(K2.block_corr_freq_cuda(khat, hhat),
                    K2.block_corr_freq_plain(khat, hhat)) <= RTOL, n
        tiles.append(K1.tile_size(n, PJ.NPH, 2, PJ.NC, sub, cuda))
        near, far = _k1_pair(args, sub, tiles[-1], gen)
        assert max(near, far) <= RTOL, (n, near, far)
        out, ref = K1.gle_block_cuda(*args), K1.gle_block_plain(*args)
        for k in ("p", "q", "pf", "qprev", "cur", "etot"):
            assert _rel(getattr(out, k), getattr(ref, k)) <= RTOL, (n, k)
        for i, (a, b) in enumerate(zip(out.rings, ref.rings)):
            assert _rel(a, b) <= RTOL, (n, i)
        del out, ref
    if ntraj == max(PRIMARY_SIZES):
        assert max(tiles) > 1, tiles


def _check_k3(fac, dt, nmd, n, lo):
    """K3 on trajectories [lo, lo + n) of stream 1 against its twins: a
    bitwise repeat and the same bits at other launch shapes; the scaled
    draw within DRAW_RTOL of its float64 twin; the folded half spectrum
    within RTOL of its float64 twin, its edge rows real; the layout
    kernel bitwise the twin's transpose; the C2R series within RTOL of
    the twin's, its input left as it was, and the in-place run on K3's
    buffer the same bits."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    ev, std = fac
    h, nc = std.shape
    nsm = torch.cuda.get_device_properties(std.device).multi_processor_count
    scale = 1.0 / (nmd * dt)

    def k3(**kw):
        return K3.noise_halfspectrum_cuda(ev, std, K3_SEED, 1, lo, lo + n,
                                          scale, packed=fac.packed, **kw)

    y = k3()
    assert torch.equal(k3(), y)
    batch = ev.ndim == 3
    full = K3.launch_plan(nc, n, h, batch, nsm)
    for cw in sorted({1, max(1, full["cw"] // 2), full["cw"]}):
        p = K3.launch_plan(nc, n, h, batch, nsm, cw=cw)
        grids = [p["grid"]] if batch else \
            sorted({p["grid"], max(1, p["grid"] // 3)})
        for grid in grids:
            assert torch.equal(k3(plan=dict(p, grid=grid)), y), (cw, grid)
    assert _rel(k3(draw_only=True), K3.draw_plain(
        std.double(), K3_SEED, 1, lo, lo + n)) <= DRAW_RTOL
    want = K3.halfspectrum_plain(ev.to(torch.complex128), std.double(),
                                 K3_SEED, 1, lo, lo + n, scale)
    assert _rel(y, want) <= RTOL
    assert not (y[..., 0].imag.any() or y[..., -1].imag.any())
    xs = torch.randn((n, nc, nmd), device=std.device)
    assert torch.equal(K3.transpose(xs), K3.transpose_plain(xs))
    del xs
    y0 = y.clone()
    series = K3.c2r_series(y, nmd)
    assert torch.equal(y, y0)
    assert _rel(series, K3.c2r_plain(want, nmd)) <= RTOL
    del want, y0
    assert torch.equal(K3.c2r_series(y, nmd, consume=True), series)


def _k3_case(name, cuda, tmp_path):
    """(factors, dt, nmd, [(trajectories, first trajectory)]) of K3 at a
    workload's noise: the chunks of its RunEnsemble calls from trajectory
    3, a window inside the ensemble (the slabs': their one chunk from 0);
    on the primary junction also md.Run's window of run 1."""
    from sclmd_tpu_torch.parallel.ensemble import bath_factors
    d = str(tmp_path)
    if name in ("primary", "batch"):
        r = PJ.primary_runner(torch.float32, cuda, d)
        wins = [(n, 3) for n in _chunks(r, PRIMARY_SIZES, PJ.NMD, PJ.BLOCK)]
        if name == "batch":         # a matrix-valued friction profile's
            return batch_factors(PJ.NC, PJ.NMD, cuda), PJ.DT, PJ.NMD, wins
        return bath_factors(r.baths, cuda)[0], r.dt, r.nmd, wins + [(1, 1)]
    if name == "narrow":            # nc 37, padded to 40
        return proportional_factors(37, 1024, cuda), 0.5, 1024, [(100, 3)]
    bath = 0
    if name == "flagship":
        r = F.flagship_runner(torch.float32, cuda, d)
        wins = [(n, 3) for n in _chunks(r, FLAG_SIZES, F.NMD)]
    elif name == "sheet":
        r = S.sheet_runner(torch.float32, cuda, d)
        wins = [(n, 3) for n in _chunks(r, [SHEET_NTRAJ], S.NMD)]
    elif name == "biased_centre":   # nc 183 on the per-frequency route
        wbf = str(tmp_path / "wbLambda.npz")
        F.write_centre_bath(wbf, cuda, 183)
        r = F.biased_flagship_runner(torch.float32, cuda, d, wbf)
        wins, bath = [(n, 3) for n in _chunks(r, [BIASED_NTRAJ], F.NMD)], 2
    else:                           # nc 864 (U from global memory), 432
        r = SL.slab_runner(name, torch.float32, cuda, d)
        wins = [(SLAB_NTRAJ, 0)]
    return bath_factors(r.baths, cuda)[bath], r.dt, r.nmd, wins


@pytest.mark.parametrize("name", ["primary", "batch", "narrow", "flagship",
                                  "sheet", "biased_centre", "sw", "eam"])
def test_k3_at_main_path_shapes(cuda, tmp_path, name):
    """K3 against its twins (``_check_k3``) at each workload's factors
    and windows (``_k3_case``): the primary junction (one (90, 90)
    matrix, nmd 2048), a per-frequency batch of its widths, a narrow
    proportional spectrum, the flagship (150, nmd 1024), the sheet (48),
    the biased flagship's centre bath (per frequency, 183) and the slabs
    (864 and 432, at 64 trajectories)."""
    fac, dt, nmd, wins = _k3_case(name, cuda, tmp_path)
    for n, lo in wins:
        _check_k3(fac, dt, nmd, n, lo)


@pytest.mark.parametrize("name", ["primary", "flagship"])
def test_k3b_at_main_path_shapes(cuda, tmp_path, name):
    """K3b at the thermal starts of RunEnsemble's chunks (from trajectory
    3) and, on the primary junction, of md.Run's run 0: the uniforms
    bitwise the twin's, the amplitudes within DRAW_RTOL of the float64
    twin's, the start within RTOL of ``thermal_init`` on the twin's
    uniforms."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.md import thermal_init
    from sclmd_tpu_torch.ops import philox
    if name == "primary":
        r = PJ.primary_runner(torch.float32, cuda, str(tmp_path))
        wins = [(n, 3) for n in _chunks(r, PRIMARY_SIZES, PJ.NMD, PJ.BLOCK)]
        wins.append((1, 0))
    else:
        r = F.flagship_runner(torch.float32, cuda, str(tmp_path))
        wins = [(n, 3) for n in _chunks(r, FLAG_SIZES, F.NMD)]
    system = r._build_system()
    st = r._thermal_start(r.T)
    nph = st.am.numel()
    for n, lo in wins:
        u = K3.init_uniforms_cuda(K3_SEED, 2, lo, lo + n, nph, cuda)
        u_twin = philox.uniforms(K3_SEED, 2, lo, lo + n, nph, cuda)
        assert torch.equal(u, u_twin), (n, lo)
        amps = K3.thermal_amplitudes(K3_SEED, 2, lo, lo + n, st.am, st.hw)
        want = K3.thermal_amplitudes_plain(K3_SEED, 2, lo, lo + n,
                                           st.am.double(), st.hw.double())
        assert _rel(amps, want) <= DRAW_RTOL, (n, lo)
        got = st.states(system, K3_SEED, 2, lo, lo + n)
        ref = thermal_init(u_twin, system, r.hw, r.U, r.T)
        assert max(_rel(got.p, ref.p), _rel(got.q, ref.q)) <= RTOL, (n, lo)


@pytest.mark.parametrize("ntraj,head", [(1, 377), (37, 5)])
def test_k6_at_primary_shapes(cuda, ntraj, head):
    """K6 on the primary junction's two baths (90 DOFs, 1000 taps each,
    nph 300) against its twin on the same history ring: md.Run's one
    trajectory and a ragged batch of 37."""
    from sclmd_tpu_torch.kernels import conv_tails as K6
    gen = torch.Generator(device=cuda).manual_seed(5)
    pb = PJ.primary_baths(torch.float32, cuda)
    ring = 0.05 * torch.randn((ntraj, pb[0].ml, PJ.NPH), device=cuda,
                              generator=gen)
    got = K6.ConvTailsCuda(ring, pb)((-head) % ring.shape[1])
    want = K6.conv_tails_plain(ring, head, pb)
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def _check_k7(baths, ntraj, nph, nmd, dt, dev, seed):
    """K7's three stages (predictor, corrector, last corrector) at step 0
    of a segment from global step 3 (ring head 0, push row mlr - 1,
    noise rows 3 and 4) on random operands of these shapes, by the
    kernel and by the twins on the same tensors: every output within
    RTOL. Returns the kernel's ``BathForce``."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, device=dev, generator=gen)

    baths = [b.replace(noise=rnd(ntraj, nmd, b.nc, scale=0.01))
             for b in baths]
    p, q, x = (rnd(ntraj, nph, scale=0.05) for _ in range(3))
    pf, pf2 = rnd(ntraj, nph), rnd(ntraj, nph)
    mlr = max(b.ml for b in baths)
    ring = rnd(ntraj, mlr, nph, scale=0.05)
    tails = [rnd(ntraj, b.nc, 2, scale=1e-3) if b.ml > 2 else None
             for b in baths]
    mask = torch.ones(nph, device=dev)
    mask[: nph // 10] = 0.0
    force = K7.BathForce(baths, ntraj, nph, nmd, dt, dev, t0=3)
    push = (mlr - 1) % mlr
    out = []
    for kernel in (True, False):
        rg = ring.clone()
        cur = torch.zeros((ntraj, 1, len(baths)), device=dev)
        etot = torch.zeros((ntraj, 1), device=dev)
        fbs = [torch.zeros((ntraj, b.nc), device=dev) for b in baths]
        f = torch.zeros_like(p)
        if kernel:
            ph, qt = force.pred(p, q, pf, rg, 0, tails, cur, etot, fbs)
            pc, _ = force.corr(x, qt, pf2, p, ph, tails, 0)
            pl, ql = force.corr(x, qt, pf2, p, ph, tails, 0, mask=mask,
                                f_out=f)
        else:
            ops = force.ops
            ph, qt = K7.pred_plain(p, q, pf, rg, 0, push, ops, tails, 3, dt,
                                   cur[:, 0], etot[:, 0], fbs)
            pc, _ = K7.corr_plain(x, qt, pf2, p, ph, ops, tails, 4, dt)
            pl, ql = K7.corr_plain(x, qt, pf2, p, ph, ops, tails, 4, dt,
                                   mask, f)
        out.append([ph, qt, pc, pl, ql, f, cur, etot, rg[:, push]] + fbs)
    for i, (a, b) in enumerate(zip(*out)):
        assert _rel(a, b) <= RTOL, i
    return force


@pytest.mark.parametrize("name", ["primary", "flagship", "biased", "sw",
                                  "eam"])
def test_k7_at_main_path_shapes(cuda, tmp_path, name):
    """K7 against its twins (``_check_k7``) at the plain step's shapes:
    the primary junction's phonon baths (with K6's tails) at md.Run's
    one trajectory and at 37; the flagship's electron baths at each
    chunk of its RunEnsemble calls; a biased electron bath pair (wind,
    renormalisation, Berry) at 128; the slabs' wideband baths at 64
    trajectories, the silicon slab's 10,368 DOFs on the unstaged
    route."""
    from sclmd_tpu_torch import baths as B
    if name == "primary":
        pb = PJ.primary_baths(torch.float32, cuda)
        for n in (1, 37):
            _check_k7(pb, n, PJ.NPH, PJ.NMD, PJ.DT, cuda, 10)
        return
    if name in ("flagship", "biased"):
        fr = F.flagship_runner(torch.float32, cuda, str(tmp_path))
        if name == "flagship":
            for n in _chunks(fr, FLAG_SIZES, F.NMD):
                _check_k7(fr.baths, n, fr.nph, F.NMD, F.DT, cuda, n)
            return
        rng = np.random.default_rng(3)
        biased = [B.ebath(b.cids, b.T, F.DT, F.NMD, wmax=1.0, bias=0.1,
                          efric=b.efric.double().cpu().numpy(),
                          exim=0.01 * rng.normal(size=(b.nc, b.nc)),
                          zeta1=0.01 * rng.normal(size=(b.nc, b.nc)),
                          zeta2=0.01 * rng.normal(size=(b.nc, b.nc)),
                          dtype=torch.float32, device=cuda, factorize=False)
                  for b in fr.baths]
        _check_k7(biased, 128, fr.nph, F.NMD, F.DT, cuda, 9)
        return
    r = SL.slab_runner(name, torch.float32, cuda, str(tmp_path))
    force = _check_k7(r.baths, SLAB_NTRAJ, r.nph, r.nmd, r.dt, cuda, 18)
    if name == "sw":
        assert force.stages[0].staged == 0


def _thermal_q(drv, ntraj, dev, seed, amp=0.05):
    """Displacements of ``amp`` angstrom rms per coordinate, in q."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    conv = torch.as_tensor(drv.conv, dtype=torch.float32, device=dev)
    return amp * torch.randn((ntraj, 3 * drv.number), device=dev,
                             generator=gen) / conv


def _against_float64(drv, ref, q):
    """A force driver on the card against its float64 twin on the CPU at
    q (64 trajectories at a time): force and energy within RTOL of their
    largest, and a bitwise repeat."""
    e, f = drv.energy_force_torch(q)
    assert torch.equal(drv.force_torch(q), f)
    qc = q.double().cpu()
    pairs = [ref.energy_force_torch(qc[i:i + 64])
             for i in range(0, q.shape[0], 64)]
    assert _rel(f, torch.cat([p[1] for p in pairs])) <= RTOL
    assert _rel(e, torch.cat([p[0] for p in pairs])) <= RTOL


def test_k5_at_many_body_flagship_chunks(cuda, tmp_path):
    """K5 at each chunk of the many-body flagship's RunEnsemble calls, at
    thermal starts (300 K, ``thermal_init``): against its float64 twin
    (``_against_float64``) and its float32 twin within K5_TWIN32_RTOL."""
    from sclmd_tpu_torch.md import thermal_init
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    fr = F.flagship_runner(torch.float32, cuda, str(tmp_path),
                           many_body=True)
    system, drv = fr._build_system(), fr.pforce
    ref = CHDriver(drv.axyz, dtype=torch.float64, device="cpu")
    gen = torch.Generator(device=cuda).manual_seed(13)
    for n in _chunks(fr, FLAG_SIZES, F.NMD):
        u = torch.rand((n, fr.nph), device=cuda, generator=gen)
        q = thermal_init(u, system, fr.hw, fr.U, F.T).q.contiguous()
        _against_float64(drv, ref, q)
        assert _rel(drv.force_torch(q), drv.kernel.plain(q)) <= \
            K5_TWIN32_RTOL, n


def _k5_geometry(name):
    """(atoms, CHDriver options, trajectories, placement) of the cases
    K5's redesign opened: a periodic cell, a table wider than 16, and
    the reference's large ribbon of 1,270 atoms, whose constants and
    working regions the kernel keeps in global memory."""
    from sclmd_tpu_torch.models.hydrocarbon import terminate_with_h
    from sclmd_tpu_torch.models.tersoff import graphene_ribbon
    if name == "periodic_cell":
        x0 = graphene_ribbon(3, 3)
        cell = np.array([x0[:, 0].max() + 1.42, 40.0, 20.0])
        return (terminate_with_h([["C", *row] for row in x0], cell=cell),
                dict(cell=cell), 128, "shared")
    if name == "wide_rows":
        return (terminate_with_h([["C", *row]
                                  for row in graphene_ribbon(4, 3)]),
                dict(cutoff_skin=2.5), 128, "shared")
    return (terminate_with_h([["C", *row] for row in graphene_ribbon(90, 6)]),
            {}, 32, "global")


@pytest.mark.parametrize("i,name", enumerate(["periodic_cell", "wide_rows",
                                              "large_ribbon"]))
def test_k5_geometries(cuda, i, name):
    """K5 on ``_k5_geometry``'s cases at thermal displacements: the
    planned placement, three launches (energy and force, repeat), the
    float64 twin (``_against_float64``), exactly zero at rest."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    axyz, kw, n, place = _k5_geometry(name)
    drv = CHDriver(axyz, dtype=torch.float32, device=cuda, **kw)
    ref = CHDriver(axyz, dtype=torch.float64, device="cpu", **kw)
    assert drv.kernel.cuda is not None
    assert name != "wide_rows" or drv.energy_fn.terms["nbr_c"].shape[1] > 16
    assert drv.kernel.cuda.plan(n)["place"] == place
    q = _thermal_q(drv, n, cuda, 40 + i)
    before = K5.launches
    _against_float64(drv, ref, q)
    assert K5.launches == before + 2
    assert not drv.force_torch(torch.zeros_like(q)).any()


def test_k8_on_the_sheet(cuda, tmp_path):
    """K8 on the periodic sheet at its RunEnsemble's 128 trajectories of
    thermal displacements: against its float64 twin
    (``_against_float64``), and exactly zero at rest."""
    drv = S.sheet_runner(torch.float32, cuda, str(tmp_path)).pforce
    ref = S.sheet_runner(torch.float64, "cpu", str(tmp_path)).pforce
    q = _thermal_q(drv, SHEET_NTRAJ, cuda, 15)
    _against_float64(drv, ref, q)
    assert not drv.force_torch(torch.zeros_like(q)).any()


@pytest.mark.parametrize("kind", ["sw", "eam", "eam_tab"])
def test_slab_forces_against_twins(cuda, kind):
    """K9 (the silicon slab) and K10 (the gold slab, analytic and
    tabulated) at SLAB_CHECK_NTRAJ trajectories of thermal displacements
    against the float64 twin (``_against_float64``), exactly zero at
    rest; at those, at RunEnsemble's 64 and at 65 (a second warp of one
    lane) against the float32 twin on the card, force and energy within
    RTOL; at 64 and 65 a bitwise repeat, a trajectory alone the bits it
    has in the batch, and the wide route (rows from global memory, kept entries in
    a global scratch) gives the same bits."""
    from sclmd_tpu_torch.kernels import slots
    seed = 18 if kind == "sw" else 19
    drv = SL.slab_driver(kind, torch.float32, cuda)
    q = _thermal_q(drv, SLAB_CHECK_NTRAJ, cuda, seed)
    _against_float64(drv, SL.slab_driver(kind, torch.float64, "cpu"), q)
    assert not drv.force_torch(torch.zeros_like(q)).any()
    kern = drv.kernel.cuda
    for n in (SLAB_CHECK_NTRAJ, SLAB_NTRAJ, SLAB_NTRAJ + 1):
        if n != SLAB_CHECK_NTRAJ:
            q = _thermal_q(drv, n, cuda, seed + 1)
        e, f = drv.energy_force_torch(q)
        e32, f32 = drv.kernel.plain(q, energy=True)
        assert _rel(f, f32) <= RTOL and _rel(e, e32) <= RTOL, n
        if n == SLAB_CHECK_NTRAJ:
            continue
        assert torch.equal(drv.force_torch(q), f), n
        for t in (0, 31, 32, n - 1):
            assert torch.equal(drv.force_torch(q[t:t + 1])[0], f[t]), (n, t)
        kern.plan = slots.Plan(slots.MAX_WARPS, 0, True)
        try:
            assert torch.equal(drv.force_torch(q), f), n
        finally:
            kern.plan = slots.launch_plan(kern.smem_per_warp(kern.pack))


# --- the colored noise -----------------------------------------------------
@pytest.mark.parametrize("name", ["primary", "flagship", "batch"])
def test_noise_statistics(cuda, tmp_path, record_property, name):
    """The series of 1,024 trajectories (K3, the C2R plan, the transpose)
    at the primary junction's factors (one (90, 90) matrix, nmd 2048),
    the flagship's (one (150, 150), nmd 1024) and a per-frequency batch
    of the primary's widths: variance and lag-1 covariance within 5
    standard errors of the factors' values; a trajectory's series the
    same bits from a chunk of 256 and one of 64."""
    from sclmd_tpu_torch.ops.noise import schedule_noise
    from sclmd_tpu_torch.parallel.ensemble import bath_factors
    if name == "batch":
        fac, dt, nmd = batch_factors(PJ.NC, PJ.NMD, cuda), PJ.DT, PJ.NMD
    else:
        make = PJ.primary_runner if name == "primary" else F.flagship_runner
        r = make(torch.float32, cuda, str(tmp_path))
        fac, dt, nmd = bath_factors(r.baths, cuda)[0], r.dt, r.nmd
    ev, std = fac
    a = schedule_noise(ev, std, K3_SEED, 0, 0, 256, dt, nmd,
                       packed=fac.packed)
    b = schedule_noise(ev, std, K3_SEED, 0, 192, 256, dt, nmd,
                       packed=fac.packed)
    assert torch.equal(a[192:], b)
    del a, b
    z = noise_z_scores(fac, dt, nmd, NSTAT, K3_SEED)
    record_property("z", z)
    assert all(abs(v) <= 5.0 for v in z.values()), z


# --- the NEGF cross-check ---------------------------------------------------
def test_flagship_negf_against_committed(cuda):
    """The flagship's transmission on the card (nd 483, leads of 150, 4,001
    points, complex128) against the committed sweep: T(w) at every
    point, ``j_nat`` and the conductance; the grid built in one chunk
    against chunks of 32."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.negf import landauer_current_natural
    ref = np.load(F.NPZ)
    b = F.flagship_bpt(cuda)
    tmn = b.gettm().copy()
    ws_ev, tm = tmn[:, 0] * units.RPC, tmn[:, 1]
    np.testing.assert_allclose(ws_ev, ref["ws_ev"], rtol=1e-15, atol=0)
    assert np.isfinite(tm).all() and tm[0] == 0.0
    assert np.abs(tm - ref["tm"]).max() <= \
        NEGF_RTOL * np.abs(ref["tm"]).max()
    j_nat = float(landauer_current_natural(ws_ev, tm, *_hot_cold(F)))
    kappa = b.thermalconductance(F.T, F.DELTA)
    for got, key in ((j_nat, "j_nat"), (kappa, "kappa_bpt")):
        want = float(ref[key])
        assert abs(got - want) <= NEGF_RTOL * abs(want), key
    b.batch_size = b.intnum + 1
    one = b.gettm()[:, 1]
    assert np.abs(one - tm).max() <= NEGF_BATCH_RTOL * np.abs(tm).max()


def test_conductance_gate(cuda, tmp_path, record_property):
    """The MD-vs-NEGF thermal conductance of the harmonic flagship:
    ``antithetic_run`` warm-started on the periodic attractor, 256
    trajectories, nmd 2^14, T 300 K, delta T 10 %, seed 11, float32,
    against ``j_nat`` of the committed NEGF sweep: |dev_pct| <= 2 and
    sem_pct <= 1; K3 once per bath, chunk and direction, no K3b (zero
    starts)."""
    from sclmd_tpu_torch.parallel import ensemble as TE
    j_ref = float(np.load(F.NPZ)["j_nat"])
    TL, TR = _hot_cold(F)

    def build(Ta, Tb):
        return F.flagship_runner(torch.float32, cuda, str(tmp_path),
                                 nmd=GATE_NMD, seed=GATE_SEED,
                                 temps=(Ta, Tb))

    before = P.launch_counts()
    j = TE.antithetic_run(build, TL, TR, GATE_NTRAJ, nsteps=GATE_NMD,
                          seed=GATE_SEED, warm_start=True)
    after = P.launch_counts()
    dev_pct = (float(j.mean()) - j_ref) / j_ref * 100
    sem_pct = float(j.std() / np.sqrt(len(j))) / abs(j_ref) * 100
    record_property("dev_pct", dev_pct)
    record_property("sem_pct", sem_pct)
    system = build(TL, TR)._build_system()
    nch = -(-GATE_NTRAJ // TE.auto_chunk(system, GATE_NTRAJ, GATE_NMD, None))
    got = {k: after[f"launches.{k}"] - before[f"launches.{k}"]
           for k in ("K3", "K3b", "K3_transpose")}
    assert got == {"K3": 4 * nch, "K3b": 0, "K3_transpose": 4 * nch}
    assert np.isfinite(j).all()
    assert abs(dev_pct) <= GATE_DEV_PCT and sem_pct <= GATE_SEM_PCT, \
        (dev_pct, sem_pct)


# --- the slabs: K9 and K10 ---------------------------------------------------
@pytest.mark.parametrize("kind", ["sw", "eam", "eam_tab"])
def test_slab_ensemble(cuda, tmp_path, record_property, kind):
    """The silicon slab (K9) and the gold slab (K10, analytic and
    tabulated) through RunEnsemble(64, nsteps=1024, npie=2,
    checkpoint=True): the force kernel twice a step, K7 three times (on
    its unstaged route where the slab's 10,368 DOFs do not fit), no K6
    (memory length 1), K3 once per bath, no K3b (the slabs start at
    rest), no torch.Generator; finite currents and ``MDE.npz``. Then (not
    for the tabulated slab) the same draws in one segment give the same
    means within RTOL; a second call after the kappa files are deleted
    resumes from ``MDE.npz`` with no force launch and the same means and
    files; another chunk is refused as a stale checkpoint; and the same
    draws at swapped lead temperatures: heat flows hot to cold."""
    force = "K9" if kind == "sw" else "K10"
    drv = SL.slab_driver(kind, torch.float32, cuda)
    assert drv.kernel.cuda is not None
    if kind != "sw":
        assert drv.kernel.cuda.pack["mode"] == (kind == "eam_tab")
    d = tmp_path / "run"
    d.mkdir()
    r = SL.slab_runner(kind, torch.float32, cuda, str(d), driver=drv)
    kw = dict(nsteps=SLAB_NSTEPS, npie=SLAB_NPIE)
    with no_generator():
        means = r.RunEnsemble(SLAB_NTRAJ, checkpoint=True, **kw)
    n = SLAB_NSTEPS
    want = {force: 2 * n, "K7": 3 * n,
            "K7_wide": 3 * n if r.nph > 9000 else 0, "K6": 0, "K3": 2,
            "K3b": 0, "K3_transpose": 2}
    assert _pick(launches(), want) == want
    assert means.shape == (SLAB_NTRAJ, 2) and np.isfinite(means).all()
    ke = r.energy(r.state)
    assert np.isfinite(ke) and ke > 0.0, ke
    assert (d / "MDE.npz").is_file()
    if kind == "eam_tab":
        return

    (tmp_path / "one").mkdir()
    one = SL.slab_runner(kind, torch.float32, cuda, str(tmp_path / "one"),
                         driver=drv).RunEnsemble(SLAB_NTRAJ, nsteps=n)
    assert _rel(means, one) <= RTOL

    for f in d.glob("kappa.*"):
        f.unlink()
    again = r.RunEnsemble(SLAB_NTRAJ, checkpoint=True, **kw)
    assert np.array_equal(again, means)
    assert launches()[force] == 0
    assert len(list(d.glob("kappa.*"))) == 2 * SLAB_NTRAJ
    with pytest.raises(ValueError, match="stale checkpoint"):
        r.RunEnsemble(SLAB_NTRAJ, checkpoint=True, chunk=SLAB_NTRAJ // 2,
                      **kw)

    (tmp_path / "rev").mkdir()
    rev = SL.slab_runner(kind, torch.float32, cuda, str(tmp_path / "rev"),
                         temps=_hot_cold(SL)[::-1],
                         driver=drv).RunEnsemble(SLAB_NTRAJ, **kw)
    _assert_hot_to_cold(means, rev, record_property)


def test_eam_tabulated_against_analytic(cuda):
    """The gold slab's tabulated force (K10 through the splines of
    ``sutton_chen_tables``) against its analytic force at the same
    thermal displacements (4 trajectories, 0.05 angstrom rms): within the
    splines' own error, the two float64 twins' difference, plus float32
    rounding."""
    an = SL.slab_driver("eam", torch.float32, cuda)
    tab = SL.slab_driver("eam_tab", torch.float32, cuda)
    gen = torch.Generator(device=cuda).manual_seed(19)
    conv = torch.as_tensor(an.conv, dtype=torch.float32, device=cuda)
    q = 0.05 * torch.randn((4, 3 * an.number), device=cuda,
                           generator=gen) / conv
    qc = q.double().cpu()
    spline = float((SL.slab_driver("eam_tab", torch.float64, "cpu")
                    .force_torch(qc)
                    - SL.slab_driver("eam", torch.float64, "cpu")
                    .force_torch(qc)).abs().max())
    f_an = an.force_torch(q)
    gap = float((tab.force_torch(q) - f_an).abs().max())
    assert gap <= spline + RTOL * float(f_an.abs().max()), (gap, spline)


# --- lead-block baths -------------------------------------------------------
def test_sig_card_against_cpu(cuda):
    """``selfenergy.sig`` at examples/runsig.py's configuration (the
    graphene strip, layers of four atoms, 401 points) on the card
    against the CPU, complex128: Sigma_L, Sigma_R and T within 1e-10 of
    their largest magnitudes and the same decimation count for each
    frequency, at w > 0 (w = 0 is ill-conditioned in the reference
    itself: (w + i eta)^2 = -eta^2 is real there and the strip's layer
    block indefinite)."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.models.tersoff import TersoffDriver, graphene_ribbon
    from sclmd_tpu_torch.selfenergy import sig
    drv = TersoffDriver([["C", *row] for row in graphene_ribbon(8, 2)],
                        dtype=torch.float64, device=cuda)
    d_ps2 = drv.dynmat().numpy() / units.RPC ** 2
    lay = 3 * (drv.number // 4)
    g0, g1 = list(range(lay, lay + 12)), list(range(lay + 12, lay + 24))
    card, cpu = (sig(d_ps2, 0.12, g0, g1, num=400, eta=0.164e-3, device=d)
                 for d in (cuda, "cpu"))
    got = (card.getse("L"), card.getse("R"), card.gettm()[:, 1])
    want = (cpu.getse("L"), cpu.getse("R"), cpu.gettm()[:, 1])
    for name, g, w in zip(("sigma_L", "sigma_R", "tm"), got, want):
        assert np.isfinite(g).all(), name
        assert np.abs(g[1:] - w[1:]).max() <= \
            SIG_RTOL * np.abs(w[1:]).max(), name
    for d in ("L", "R"):
        assert np.array_equal(np.asarray(card.niter[d])[1:],
                              np.asarray(cpu.niter[d])[1:]), d


def test_lead_block_ensemble(cuda, tmp_path, record_property):
    """RunEnsemble(512) of ``lead_block_chain`` on the blocked path,
    float32: K1, K2, K3 and K3b launched; the same draws at swapped lead
    temperatures (delta 0.5): heat flows hot to cold."""
    runs = []
    for temps in ((375.0, 225.0), (225.0, 375.0)):
        d = tmp_path / str(len(runs))
        d.mkdir()
        runs.append(lead_block_chain(torch.float32, cuda, str(d), temps)
                    .RunEnsemble(LEAD_NTRAJ, block=64))
        if len(runs) == 1:
            got = launches()
    assert min(got[k] for k in ("K1_near", "K1_far", "K2", "K3", "K3b",
                                "K3_transpose")) > 0, got
    _assert_hot_to_cold(*runs, record_property)


# --- the Lambda pipeline and the biased flagship ---------------------------
def test_lambda_write_invariants(cuda, tmp_path):
    """``LambdaPipeline.write`` at rundp's model with 96 orbitals, 60
    modes and 2,048 energies (mode chunks of 8, hwcut 0.05, muL/muR
    +-0.25) on the card: eta symmetric, xim and zeta2 antisymmetric,
    LamEqu real and symmetric, zero outside the hwcut mask, every array
    finite."""
    from sclmd_tpu_torch.examples.current_induced.rundp import model
    from sclmd_tpu_torch.postprocess import lambda_pipeline as LP
    n_el, nm, ne, chunk = LAMBDA_FULL
    pl = LP.LambdaPipeline(*model(n_el=n_el, nm=nm, ne=ne), device=cuda,
                           mode_chunk=chunk)
    full, wb = pl.write(str(tmp_path / "Lambda.npz"), 0.05, 0.25, -0.25)
    mask = LP._pair_mask(pl.hw, 0.05)

    def asym(x, sign):
        x = np.asarray(x)
        return float(np.abs(x - sign * np.swapaxes(x, -1, -2)).max()
                     / max(np.abs(x).max(), 1e-300))

    assert asym(wb["eta"], 1) <= 1e-12 and asym(wb["xim"], -1) <= 1e-12
    assert asym(wb["zeta2"], -1) == 0.0
    assert asym(full["LamEqu"], 1) <= 1e-12
    assert np.isrealobj(full["LamEqu"])
    if (~mask).any():
        for k, v in list(wb.items()) + list(full.items()):
            if k not in ("wl", "TR"):
                assert not np.asarray(v)[..., ~mask].any(), k
    assert all(np.isfinite(np.asarray(v)).all() for v in full.values())


def kaverage_model(n, nk, ne, seed=22):
    """k-resolved inputs of ``kaverage_extract``: rundp's model Hamiltonian
    (``n`` orbitals) with a k-dependent hopping, its leads on
    ``fft_order_grid(4.0, ne)`` scaled per k, uniform k weights."""
    from sclmd_tpu_torch.examples.current_induced.rundp import model
    H, S_, E, SigL, SigR, _, _ = model(n_el=n, nm=1, ne=ne)
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, n)) * 0.1
    ks = np.linspace(0.0, np.pi, nk, endpoint=False)
    Hk = np.stack([H + np.cos(k) * (t + t.T) / 2
                   + 1j * np.sin(k) * (t - t.T) / 2 for k in ks])
    Sk = np.broadcast_to(S_, (nk, n, n)).copy()
    fk = (1.0 + 0.1 * np.cos(ks))[None, :, None, None]
    return (Hk, Sk, SigL[:, None] * fk, SigR[:, None] * fk[..., ::-1, :, :],
            E, np.full(nk, 1.0 / nk))


def _tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _within(got: dict, want: dict, rtol):
    for k, w in want.items():
        assert _rel(_tensor(got[k]), _tensor(w)) <= rtol, k


def test_lambda_card_against_cpu(cuda):
    """The Lambda pipeline at rundp's model with LAMBDA_SMALL's 24
    orbitals, 12 modes and 512 energies, and ``kaverage_extract`` on
    ``kaverage_model`` at 4 k points, on the card against the CPU (both
    complex128): the spectral functions, wideband, every array of
    full_lambda and of the k average within LAMBDA_RTOL of its largest
    value; ``kaverage_extract`` at KAVERAGE_FULL finite."""
    from sclmd_tpu_torch.examples.current_induced.rundp import model
    from sclmd_tpu_torch.postprocess import hssigma as HS
    from sclmd_tpu_torch.postprocess import lambda_pipeline as LP
    n_el, nm, ne, nk = LAMBDA_SMALL
    card, cpu = (LP.LambdaPipeline(*model(n_el=n_el, nm=nm, ne=ne), device=d)
                 for d in (cuda, "cpu"))
    _within(card.sp, cpu.sp, LAMBDA_RTOL)
    _within(card.wideband(0.05), cpu.wideband(0.05), LAMBDA_RTOL)
    _within(card.full_lambda(0.05, 0.25, -0.25),
            cpu.full_lambda(0.05, 0.25, -0.25), LAMBDA_RTOL)
    kargs = kaverage_model(n_el, nk, ne)
    _within(HS.kaverage_extract(*kargs, eta=1e-3, device=cuda),
            HS.kaverage_extract(*kargs, eta=1e-3, device="cpu"), LAMBDA_RTOL)
    nk, n, ne = KAVERAGE_FULL
    res = HS.kaverage_extract(*kaverage_model(n, nk, ne), eta=1e-3,
                              device=cuda)
    assert all(bool(torch.isfinite(_tensor(v)).all()) for v in res.values())


def test_biased_flagship_ensemble(cuda, tmp_path):
    """The harmonic flagship with a third electron bath on its 183 centre
    DOFs at bias 0.5 (its matrices from ``LambdaPipeline.wideband`` on
    the card, written as a wbLambda file and read back):
    RunEnsemble(256) after a warm-up, K7 three times a step (the biased
    bath on its wind/Berry route), K3 once per bath and chunk (the
    centre's on the per-frequency route), K3b once per chunk, no
    torch.Generator, a bounded kinetic energy; ``calHF(bathnum=3)`` and
    ``calTC(0.1, bathnum=3)`` on its 768 kappa files against the call's
    means, to the files' printed precision."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.utils.io import ReadwbLambda
    _, part, dyn = F.flagship_junction()
    centre = F.centre_dofs(part)
    assert len(centre) == len(dyn) - len(part["fixdofs"]) - len(
        part["ecatsl"]) - len(part["ecatsr"]) == 183
    wbf = str(tmp_path / "wbLambda.npz")
    m = F.write_centre_bath(wbf, cuda, len(centre))
    back = ReadwbLambda(wbf)
    for a, k in zip(back[1:], ("eta", "xim", "xip", "zeta1", "zeta2")):
        assert np.array_equal(a, m[k]), k
    r = F.biased_flagship_runner(torch.float32, cuda, str(tmp_path), wbf)
    assert r.baths[2].bias_terms and r.baths[2].nevecs.ndim == 3
    r.RunEnsemble(BIASED_NTRAJ, nsteps=F.NMD, block=None)
    d = tmp_path / "run"
    d.mkdir()
    r.outdir = str(d)
    batch = K3.launches_batch
    with no_generator():
        means = r.RunEnsemble(BIASED_NTRAJ, nsteps=F.NMD, block=None)
    nch = len(chunk_sizes(r._build_system(), BIASED_NTRAJ, F.NMD))
    want = {"K7": 3 * F.NMD * nch, "K3": 3 * nch, "K3b": nch,
            "K3_transpose": 3 * nch}
    assert _pick(launches(), want) == want
    assert K3.launches_batch - batch == nch
    assert means.shape == (BIASED_NTRAJ, 3) and np.isfinite(means).all()
    _kinetic_energy_bounded(r)

    assert len(list(d.glob("kappa.*"))) == 3 * BIASED_NTRAJ
    assert_kappa_files_read_back(str(d), means, r.T)
