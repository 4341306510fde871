"""The port's CUDA kernels against their plain torch twins, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 kernels against float32 twins (or float64 CPU
runs), summed in another order; errors are taken relative to the
largest magnitude of each compared quantity, since heat-current samples
pass through zero.
"""

import numpy as np
import pytest
import torch

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.kernels import block_corr as K2
from sclmd_tpu_torch.kernels import gle_block as K1
from sclmd_tpu_torch.models.harmonic import chain_dynmat

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = (torch.view_as_real(x) if x.is_complex() else x for x in (a, b))
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("nc", [90, 6, 33])
@pytest.mark.parametrize("ntraj", [1, 70, 512])
def test_block_corr_freq_matches_twin(cuda, ntraj, nc):
    """One and 70 trajectories (a ragged tile of 64), 512 (eight tiles,
    the load ring running on across them); the primary width, a narrow
    one and one that leaves most of a warp's last row tile empty."""
    gen = torch.Generator(device=cuda).manual_seed(ntraj + nc)
    khat = torch.randn((33, nc, nc), dtype=torch.complex64, device=cuda,
                       generator=gen)
    hhat = torch.randn((ntraj, 33, nc), dtype=torch.complex64, device=cuda,
                       generator=gen)
    before = K2.launches
    got = K2.block_corr_freq(khat, hhat)
    want = K2.block_corr_freq_plain(khat, hhat)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    assert _rel(got, want) < 1e-5


def _system(device, dtype, ntraj, nph=36, nmd=128, ml=40, constrained=False):
    """Two non-local baths of different widths (6 contiguous DOFs, 4
    scattered ones) on a 36-DOF chain."""
    gwl = np.linspace(0.0, 0.6, 16)
    baths = []
    rng = np.random.default_rng(1)
    for T, cats in ((320.0, range(6)), (280.0, [30, 31, 33, 32])):
        nc = len(cats)
        gam = np.array([np.eye(nc) * 0.02 * np.exp(-(w / 0.3) ** 2)
                        for w in gwl])
        b = TB.phbath(T, cats, 0.3, 32, 0.4, nmd, ml=ml, gamma=gam, gwl=gwl,
                      dtype=dtype, device=device)
        noise = 0.01 * rng.standard_normal((ntraj, nmd, nc))
        baths.append(b.replace(noise=torch.as_tensor(noise, dtype=dtype,
                                                     device=device)))
    mask = torch.ones(nph, dtype=dtype, device=device)
    if constrained:
        mask[[0, 35]] = 0.0
    return TMD.GLESystem(
        dyn=chain_dynmat(nph, 0.05, dtype=dtype).to(device),
        baths=tuple(baths), mask=mask, dt=0.4, nph=nph, ml=ml, nmd=nmd,
        unconstrained=not constrained)


def _card_vs_cpu(cuda, ntraj, constrained, ml, block=32):
    """run_segment_blocked with the kernels on the card (float32) against
    the twins on the CPU (float64), three blocks."""
    out = {}
    nsteps = 3 * block
    sub = K1.sub_steps(block)
    nsub = -(-block // sub)
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        system = _system(dev, dtype, ntraj, ml=ml, constrained=constrained)
        rng = np.random.default_rng(2)
        st = TMD.initial_state(system, ntraj, dtype=dtype).replace(
            p=torch.as_tensor(0.05 * rng.standard_normal((ntraj, 36)),
                              dtype=dtype, device=dev))
        near, far, k2 = K1.launches_near, K1.launches_far, K2.launches
        fin, ys = TMD.run_segment_blocked(system, st, nsteps, t0=7,
                                          block=block)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert K1.launches_near == near + 3 * nsub
            assert K1.launches_far == far + 3 * (nsub - 1)
            assert K2.launches == k2 + 6
        out[dev if dev == "cpu" else "cuda"] = (fin, ys)
    (fg, yg), (fc, yc) = out["cuda"], out["cpu"]
    for a, b in ((fg.p, fc.p), (fg.q, fc.q), (fg.phis, fc.phis),
                 (fg.qhis, fc.qhis), (yg["cur"], yc["cur"]),
                 (yg["etot"], yc["etot"])):
        assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("ntraj,constrained,ml", [(3, False, 40),
                                                  (37, False, 12),
                                                  (5, True, 40)])
def test_run_segment_blocked_card_matches_cpu(cuda, ntraj, constrained, ml):
    """Ragged trajectory tiles, baths of different widths, a
    non-contiguous bath, a kernel shorter than the block (ml 12), the
    constrained path without force carry-forward."""
    _card_vs_cpu(cuda, ntraj, constrained, ml)


@pytest.fixture
def sub_steps(monkeypatch):
    def use(sub):
        monkeypatch.setattr(K1, "sub_steps",
                            lambda block: min(block, sub))
    return use


@pytest.mark.parametrize("sub,block", [(5, 32), (1, 8), (32, 32), (7, 9)])
def test_sub_blocks_card_matches_cpu(cuda, sub_steps, sub, block):
    """Sub-blocks that do not divide the block (5 into 32, 7 into 9), one
    step per sub-block, one sub-block per block (no far taps)."""
    sub_steps(sub)
    _card_vs_cpu(cuda, 11, False, 40, block=block)


@pytest.mark.parametrize("tile", [2, 4])
def test_multi_trajectory_tiles_match_cpu(cuda, tile):
    """Enough trajectories that the wrapper picks two or four per CTA
    (it wants about one CTA per SM), with a ragged last tile: the
    per-tile indexing of the near kernel against the float64 twins."""
    want = (9 * torch.cuda.get_device_properties(cuda)
            .multi_processor_count) // 10
    ntraj = 2 * want + 1 if tile == 2 else 4 * want - 1
    assert ntraj % tile
    assert K1.tile_size(ntraj, 36, 2, 6, K1.sub_steps(32),
                        cuda) == tile
    _card_vs_cpu(cuda, ntraj, False, 40)


@pytest.mark.parametrize("ntraj", [3, 70])
def test_near_and_far_kernels_match_twins(cuda, ntraj):
    """Each kernel of the pair alone against its twin on the same
    tensors: one near-tap sub-block from a random state, and one far-tap
    update of random tails from random rings."""
    block, b0, ns = 32, 10, 7
    system = _system(cuda, torch.float32, ntraj)
    gen = torch.Generator(device=cuda).manual_seed(ntraj)
    baths = []
    for b in system.baths:
        kin = b.block_tap_kernel(block)
        O = 0.01 * torch.randn((ntraj, block + 1, b.nc), device=cuda,
                               generator=gen)
        baths.append(K1.BathOperands(
            b.noise, O, kin, K1.tap_major(kin, block),
            b.kernel[0].contiguous(), b.cols,
            torch.as_tensor(b.cids, dtype=torch.int32, device=cuda)))
    p = 0.05 * torch.randn((ntraj, 36), device=cuda, generator=gen)
    q = 0.05 * torch.randn((ntraj, 36), device=cuda, generator=gen)
    pf = system.potential_force(q)
    states = [K1.BlockState(p, q, pf, baths, block) for _ in range(2)]
    for r0, r1 in zip(states[0].rings, states[1].rings):
        r0.normal_(generator=gen).mul_(0.05)    # earlier sub-blocks' rows
        r1.copy_(r0)
    run = (system.dyn, system.mask, baths, 3, 128, 0.4, True, block, b0, ns)
    before = K1.launches_near, K1.launches_far
    K1.gle_near_cuda(states[0], *run, sub=ns + 1,
                     tt=K1.tile_size(ntraj, 36, 2, 6, ns + 1, cuda))
    K1.gle_near_plain(states[1], *run)
    K1.gle_far_cuda(baths, states[0].rings, states[0].Os, block, b0, ns)
    for b, r, O in zip(baths, states[1].rings, states[1].Os):
        K1.gle_far_plain(b.kin, r, O, block, b0, ns)
    torch.cuda.synchronize()
    assert (K1.launches_near, K1.launches_far) == (before[0] + 1,
                                                   before[1] + 1)
    got, want = states
    # (qprev is written at the block's last step only)
    for name in ("p", "q", "pf", "cur", "etot"):
        assert _rel(getattr(got, name), getattr(want, name)) < 1e-5, name
    for g, w in zip(got.rings + got.Os, want.rings + want.Os):
        assert _rel(g, w) < 1e-5


# --- K6 conv_tails and K7 bath_force (the plain step) -------------------------
def _phonon(device, dtype, cats, ml, nmd=32, T=300.0):
    nc = len(cats)
    gwl = np.linspace(0.0, 0.6, 16)
    gam = np.array([np.eye(nc) * 0.02 * np.exp(-(w / 0.3) ** 2)
                    for w in gwl])
    return TB.phbath(T, cats, 0.3, 32, 0.4, nmd, ml=ml, gamma=gam, gwl=gwl,
                     dtype=dtype, device=device, factorize=False)


def _electron(device, dtype, cats, biased, nmd=32, seed=0):
    nc = len(cats)
    rng = np.random.default_rng(seed)
    a = 0.05 * rng.normal(size=(nc, nc))
    extra = {}
    if biased:
        extra = dict(bias=0.2, exim=0.02 * rng.normal(size=(nc, nc)),
                     zeta1=0.02 * rng.normal(size=(nc, nc)),
                     zeta2=0.02 * rng.normal(size=(nc, nc)))
    return TB.ebath(cats, 300.0, 0.4, nmd, wmax=1.0,
                    efric=a @ a.T + 0.02 * np.eye(nc), dtype=dtype,
                    device=device, factorize=False, **extra)


def _k6_baths(cuda, mls, wide):
    """Two baths (or one, where ``mls`` has one entry): 6 contiguous and
    4 scattered DOFs, or with ``wide`` 33 and 5 (odd widths: a tap's rows
    then start off the 16-byte boundaries the bulk copies need)."""
    cats = ([range(10, 43), [47, 2, 45, 5, 8]] if wide
            else [range(3, 9), [20, 2, 17, 11]])
    return [_phonon(cuda, torch.float32, c, ml) for c, ml in zip(cats, mls)]


@pytest.mark.parametrize("ntraj,mls,head,wide,nsm", [
    (1, (13, 12), 0, False, None), (2, (11, 10), 9, False, None),
    (7, (30, 29), 29, False, None), (37, (1000, 999), 411, False, None),
    (1, (3,), 1, False, None), (3, (3, 5), 4, True, None),
    (1, (40, 17), 33, True, None), (5, (64, 64), 7, True, 3),
    (1, (200, 150), 120, False, 2)])
def test_conv_tails_matches_twin(cuda, ntraj, mls, head, wide, nsm):
    """Tap ranges that do not divide evenly over the CTAs, more CTAs
    than taps (every case with the card's own SM count but the 37 x 1000
    one), one tap (ml 3), one-, two- and four-trajectory tiles with
    ragged last tiles, a non-contiguous bath, odd widths (33, 5), tap
    ranges longer than the stage ring so that it wraps (2 or 3 CTAs for
    all the taps), and a history ring longer than the kernel read across
    its wrap."""
    from sclmd_tpu_torch.kernels import conv_tails as K6
    baths = _k6_baths(cuda, mls, wide)
    gen = torch.Generator(device=cuda).manual_seed(ntraj)
    ring = torch.randn((ntraj, max(mls) + 2, 48), device=cuda, generator=gen)
    before = K6.launches
    k6 = K6.ConvTailsCuda(ring, baths, nsm=nsm)
    if nsm is not None:
        longest = max(r1 - r0 for _, _, _, r0, r1, _, _, _ in k6.plan["desc"])
        assert longest > k6.plan["nstage"]
    got = [t.clone() for t in k6((-head) % ring.shape[1])]
    want = K6.conv_tails_plain(ring, head, baths)
    ref64 = K6.conv_tails_plain(
        ring.double().cpu(), head,
        [b.replace(kernel=b.kernel.double().cpu()) for b in baths])
    torch.cuda.synchronize()
    assert K6.launches == before + 1
    for g, w, r in zip(got, want, ref64):
        assert g.shape == (ntraj, w.shape[1], 2)
        assert _rel(g, w) < 1e-5 and _rel(g, r) < 1e-5


@pytest.mark.parametrize("ntraj,mls,wide", [(1, (1000, 999), False),
                                            (6, (64, 33), True)])
def test_conv_tails_repeats_bitwise(cuda, ntraj, mls, wide):
    """Two calls on the same inputs give the same bits (the partial sums
    are added in a fixed order, whichever CTA comes last), and a call at
    another head in between leaves nothing behind."""
    from sclmd_tpu_torch.kernels import conv_tails as K6
    baths = _k6_baths(cuda, mls, wide)
    gen = torch.Generator(device=cuda).manual_seed(3)
    ring = torch.randn((ntraj, max(mls), 48), device=cuda, generator=gen)
    k6 = K6.ConvTailsCuda(ring, baths)
    first = [t.clone() for t in k6(5)]
    k6(11)
    for _ in range(3):
        again = k6(5)
        torch.cuda.synchronize()
        for f, g in zip(first, again):
            assert torch.equal(f, g)


DISJOINT = ([0, 1, 2, 3], [23, 5, 21, 7, 9], [10, 12], [14, 15, 16])
SHARED = ([0, 1, 2, 3, 5], [23, 5, 2, 7, 9], [10, 12], [12, 15, 16])


def _k7_case(device, dtype, kinds, ntraj, nph=24, nmd=32, sets=DISJOINT):
    """Baths of the listed kinds on partly non-contiguous DOF sets
    (disjoint, or with ``SHARED`` overlapping), with random noise; kind
    is ("phonon", ml), ("local",), ("electron",) or ("biased",)."""
    baths = []
    rng = np.random.default_rng(len(kinds) + ntraj)
    for k, cats in zip(kinds, sets):
        if k[0] == "phonon":
            b = _phonon(device, dtype, cats, k[1], nmd)
        elif k[0] == "local":
            b = TB.phbath(300.0, cats, 0.2, 32, 0.4, nmd, dtype=dtype,
                          device=device, factorize=False)
        else:
            b = _electron(device, dtype, cats, k[0] == "biased", nmd)
        noise = rng.normal(size=(ntraj, nmd, len(cats)))
        baths.append(b.replace(noise=torch.as_tensor(noise, dtype=dtype,
                                                     device=device)))
    return baths


def _k7_against_twin(cuda, kinds, ntraj, sets=DISJOINT, tile=None, nph=24,
                     unstage=False):
    """K7's three stages against the twins on the same tensors;
    ``unstage``: the launches take the unstaged route on the staged
    plan's layout. Returns the kernel's outputs."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    nmd = 32
    baths = _k7_case(cuda, torch.float32, kinds, ntraj, nph, nmd, sets)
    gen = torch.Generator(device=cuda).manual_seed(ntraj)

    def rnd(*shape):
        return torch.randn(shape, device=cuda, generator=gen)

    p, q, pf, pf2, x = (rnd(ntraj, nph) for _ in range(5))
    mask = torch.ones(nph, device=cuda)
    mask[[4, 19]] = 0.0
    mlr = max(b.ml for b in baths) + 1
    ring = rnd(ntraj, mlr, nph)
    tails = [rnd(ntraj, b.nc, 2) if b.ml > 2 else None for b in baths]
    # step s of a segment: ring head -s mod mlr = 1, push row 0, noise
    # rows 7 and 8; the outputs' rows have strides of their own
    s = mlr - 1
    force = K7.BathForce(baths, ntraj, nph, nmd, 0.4, cuda, tile=tile,
                         t0=7 - s)
    if unstage:
        for a in force.stages:
            a.staged = 0
    res = {}
    for name, run in (("kernel", force), ("twin", None)):
        rg = ring.clone()
        cur = torch.zeros((ntraj, s + 3, len(baths)), device=cuda)
        etot = torch.zeros((ntraj, s + 5), device=cuda)
        ps, qs = (torch.zeros((ntraj, s + 2, nph), device=cuda)
                  for _ in range(2))
        fbs = [torch.zeros((ntraj, b.nc), device=cuda) for b in baths]
        f_out = torch.zeros((ntraj, nph), device=cuda)
        if run is not None:
            before = K7.launches
            ph, qt = run.pred(p, q, pf, rg, s, tails, cur, etot, fbs,
                              ps=ps, qs=qs)
            pc, _ = run.corr(x, qt, pf2, p, ph, tails, s)
            pl, ql = run.corr(x, qt, pf2, p, ph, tails, s, mask=mask,
                              f_out=f_out)
            torch.cuda.synchronize()
            assert K7.launches == before + 3
        else:
            ph, qt = K7.pred_plain(p, q, pf, rg, 1, 0, force.ops, tails, 7,
                                   0.4, cur[:, s], etot[:, s], fbs)
            ps[:, s], qs[:, s] = p, q
            pc, _ = K7.corr_plain(x, qt, pf2, p, ph, force.ops, tails, 8,
                                  0.4)
            pl, ql = K7.corr_plain(x, qt, pf2, p, ph, force.ops, tails, 8,
                                   0.4, mask, f_out)
        res[name] = dict(ph=ph, qt=qt, pc=pc, pl=pl, ql=ql, cur=cur,
                         etot=etot, ps=ps, qs=qs, f=f_out, ring=rg,
                         **{f"fb{i}": fb for i, fb in enumerate(fbs)})
    for k, v in res["twin"].items():
        assert _rel(res["kernel"][k], v) < 1e-5, k
    return force, res["kernel"]


@pytest.mark.parametrize("kinds", [
    (("phonon", 12), ("local",), ("electron",), ("biased",)),
    (("phonon", 2), ("biased",)),
    (("electron",), ("electron",))])
@pytest.mark.parametrize("tile", [1, 2, 4, 8])
def test_bath_force_matches_twin(cuda, kinds, tile):
    """Predictor, corrector and last corrector against the twins on the
    same tensors: every bath kind, bias on and off, non-contiguous
    cids, tiles of one, two, four and eight trajectories (ragged)."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    nsm = torch.cuda.get_device_properties(cuda).multi_processor_count
    ntraj = {1: 3, 2: 2 * nsm + 1, 4: 4 * nsm + 1, 8: 8 * nsm + 3}[tile]
    assert K7.tile_size(ntraj, nsm) == tile
    _k7_against_twin(cuda, kinds, ntraj)


@pytest.mark.parametrize("kinds,ntraj,sets,tile", [
    ((("phonon", 12), ("phonon", 2)), 1, DISJOINT, None),
    ((("biased",), ("local",)), 1, DISJOINT, None),
    ((("biased",), ("local",)), 5, DISJOINT, 4),
    ((("phonon", 12), ("biased",), ("local",), ("electron",)), 1, SHARED,
     None),
    ((("electron",), ("biased",), ("local",), ("phonon", 5)), 7, SHARED, 2),
    ((("electron",), ("biased",), ("local",), ("phonon", 5)), 11, SHARED,
     8)])
def test_bath_force_shapes(cuda, kinds, ntraj, sets, tile):
    """One trajectory (a single CTA), three matrices (a biased electron
    bath) next to one (a local phonon bath) in one launch, and baths
    that share DOFs (their forces add up on those), in the staged form
    (one or two trajectories per CTA) and the tiled one."""
    _k7_against_twin(cuda, kinds, ntraj, sets, tile)


@pytest.mark.parametrize("ntraj,tile", [(3, None), (5, 2)])
def test_bath_force_wide_system_reads_global_memory(cuda, ntraj, tile):
    """The silicon slab's shapes (nph 10,368, two phonon baths of 864
    DOFs and memory length 1 at its two ends): too wide to stage, the
    launches take the unstaged route, count as such, and agree with the
    twins."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    nph = 10368
    sets = (list(range(864)), list(range(nph - 864, nph)))
    before = K7.launches_wide
    force, _ = _k7_against_twin(cuda, (("phonon", 1), ("phonon", 1)), ntraj,
                                sets, tile, nph=nph)
    assert all(a.staged == 0 for a in force.stages)
    assert K7.launches_wide == before + 3


@pytest.mark.parametrize("tile", [1, 2])
def test_bath_force_routes_give_the_same_bits(cuda, tile):
    """Where the staged route fits, the unstaged one (the same plan, its
    vectors read from global memory) writes the same bits."""
    kinds = (("phonon", 12), ("local",), ("electron",), ("biased",))
    ntraj = 3 if tile == 1 else 5
    staged, out = _k7_against_twin(cuda, kinds, ntraj, tile=tile)
    assert all(a.staged == 1 for a in staged.stages)
    _, again = _k7_against_twin(cuda, kinds, ntraj, tile=tile, unstage=True)
    for k, v in out.items():
        assert torch.equal(v, again[k]), k


WIDE_NPH = 10368
# the silicon slab's two end baths and a third of scattered DOFs in
# descending order between them
WIDE_SETS = (list(range(864)), list(range(WIDE_NPH - 864, WIDE_NPH)),
             list(range(5003, 2000, -7)))


@pytest.mark.parametrize("kinds", [
    (("phonon", 1), ("phonon", 1)),
    (("phonon", 12), ("biased",), ("phonon", 1))],
    ids=["slab", "memory-biased-local"])
@pytest.mark.parametrize("ntraj", [1, 3, 64, 65, 130])
def test_bath_force_wide_route_matches_twin(cuda, kinds, ntraj):
    """The wide route (the bath force as a product over trajectories) at
    the silicon slab's width against the twins, all three stages and
    every output: one trajectory, a ragged tile, the slab's 64, one
    over a tile and more trajectories than SMs; wideband phonon baths
    (K = nc), a memory-kernel bath with K6's tails (K = 2 nc) and a
    biased electron bath (K = 3 nc) on scattered DOFs."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    before, wide = K7.launches, K7.launches_wide
    force, _ = _k7_against_twin(cuda, kinds, ntraj, WIDE_SETS, nph=WIDE_NPH)
    assert force.wide and force.wide_pred
    assert K7.launches - before == K7.launches_wide - wide == 3


def test_bath_force_wide_route_repeats_bitwise(cuda):
    """One ``BathForce`` on the wide route: each stage run three times
    on the same inputs, with a predictor of another step in between,
    gives the same bits every time (the heat currents' ticket is left
    at zero by every launch), one launch and one wide launch counted an
    evaluation."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    kinds = (("phonon", 12), ("biased",), ("phonon", 1))
    ntraj, nmd = 130, 32
    baths = _k7_case(cuda, torch.float32, kinds, ntraj, WIDE_NPH, nmd,
                     WIDE_SETS)
    gen = torch.Generator(device=cuda).manual_seed(2)
    p, q, pf, x = (torch.randn((ntraj, WIDE_NPH), device=cuda, generator=gen)
                   for _ in range(4))
    mask = torch.ones(WIDE_NPH, device=cuda)
    mask[[4, 5000, 9600]] = 0.0
    ring = torch.randn((ntraj, 13, WIDE_NPH), device=cuda, generator=gen)
    tails = [torch.randn((ntraj, b.nc, 2), device=cuda, generator=gen)
             if b.ml > 2 else None for b in baths]
    force = K7.BathForce(baths, ntraj, WIDE_NPH, nmd, 0.4, cuda, t0=5)
    assert force.wide
    runs = []
    for i in range(3):
        rg = ring.clone()
        cur = torch.zeros((ntraj, 4, len(baths)), device=cuda)
        etot = torch.zeros((ntraj, 4), device=cuda)
        fbs = [torch.zeros((ntraj, b.nc), device=cuda) for b in baths]
        f = torch.zeros((ntraj, WIDE_NPH), device=cuda)
        if i:
            force.pred(p, q, pf, rg.clone(), 3, tails, cur.clone(),
                       etot.clone())
        before, wide = K7.launches, K7.launches_wide
        ph, qt = force.pred(p, q, pf, rg, 2, tails, cur, etot, fbs)
        pc, _ = force.corr(x, qt, pf, p, ph, tails, 2)
        pl, ql = force.corr(x, qt, pf, p, ph, tails, 2, mask=mask, f_out=f)
        torch.cuda.synchronize()
        assert K7.launches - before == K7.launches_wide - wide == 3
        runs.append([t.clone() for t in (ph, qt, pc, pl, ql, f, cur, etot,
                                          rg, *fbs)])
        assert bool(cur[:, 2].abs().sum() > 0)
    for again in runs[1:]:
        for k, (a, b) in enumerate(zip(runs[0], again)):
            assert torch.equal(a, b), k


def test_bath_force_wide_route_one_row_ring(cuda):
    """A memory bath of ml 2 on the slab's width read through a history
    ring of one row, whose head is also the push row: the wide route's
    CTAs would race there, so the predictor runs the tiled kernel (and
    agrees with the twin) while the correctors keep the wide route."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    ntraj, nmd = 5, 32
    baths = _k7_case(cuda, torch.float32, (("phonon", 2), ("phonon", 1)),
                     ntraj, WIDE_NPH, nmd, WIDE_SETS)
    gen = torch.Generator(device=cuda).manual_seed(4)
    p, q, pf = (torch.randn((ntraj, WIDE_NPH), device=cuda, generator=gen)
                for _ in range(3))
    ring = torch.randn((ntraj, 1, WIDE_NPH), device=cuda, generator=gen)
    force = K7.BathForce(baths, ntraj, WIDE_NPH, nmd, 0.4, cuda, t0=3)
    out = []
    for kernel in (True, False):
        rg = ring.clone()
        cur = torch.zeros((ntraj, 1, 2), device=cuda)
        etot = torch.zeros((ntraj, 1), device=cuda)
        if kernel:
            ph, qt = force.pred(p, q, pf, rg, 0, [None, None], cur, etot)
            torch.cuda.synchronize()
            assert force.wide and not force.wide_pred
        else:
            ph, qt = K7.pred_plain(p, q, pf, rg, 0, 0, force.ops,
                                   [None, None], 3, 0.4, cur[:, 0],
                                   etot[:, 0])
        out.append((ph, qt, cur, etot, rg))
    for a, b in zip(*out):
        assert _rel(a, b) < 1e-5


def test_bath_force_outputs_outlive_two_stages(cuda):
    """What a stage returns is still intact after the next two stages
    and after the next call of the same stage; the call after that
    reuses the buffer."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    nph, nmd, ntraj = 24, 32, 2
    baths = _k7_case(cuda, torch.float32, (("phonon", 2), ("electron",)),
                     ntraj, nph, nmd)
    gen = torch.Generator(device=cuda).manual_seed(1)
    p, q, pf = (torch.randn((ntraj, nph), device=cuda, generator=gen)
                for _ in range(3))
    mask = torch.ones(nph, device=cuda)
    ring = torch.randn((ntraj, 2, nph), device=cuda, generator=gen)
    cur = torch.zeros((ntraj, 1, 2), device=cuda)
    etot = torch.zeros((ntraj, 1), device=cuda)
    force = K7.BathForce(baths, ntraj, nph, nmd, 0.4, cuda, t0=3)
    tails = [None, None]

    def step(p, q):
        ph, qt = force.pred(p, q, pf, ring, 0, tails, cur, etot)
        pc, _ = force.corr(ph, qt, pf, p, ph, tails, 0)
        return (ph, qt), force.corr(pc, qt, pf, p, ph, tails, 0, mask=mask)

    (ph, qt), (p1, q1) = step(p, q)
    kept = [t.clone() for t in (ph, qt, p1, q1)]
    (ph2, _), (p2, q2) = step(p1, q1)
    torch.cuda.synchronize()
    for t, k in zip((ph, qt, p1, q1), kept):
        assert torch.equal(t, k)
    assert ph2.data_ptr() != ph.data_ptr() and p2.data_ptr() != p1.data_ptr()
    (ph3, _), _ = step(p2, q2)
    assert ph3.data_ptr() == ph.data_ptr()


@pytest.mark.parametrize("ntraj", [1, 3])
def test_run_segment_card_matches_cpu(cuda, ntraj):
    """The plain step with K6 and K7 on the card (float32) against the
    twins on the CPU (float64): every bath kind, a mask, all outputs."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import conv_tails as K6
    nph, nmd = 24, 32
    kinds = (("phonon", 12), ("local",), ("biased",), ("electron",))
    out = {}
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        baths = _k7_case(dev, dtype, kinds, ntraj, nph, nmd)
        baths = [b.replace(noise=0.02 * b.noise) for b in baths]
        mask = torch.ones(nph, dtype=dtype, device=dev)
        mask[[4, 19]] = 0.0
        system = TMD.GLESystem(
            dyn=chain_dynmat(nph, 0.05, dtype=dtype).to(dev),
            baths=tuple(baths), mask=mask, dt=0.4, nph=nph, ml=12, nmd=nmd,
            savep=True, saveq=True, savef=True)
        rng = np.random.default_rng(5)
        st = TMD.initial_state(system, ntraj, dtype=dtype).replace(
            p=torch.as_tensor(0.05 * rng.standard_normal((ntraj, nph)),
                              dtype=dtype, device=dev) * mask,
            phis=torch.as_tensor(0.05 * rng.standard_normal(
                (ntraj, 12, nph)), dtype=dtype, device=dev))
        k6, k7 = K6.launches, K7.launches
        fin, ys = TMD.run_segment(system, st, 80, t0=5)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert K6.launches == k6 + 80 and K7.launches == k7 + 240
        out[dev if dev == "cpu" else "cuda"] = (fin, ys)
    (fg, yg), (fc, yc) = out["cuda"], out["cpu"]
    for a, b in ((fg.p, fc.p), (fg.q, fc.q), (fg.phis, fc.phis),
                 (fg.qhis, fc.qhis)):
        assert _rel(a, b) < 1e-4
    for k in yc:
        assert _rel(yg[k], yc[k]) < 1e-4, k


# --- K5: the many-body C/H force ---------------------------------------------
# The yardstick is the autograd twin in float64 on the CPU; the float32
# twin itself is off by ~1e-5 (conv-scaled units) on a 50-angstrom junction,
# from the rounding of the coordinates, which the kernel does not share (it
# works on reference difference vectors). Errors are relative to the largest
# force of the batch, at displacements of thermal size.
def _k5_structures():
    import os
    from sclmd_tpu_torch.models.hydrocarbon import terminate_with_h
    from sclmd_tpu_torch.models.tersoff import graphene_ribbon
    npz = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "flagship_negf.npz"))
    return {
        "ribbon": lambda: terminate_with_h(
            [["C", *row] for row in graphene_ribbon(4, 3)]),
        "flagship": lambda: [[str(e)] + list(map(float, p))
                             for e, p in zip(npz["els"], npz["pos"])],
        # an isolated C-C bond: zeta = 0 on both of its table entries
        "dimer": lambda: [["C", 0.0, 0.0, 0.0], ["C", 1.45, 0.0, 0.0],
                          ["H", -0.6, 0.9, 0.0]],
    }


def _k5_pair(name, cuda, **kw):
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    axyz = _k5_structures()[name]()
    return (CHDriver(axyz, dtype=torch.float32, device=cuda, **kw),
            CHDriver(axyz, dtype=torch.float64, device="cpu", **kw))


@pytest.mark.parametrize("ntraj", [1, 37, 130])
@pytest.mark.parametrize("name", ["ribbon", "flagship", "dimer"])
def test_ch_force_matches_float64_twin(cuda, name, ntraj):
    """One trajectory, a ragged batch, more CTAs than one wave of a small
    card; energy on request; one launch per evaluation; bitwise repeats."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    drv, ref = _k5_pair(name, cuda)
    gen = torch.Generator(device=cuda).manual_seed(ntraj)
    q = 0.6 * torch.randn((ntraj, 3 * drv.number), device=cuda,
                          generator=gen)
    before = K5.launches
    e, f = drv.energy_force_torch(q)
    f2 = drv.force_torch(q)
    torch.cuda.synchronize()
    assert K5.launches == before + 2
    assert torch.equal(f, f2)
    ew, fw = ref.energy_force_torch(q.double().cpu())
    assert _rel(f, fw) < 1e-4
    assert _rel(e, ew) < 1e-5
    # the float32 twin on the card: the same function, its own rounding
    assert _rel(drv.kernel.plain(q), fw) < 2e-3
    # a single (nph,) vector goes through as a batch of one
    assert torch.equal(drv.force_torch(q[0]), f[0])


def test_ch_force_is_zero_at_rest_and_f0_is_the_kernels(cuda):
    drv, ref = _k5_pair("flagship", cuda)
    z = torch.zeros((3, 603), device=cuda)
    assert not drv.force_torch(z).any()
    assert drv.f0 is drv.kernel.cuda.f0
    assert _rel(drv.f0, ref.f0) < 1e-4
    assert _rel(drv.absforce(np.zeros(603)), ref.f0) < 1e-4


def test_ch_force_through_collinearity_and_cutoff(cuda):
    """Atoms pulled through the cutoff's switching zone (carbons moved by
    ~0.3 angstrom) against the float64 twin; and a wag term whose adjacent
    bonds are exactly collinear, against the kernel's formulas in numpy:
    finite, and the term gives exactly nothing."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.models.hydrocarbon import ch_energy
    drv, ref = _k5_pair("ribbon", cuda)
    rng = np.random.default_rng(2)
    q = 15.0 * rng.standard_normal((64, 3 * drv.number))
    f = drv.force_torch(torch.as_tensor(q, dtype=torch.float32, device=cuda))
    fw = ref.force_torch(torch.as_tensor(q))
    assert torch.isfinite(f).all()
    assert _rel(f, fw) < 1e-4

    axyz = [["C", 0.0, 0.0, 0.0], ["C", 1.4, 0.0, 0.0],
            ["C", -1.4, 0.0, 0.0], ["H", 0.0, 1.09, 0.0]]
    xyz = np.array([a[1:] for a in axyz], float).ravel()
    terms = ch_energy(axyz)[0].terms
    qc = np.zeros((2, 12))
    qc[:, 11] = 0.3                       # the H out of the plane
    qc[1, 4] = 0.2                        # second row: off collinearity
    got = []
    for oop in (np.array([[3, 0, 1, 2]]), np.zeros((0, 4), int)):
        pack = K5.pack_operands(dict(terms, oop=oop), xyz, np.ones(12))
        kern = K5.CHForceCuda(pack, cuda)
        f = kern(torch.as_tensor(qc, dtype=torch.float32, device=cuda))
        _, fn = K5.analytic_force_numpy(pack, qc, kern.f0.cpu().numpy())
        assert torch.isfinite(f).all()
        assert _rel(f, torch.as_tensor(fn)) < 1e-4
        got.append(f)
    assert torch.equal(got[0][0], got[1][0])
    assert not torch.equal(got[0][1], got[1][1])


def test_ch_force_lam3_branch(cuda):
    from sclmd_tpu_torch.models.tersoff import TERSOFF_PARAMS
    table = {"C": dict(TERSOFF_PARAMS["C"], lam3=0.6)}
    drv, ref = _k5_pair("ribbon", cuda, tersoff_params=table)
    q = torch.as_tensor(0.6 * np.random.default_rng(3).standard_normal(
        (5, 3 * drv.number)))
    assert _rel(drv.force_torch(q.float().to(cuda)),
                ref.force_torch(q)) < 1e-4


def test_ch_force_refuses_what_the_kernel_does_not_take(cuda):
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    drv, _ = _k5_pair("ribbon", cuda)
    n = 3 * drv.number
    with pytest.raises(TypeError):
        drv.force_torch(torch.zeros((2, n), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        drv.force_torch(torch.zeros((2, n + 3), device=cuda))
    f64 = CHDriver(_k5_structures()["ribbon"](), device=cuda)
    with pytest.raises(TypeError):
        f64.force_torch(torch.zeros((2, n), dtype=torch.float64,
                                    device=cuda))
    # more shared memory than one CTA has, where a launch asks for it:
    # refused before any launch
    before = K5.launches
    kern = K5.CHForceCuda(drv.kernel.cuda.pack, cuda)
    kern.pack = dict(kern.pack, nslots=60000)
    with pytest.raises(ValueError, match="shared memory"):
        kern._reshape(place="shared")(torch.zeros((2, n), device=cuda))
    assert K5.launches == before + 1      # kern's own f0


def _ribbon_cell():
    from sclmd_tpu_torch.models.hydrocarbon import terminate_with_h
    from sclmd_tpu_torch.models.tersoff import graphene_ribbon
    x0 = graphene_ribbon(3, 3)
    cell = np.array([x0[:, 0].max() + 1.42, 40.0, 20.0])
    return terminate_with_h([["C", *row] for row in x0], cell=cell), cell


def _check_k8_or_k5(drv, ref, cuda, counter, ntraj=37, amp=0.6, seed=0):
    """Against the float64 twin at displacements of ``amp``: forces,
    energy, bitwise repeat, exact zero at rest, one launch per call."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = amp * torch.randn((ntraj, 3 * drv.number), device=cuda,
                          generator=gen)
    before = getattr(K5, counter)
    e, f = drv.energy_force_torch(q)
    f2 = drv.force_torch(q)
    z = drv.force_torch(torch.zeros_like(q))
    torch.cuda.synchronize()
    assert getattr(K5, counter) == before + 3
    assert torch.equal(f, f2) and not z.any()
    ew, fw = ref.energy_force_torch(q.double().cpu())
    assert _rel(f, fw) < 1e-4
    assert _rel(e, ew) < 1e-5
    # (a perfect periodic sheet is at rest by symmetry: f0 is ~0 there,
    # so its error is taken against the largest force)
    scale = max(float(fw.abs().max()), float(ref.f0.abs().max()))
    assert float((drv.f0.double().cpu() - ref.f0).abs().max()) < \
        1e-4 * scale


def test_ch_force_periodic_cell(cuda):
    """CHDriver(cell=...) in float32 launches K5: the sheet closed along
    x, minimum images of every kind of slot."""
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    axyz, cell = _ribbon_cell()
    drv = CHDriver(axyz, cell=cell, dtype=torch.float32, device=cuda)
    ref = CHDriver(axyz, cell=cell, dtype=torch.float64, device="cpu")
    assert drv.kernel.cuda is not None
    assert (drv.kernel.cuda.pack["cell"] == cell).all()
    _check_k8_or_k5(drv, ref, cuda, "launches")


def test_ch_force_wide_rows(cuda):
    """A carbon table 20 wide (skin 2.5 angstrom): most entries sit
    outside the cutoff and give exact zeros."""
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    axyz = _k5_structures()["ribbon"]()
    drv = CHDriver(axyz, cutoff_skin=2.5, dtype=torch.float32, device=cuda)
    ref = CHDriver(axyz, cutoff_skin=2.5, dtype=torch.float64, device="cpu")
    assert drv.energy_fn.terms["nbr_c"].shape[1] > 16
    _check_k8_or_k5(drv, ref, cuda, "launches")


def test_ch_force_large_ribbon(cuda):
    """The reference's large C/H datapoint, a ribbon of 1,270 atoms: too
    large for shared memory, the kernel reads its constants and working
    regions from global memory; against float64, and a batch of 300
    (three groups to a CTA) gives the same bits per trajectory."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver, terminate_with_h
    from sclmd_tpu_torch.models.tersoff import graphene_ribbon
    axyz = terminate_with_h([["C", *row] for row in graphene_ribbon(90, 6)])
    drv = CHDriver(axyz, dtype=torch.float32, device=cuda)
    ref = CHDriver(axyz, dtype=torch.float64, device="cpu")
    kern = drv.kernel.cuda
    assert kern.pack["na"] == 1270 and kern.plan(1)["place"] == "global"
    _check_k8_or_k5(drv, ref, cuda, "launches", ntraj=5)
    q = 0.6 * torch.randn((300, 3 * 1270), device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(5))
    assert kern.plan(300)["tpc"] == 3
    assert torch.equal(drv.force_torch(q)[:5], drv.force_torch(q[:5]))
    # shared memory forced where it does not fit: refused before a launch
    before = K5.launches
    with pytest.raises(ValueError, match="shared memory"):
        K5.CHForceCuda(kern.pack, cuda)._reshape(place="work")(q[:5])
    assert K5.launches == before + 1      # the new wrapper's f0


def test_tersoff_force_large_sheet(cuda):
    """K8 on a periodic sheet of 400 carbons: the working region in
    shared memory, the constants read from global memory."""
    from sclmd_tpu_torch.models.tersoff import TersoffDriver
    from sclmd_tpu_torch.tools.sheet import sheet
    axyz, cell = sheet(20, 10)
    drv = TersoffDriver(axyz, cell=cell, dtype=torch.float32, device=cuda)
    ref = TersoffDriver(axyz, cell=cell, dtype=torch.float64, device="cpu")
    assert drv.kernel.cuda.plan(128)["place"] == "work"
    _check_k8_or_k5(drv, ref, cuda, "launches_tersoff", ntraj=130, amp=0.3)


@pytest.mark.parametrize("lam3", [0.0, 0.6])
def test_tersoff_force_periodic_sheet(cuda, lam3):
    """K8: a single-element TersoffDriver in float32 on the card, the
    periodic sheet with its lattice cell, the published set and one with
    the lam3 exponential on."""
    from sclmd_tpu_torch.models.tersoff import TERSOFF_PARAMS, TersoffDriver
    from sclmd_tpu_torch.tools.sheet import sheet
    axyz, cell = sheet(4, 3)
    table = {"C": dict(TERSOFF_PARAMS["C"], lam3=lam3)}
    drv = TersoffDriver(axyz, cell=cell, params=table, dtype=torch.float32,
                        device=cuda)
    ref = TersoffDriver(axyz, cell=cell, params=table, dtype=torch.float64,
                        device="cpu")
    assert drv.kernel.cuda.pack["kind"] == "tersoff"
    assert drv.f0 is drv.kernel.cuda.f0
    _check_k8_or_k5(drv, ref, cuda, "launches_tersoff", amp=0.3)


def test_tersoff_float64_and_multi_element_keep_autograd(cuda):
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.models.tersoff import TersoffDriver
    from sclmd_tpu_torch.tools.sheet import sheet
    axyz, cell = sheet(4, 3)
    before = K5.launches_tersoff
    for drv in (TersoffDriver(axyz, cell=cell, device=cuda),
                TersoffDriver([["Si", 0, 0, 0], ["C", 1.85, 0, 0]],
                              dtype=torch.float32, device=cuda)):
        assert drv.kernel is None
        f = drv.force_torch(torch.zeros((2, 3 * drv.number),
                                        dtype=drv.dtype, device=cuda))
        assert torch.isfinite(f).all()
    torch.cuda.synchronize()
    assert K5.launches_tersoff == before


@pytest.mark.parametrize("threads,tpc,place", [
    (64, 1, "shared"), (128, 3, "shared"), (256, 4, "shared"),
    (512, 2, "shared"), (256, 4, "work"), (1024, 1, "global"),
    (256, 4, "global")])
def test_ch_force_same_bits_at_every_launch_shape(cuda, threads, tpc, place):
    """Threads per trajectory, trajectories per CTA and where the
    constants and working regions live change which thread takes an item
    and which memory it reads, never an item's arithmetic or a sum's
    order: the force is the same to the bit (a ragged last CTA
    included), and exactly zero at rest against the default shape's
    f0."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    drv, _ = _k5_pair("flagship", cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = 0.6 * torch.randn((301, 603), device=cuda, generator=gen)
    other = K5.CHForceCuda(drv.kernel.cuda.pack, cuda)._reshape(
        threads=threads, tpc=tpc, place=place)
    assert other.plan(301)["place"] == place
    assert torch.equal(other(q), drv.force_torch(q))
    assert not other(torch.zeros_like(q)).any()


def test_ch_force_phase_stamps(cuda):
    """The traced launch: one launch, the same force, a positive cycle
    count for every phase."""
    from sclmd_tpu_torch.kernels import ch_force as K5
    drv, _ = _k5_pair("flagship", cuda)
    q = 0.6 * torch.randn((140, 603), device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(4))
    before = K5.launches
    cyc = drv.kernel.cuda.phase_cycles(q)
    assert K5.launches == before + 1
    assert list(cyc) == ["stage", "A", "B", "C", "D"]
    assert all(v > 0 for v in cyc.values())
    assert drv.kernel.cuda._args(140).trace is None


def test_run_segment_with_ch_driver_card_against_cpu(cuda):
    """64 plain steps of the many-body ribbon with two electron baths on
    the card (K5 twice a step, K7 three times) against float64 on the
    CPU."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import ch_force as K5
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    axyz = _k5_structures()["ribbon"]()
    nph, nmd, ntraj, nsteps = 3 * len(axyz), 64, 5, 64
    rng = np.random.default_rng(4)
    noises = [0.02 * rng.standard_normal((ntraj, nmd, 6)) for _ in range(2)]
    p0 = 0.05 * rng.standard_normal((ntraj, nph))
    out = []
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        drv = CHDriver(axyz, dtype=dtype, device=dev)
        baths = tuple(
            TB.ebath(cats, tb, 0.4, nmd, wmax=1.0, efric=np.eye(6) / 80.0,
                     dtype=dtype, device=dev, factorize=False).replace(
                noise=torch.as_tensor(nz, dtype=dtype, device=dev))
            for (cats, tb), nz in zip(((range(6), 330.0),
                                       (range(nph - 6, nph), 270.0)), noises))
        mask = torch.ones(nph, dtype=dtype, device=dev)
        mask[[9, 10, 11]] = 0.0
        system = TMD.GLESystem(dyn=None, baths=baths, mask=mask, dt=0.4,
                               nph=nph, ml=1, nmd=nmd,
                               force_fn=drv.force_torch)
        st = TMD.initial_state(system, ntraj).replace(
            p=torch.as_tensor(p0, dtype=dtype, device=dev) * mask)
        k5, k7 = K5.launches, K7.launches
        fin, ys = TMD.run_segment(system, st, nsteps)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert K5.launches == k5 + 2 * nsteps
            assert K7.launches == k7 + 3 * nsteps
        out.append((fin.p, fin.q, ys["cur"], ys["etot"]))
    for a, b in zip(*out):
        assert _rel(a, b) < 1e-4


# --- the plain step replayed as a CUDA graph (kernels.step_graph) -----------
def _graph_against_eager(monkeypatch, system, st, nsteps, t0, per_step):
    """``run_segment`` graphed and eagerly on the same inputs: the same
    bits in every output and in the final state, and each launch
    counter's change (``per_step``: kernel -> launches a step) equal to
    the kernels run, as ``steps_graphed`` and ``graph_captures`` are."""
    from sclmd_tpu_torch.kernels import step_graph as SG
    from sclmd_tpu_torch.utils import profiling as P
    runs = []
    for graphed in (True, False):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(TMD, "graph_plan", lambda system, state, n:
                          (n, 0, 0))
            before = P.counters()
            fin, ys = TMD.run_segment(system, st, nsteps, t0=t0)
            torch.cuda.synchronize()
            after = P.counters()
        runs.append((fin, ys, {k: v - before[k] for k, v in after.items()}))
    (fg, yg, cg), (fe, ye, ce) = runs
    for k in ("t", "p", "q", "phis", "qhis"):
        assert torch.equal(getattr(fg, k), getattr(fe, k)), k
    assert set(yg) == set(ye)
    for k in ye:
        assert torch.equal(yg[k], ye[k]), k
    _, replays, _ = SG.group_plan(nsteps)
    assert replays >= 2
    assert cg["steps_graphed"] == replays * SG.GRAPH_STEPS
    assert cg["graph_captures"] == 1
    assert ce["steps_graphed"] == ce["graph_captures"] == 0
    for name, n in per_step.items():
        assert cg[name] == ce[name] == n * nsteps, name
    return yg


def test_run_segment_graph_matches_eager_chain(cuda, monkeypatch):
    """One chain trajectory, ``ps`` and ``qs`` written by K7: from t0 =
    120 of nmd 128 (the noise rows wrap), more steps than twice the ring
    of 40 rows, whole groups and a remainder; a segment with no whole
    group after its first step runs eagerly."""
    from sclmd_tpu_torch.kernels import step_graph as SG
    from sclmd_tpu_torch.utils import profiling as P
    G = SG.GRAPH_STEPS
    system = _system(cuda, torch.float32, 1).replace(savep=True, saveq=True)
    rng = np.random.default_rng(8)
    st = TMD.initial_state(system, 1, dtype=torch.float32).replace(
        p=torch.as_tensor(0.05 * rng.standard_normal((1, 36)),
                          dtype=torch.float32, device=cuda),
        phis=torch.as_tensor(0.05 * rng.standard_normal((1, 40, 36)),
                             dtype=torch.float32, device=cuda))
    nsteps = 1 + G * -(-90 // G) + 3
    ys = _graph_against_eager(monkeypatch, system, st, nsteps, 120,
                              {"launches.K6": 1, "launches.K7": 3})
    assert bool(torch.isfinite(ys["ps"]).all())
    assert not torch.equal(ys["ps"][:, 1], ys["ps"][:, 2])
    before = P.counters()["graph_captures"]
    TMD.run_segment(system, st, G, t0=3)
    assert P.counters()["graph_captures"] == before


def test_run_segment_graph_matches_eager_ch_flagship(cuda, monkeypatch,
                                                     tmp_path):
    """The many-body C/H flagship (K5 twice a step, K7 three times, two
    electron baths, a constraint) at 64 trajectories over two whole
    groups and three steps."""
    from sclmd_tpu_torch.kernels import step_graph as SG
    from sclmd_tpu_torch.tools import flagship as F
    r = F.flagship_runner(torch.float32, cuda, str(tmp_path), nmd=256,
                          many_body=True)
    system = r._build_system()
    gen = torch.Generator(device=cuda).manual_seed(64)
    system = system.replace(baths=tuple(
        b.replace(noise=0.01 * torch.randn((64, 256, b.nc), device=cuda,
                                           generator=gen))
        for b in system.baths))
    st = TMD.initial_state(system, 64).replace(
        p=0.02 * torch.randn((64, system.nph), device=cuda, generator=gen)
        * system.mask)
    _graph_against_eager(monkeypatch, system, st, 2 * SG.GRAPH_STEPS + 3,
                         250, {"launches.K5": 2, "launches.K7": 3})


def _slab_system(cuda, tmp_path, cells, kind="sw", ntraj=64, nmd=256):
    """A slab of ``tools.slab`` cut to ``cells``: silicon (``kind`` "sw",
    K9 twice a step) or gold ("eam" or "eam_tab", K10 twice a step), K7
    three times; its baths' noise and a start drawn here."""
    from sclmd_tpu_torch.tools import slab as SL
    r = SL.slab_runner(kind, torch.float32, cuda, str(tmp_path), cells=cells,
                       nmd=nmd)
    system = r._build_system()
    gen = torch.Generator(device=cuda).manual_seed(ntraj)
    system = system.replace(baths=tuple(
        b.replace(noise=0.01 * torch.randn((ntraj, nmd, b.nc), device=cuda,
                                           generator=gen))
        for b in system.baths))
    st = TMD.initial_state(system, ntraj).replace(
        p=0.02 * torch.randn((ntraj, system.nph), device=cuda, generator=gen)
        * system.mask)
    return system, st


@pytest.mark.parametrize("cells", [(4, 2, 2), (12, 6, 6)])
def test_run_segment_graph_matches_eager_sw_slab(cuda, monkeypatch, tmp_path,
                                                 cells):
    """The silicon slab (``SWDriver``, marked capturable) at 64
    trajectories over two whole groups and three steps: cut to 4 x 2 x 2
    cells (K7 staged) and whole (nph 10,368: every K7 launch on its
    unstaged route)."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import step_graph as SG
    system, st = _slab_system(cuda, tmp_path, cells)
    wide = K7.launches_wide
    nsteps = 2 * SG.GRAPH_STEPS + 3
    _graph_against_eager(monkeypatch, system, st, nsteps, 250,
                         {"launches.K9": 2, "launches.K7": 3})
    assert (K7.launches_wide - wide == 2 * 3 * nsteps) == \
        (cells == (12, 6, 6))


def test_sw_slab_replay_runs_the_kernels_counted(cuda, tmp_path):
    """Under replay the profiler sees each of K9's three kernels once an
    evaluation the program counts (``launches.K9``), and K7's kernel once
    a launch counted: what the benchmark's K9 and K7 rooflines compare."""
    from sclmd_tpu_torch.kernels import step_graph as SG
    from sclmd_tpu_torch.utils import profiling as P
    system, st = _slab_system(cuda, tmp_path, (4, 2, 2))
    nsteps = 3 * SG.GRAPH_STEPS + 1
    TMD.run_segment(system, st, nsteps, t0=0)          # scratch, capture
    torch.cuda.synchronize()
    before = P.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        TMD.run_segment(system, st, nsteps, t0=0)
        torch.cuda.synchronize()
    after = P.counters()
    assert after["steps_graphed"] - before["steps_graphed"] == \
        3 * SG.GRAPH_STEPS
    k9 = after["launches.K9"] - before["launches.K9"]
    k7 = after["launches.K7"] - before["launches.K7"]
    assert k9 == 2 * nsteps and k7 == 3 * nsteps
    import json
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "kernel"]
    seen = {}
    for k in ("slot_transpose_kernel", "sw_centre_kernel",
              "slot_gather_kernel", "bath_force_kernel"):
        seen[k] = sum(k in n for n in names)
    assert seen == {"slot_transpose_kernel": k9, "sw_centre_kernel": k9,
                    "slot_gather_kernel": k9, "bath_force_kernel": k7}


@pytest.mark.parametrize("cells,ntraj", [((4, 3, 3), 16), ((12, 6, 6), 4)])
def test_run_segment_graph_matches_eager_dp_slab(cuda, monkeypatch, tmp_path,
                                                 cells, ntraj):
    """The silicon slab under the DeepPot-SE network at DeePMD-kit's
    widths overlaid on Stillinger-Weber (``deepmddriver``, capturable as
    its baseline ``SWDriver`` is: the network's autograd twice a step
    with K9) over two whole groups and three steps: cut to 4 x 3 x 3
    cells at 16 trajectories and whole at 4. The autograd's scatter of
    the table's gradient sorts its indices (no float atomics), so the
    replay gives the eager steps' bits."""
    from sclmd_tpu_torch.kernels import step_graph as SG
    system, st = _slab_system(cuda, tmp_path, cells, kind="si_dp",
                              ntraj=ntraj)
    _graph_against_eager(monkeypatch, system, st, 2 * SG.GRAPH_STEPS + 3,
                         250, {"launches.DP": 2, "launches.K9": 2,
                               "launches.K7": 3})


def test_dp_slab_replay_runs_the_kernels_counted(cuda, tmp_path):
    """Under replay the profiler sees the network's kernels of the
    benchmark's work file (``benchmarks/work/DP.py``: ``KERNELS``, one
    ``COUNTERS`` entry each of an evaluation's) as many times as the
    program counts evaluations (``launches.DP``) times the kernels of
    one: what ``DP_roofline`` compares."""
    import json

    from benchmarks import spec
    from sclmd_tpu_torch.kernels import step_graph as SG
    from sclmd_tpu_torch.utils import profiling as P
    DP = spec.work("DP")
    assert DP.KERNELS and len(DP.COUNTERS) >= len(DP.KERNELS)
    system, st = _slab_system(cuda, tmp_path, (4, 3, 3), kind="si_dp",
                              ntraj=4)
    nsteps = 3 * SG.GRAPH_STEPS + 1
    TMD.run_segment(system, st, nsteps, t0=0)          # capture once
    torch.cuda.synchronize()
    before = P.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        TMD.run_segment(system, st, nsteps, t0=0)
        torch.cuda.synchronize()
    after = P.counters()
    assert after["steps_graphed"] - before["steps_graphed"] == \
        3 * SG.GRAPH_STEPS
    dp = after["launches.DP"] - before["launches.DP"]
    assert dp == 2 * nsteps
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "kernel"]
    seen = sum(any(k in n for k in DP.KERNELS) for n in names)
    assert seen == len(DP.COUNTERS) * dp


def _dp_operands(cuda, lead, na, nn, h, e, ntypes, seed):
    """K13's operands in float32 on the card: activations of a tanh, rows
    R with two padding entries an atom, weights at 1/sqrt(fan_in)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, device=cuda, generator=gen)

    h2 = torch.tanh(rnd(*lead, na, nn, h))
    R = 0.3 * rnd(*lead, na, nn, 4)
    R[..., -2:, :] = 0.0
    w3 = [rnd(h, e) / h ** 0.5 for _ in range(ntypes)]
    b3 = [0.1 * rnd(e) for _ in range(ntypes)]
    ntype = None if ntypes == 1 else torch.randint(
        0, ntypes, (na, nn), device=cuda, generator=gen, dtype=torch.int32)
    dD = rnd(*lead, na, e * 16) if e >= 16 else None
    return h2, R, w3, b3, ntype, dD


def _dp_run(h2, R, w3, b3, ntype, naxis, dD, twin=False):
    """D and its gradients to h2 and R: K13, or the plain twin."""
    from sclmd_tpu_torch.kernels import dp_descriptor as K13
    a, b = h2.clone().requires_grad_(), R.clone().requires_grad_()
    fn = K13.descriptor_plain if twin else K13.descriptor
    D = fn(a, b, w3, b3, ntype, naxis)
    D.backward(dD)
    return [D.detach(), a.grad, b.grad]


@pytest.mark.parametrize("ntypes,lead,na", [(1, (4,), 3456), (2, (3,), 300),
                                            (3, (2,), 200), (4, (2,), 200)])
def test_dp_descriptor_against_twin(cuda, ntypes, lead, na):
    """K13 at the silicon slab's shapes (4 trajectories of 3,456 atoms, 48
    entries; DeePMD-kit's widths h 50, E 100, 16 axis columns) and at two
    to four neighbour types, forward and both gradients, against the
    plain twin in float64 on the same float32 operands. Tolerance 5e-6
    of the largest value: float32 sums of 48 entries, then of 50 and of
    116 columns, in another order than the twin's (each rounding 6e-8 of
    its running sum); the kernel's largest error here is reported (on an
    H100 at most 6.7e-7, at four types' D)."""
    from sclmd_tpu_torch.kernels import dp_descriptor as K13
    h2, R, w3, b3, ntype, dD = _dp_operands(cuda, lead, na, 48, 50, 100,
                                            ntypes, 7)
    before = K13.launches
    got = _dp_run(h2, R, w3, b3, ntype, 16, dD)
    torch.cuda.synchronize()
    assert K13.launches == before + 1
    f64 = [t.double() for t in (h2, R)]
    want = _dp_run(*f64, [w.double() for w in w3],
                   [b.double() for b in b3], ntype, 16, dD.double(),
                   twin=True)
    for name, g, w in zip(("D", "dh2", "dR"), got, want):
        err = float((g.double() - w).abs().max() / w.abs().max())
        print(f"K13 {name} ntypes {ntypes}: largest error {err:.3e} of "
              "the largest value")
        assert err <= 5e-6, name
    # a padding entry's activation takes an exact zero
    assert torch.equal(got[1][..., -2:, :],
                       torch.zeros_like(got[1][..., -2:, :]))


@pytest.mark.parametrize("h,e,naxis,ntypes", [(65, 100, 16, 1),
                                             (50, 129, 16, 1),
                                             (50, 100, 36, 1),
                                             (50, 100, 18, 1),
                                             (50, 100, 16, 5)])
def test_dp_descriptor_refuses_what_it_cannot_run(cuda, h, e, naxis, ntypes):
    """Widths beyond the kernel's (h 64, E 128, 32 axis columns in fours)
    and more than four types raise on the card; no twin takes over."""
    from sclmd_tpu_torch.kernels import dp_descriptor as K13
    h2, R, w3, b3, ntype, _ = _dp_operands(cuda, (1,), 8, 6, h, e, ntypes,
                                           1)
    before = K13.launches
    with pytest.raises(RuntimeError, match="dp_descriptor"):
        K13.descriptor(h2, R, w3, b3, ntype, naxis)
    assert K13.launches == before


def test_dp_descriptor_launches_give_the_same_bits(cuda):
    """Two launches of K13's forward and gradient on the same operands give
    the same bits (fixed orders, no atomics)."""
    h2, R, w3, b3, _, dD = _dp_operands(cuda, (4,), 3456, 48, 50, 100, 1, 3)
    one = _dp_run(h2, R, w3, b3, None, 16, dD)
    two = _dp_run(h2, R, w3, b3, None, 16, dD)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_dp_slab_counts_the_descriptor_with_each_evaluation(cuda, tmp_path):
    """On the silicon slab under the network every evaluation the program
    counts (``launches.DP``) took its descriptor through K13
    (``launches.DP_desc``), eagerly and under replay."""
    from sclmd_tpu_torch.kernels import step_graph as SG
    from sclmd_tpu_torch.utils import profiling as P
    system, st = _slab_system(cuda, tmp_path, (4, 3, 3), kind="si_dp",
                              ntraj=4)
    before = P.counters()
    TMD.run_segment(system, st, 2 * SG.GRAPH_STEPS + 1, t0=0)
    torch.cuda.synchronize()
    after = P.counters()
    dp = after["launches.DP"] - before["launches.DP"]
    assert dp == 2 * (2 * SG.GRAPH_STEPS + 1)
    assert after["launches.DP_desc"] - before["launches.DP_desc"] == dp
    assert after["steps_graphed"] - before["steps_graphed"] > 0


@pytest.mark.parametrize("route", ["sym", "general"])
@pytest.mark.parametrize("kind", ["eam", "eam_tab"])
@pytest.mark.parametrize("cells", [(4, 4, 4), (12, 6, 6)])
def test_run_segment_graph_matches_eager_eam_slab(cuda, monkeypatch,
                                                  tmp_path, cells, kind,
                                                  route):
    """The gold slab (``EAMDriver``, marked capturable) at 64
    trajectories over two whole groups and three steps, K10 analytic and
    tabulated, on its symmetric route and with the general route forced
    (the table's check answering no): cut to 4 x 4 x 4 cells and whole
    (nph 5,184: K7 still staged, no launch on its wide route)."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.kernels import eam_force as K10
    from sclmd_tpu_torch.kernels import step_graph as SG
    with monkeypatch.context() as m:
        if route == "general":
            m.setattr(K10, "symmetric_table", lambda pack: False)
        system, st = _slab_system(cuda, tmp_path, cells, kind=kind)
    wide = K7.launches_wide
    _graph_against_eager(monkeypatch, system, st, 2 * SG.GRAPH_STEPS + 3,
                         250, {"launches.K10": 2, "launches.K7": 3,
                               "launches.K10_sym": 2 if route == "sym"
                               else 0})
    assert K7.launches_wide == wide


def test_eam_slab_replay_runs_the_kernels_counted(cuda, tmp_path):
    """Under replay the profiler sees K10's three kernels once each an
    evaluation the program counts (``launches.K10``, all of them on the
    symmetric route, ``launches.K10_sym``): the transpose and the two
    passes whose names hold ``eam_centre_kernel``, and no gather; and
    K7's kernel once a launch counted: what the benchmark's K10 and K7
    rooflines compare."""
    from sclmd_tpu_torch.kernels import step_graph as SG
    from sclmd_tpu_torch.utils import profiling as P
    system, st = _slab_system(cuda, tmp_path, (4, 4, 4), kind="eam")
    nsteps = 3 * SG.GRAPH_STEPS + 1
    TMD.run_segment(system, st, nsteps, t0=0)          # scratch, capture
    torch.cuda.synchronize()
    before = P.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        TMD.run_segment(system, st, nsteps, t0=0)
        torch.cuda.synchronize()
    after = P.counters()
    assert after["steps_graphed"] - before["steps_graphed"] == \
        3 * SG.GRAPH_STEPS
    k10 = after["launches.K10"] - before["launches.K10"]
    k7 = after["launches.K7"] - before["launches.K7"]
    assert k10 == 2 * nsteps and k7 == 3 * nsteps
    assert after["launches.K10_sym"] - before["launches.K10_sym"] == k10
    import json
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "kernel"]
    seen = {}
    for k in ("slot_transpose_kernel", "eam_centre_kernel",
              "eam_centre_kernel_rho", "eam_centre_kernel_force",
              "slot_gather_kernel", "bath_force_kernel"):
        seen[k] = sum(k in n for n in names)
    assert seen == {"slot_transpose_kernel": k10,
                    "eam_centre_kernel": 2 * k10,
                    "eam_centre_kernel_rho": k10,
                    "eam_centre_kernel_force": k10,
                    "slot_gather_kernel": 0, "bath_force_kernel": k7}
    assert seen["slot_transpose_kernel"] + seen["eam_centre_kernel"] + \
        seen["slot_gather_kernel"] == 3 * k10


def test_flagship_ensemble_files_behind_the_card(cuda, tmp_path):
    """The many-body flagship's ensemble of 64 in two chunks on the card:
    chunk 0's kappa files come from the writer thread (``files_behind``,
    two baths a trajectory; the sums read back through pinned memory and
    an event) with the bytes and means of the same chunks run
    synchronously (``checkpoint=True``), and the means of one chunk to
    float32 rounding (the kernels' launch shapes follow the chunk)."""
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.utils import profiling as P
    got = {}
    for chunk, checkpoint in ((64, False), (32, True), (32, False)):
        d = tmp_path / f"c{chunk}{checkpoint}"
        d.mkdir()
        r = F.flagship_runner(torch.float32, cuda, str(d), nmd=256,
                              many_body=True)
        means = r.RunEnsemble(64, chunk=chunk, checkpoint=checkpoint)
        got[chunk, checkpoint] = (
            means, {p.name: p.read_bytes() for p in d.glob("kappa.*.dat")},
            P.reports()[-1].counters)
    (m1, _, c1), (ms, fs, cs), (m2, f2, c2) = got.values()
    assert np.isfinite(m2).all() and np.array_equal(m2, ms)
    assert len(f2) == 128 and f2 == fs
    assert (c1["files_behind"], cs["files_behind"], c2["files_behind"]) \
        == (0, 0, 64)
    assert c2["files"] == 128
    np.testing.assert_allclose(m2, m1, rtol=0, atol=1e-4 * abs(m1).max())

# --- K3 and K3b: noise synthesis with the in-kernel Philox draw -------------
def _noise_factors(kind, nc, nmd, device, seed=0):
    """Complex64 factors of a random PSD: one matrix (``prop``, nc >= 8)
    or the per-frequency batch, and float32 std, as ``Factors`` (with
    K3's packed operand)."""
    from sclmd_tpu_torch.kernels.noise_synth import Factors
    from sclmd_tpu_torch.ops import noise as TN
    rng = np.random.default_rng(seed)
    h = nmd // 2 + 1
    if kind == "prop":
        m = rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc))
        psd = (np.abs(rng.normal(size=h)) + 0.1)[:, None, None] * \
            (m @ m.conj().T + nc * np.eye(nc))[None]
    else:
        psd = np.stack([(lambda m: m @ m.conj().T + nc * np.eye(nc))(
            rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc)))
            for _ in range(h)])
    ev, std = TN.noise_factors(psd, dtype=np.float32)
    return Factors(torch.as_tensor(TN.factor_matrix(ev), device=device),
                   torch.as_tensor(std, device=device))


@pytest.mark.parametrize("kind,nc,nmd", [
    ("prop", 150, 256), ("batch", 150, 64), ("prop", 90, 128),
    ("batch", 90, 128), ("prop", 48, 128), ("batch", 48, 64),
    ("prop", 37, 128), ("batch", 37, 64), ("batch", 5, 64),
    ("prop", 200, 64), ("batch", 200, 32)])
@pytest.mark.parametrize("lo,hi", [(0, 1), (3, 40), (0, 130)])
def test_noise_synth_matches_twin(cuda, kind, nc, nmd, lo, hi):
    """K3 against its twin (the same Philox integers, float64 Box-Muller
    and product, on the card), both paths: the flagship's width (nc 150),
    the primary's (90), the sheet's (48), widths that are not a multiple
    of 8 (37, 5: padded), and nc 200, whose U does not fit in shared
    memory beside the draws (read from global memory); windows that leave
    a tile ragged. The half spectrum within 1e-5 of its largest value, the
    scaled draw within 1e-6, the edge rows real."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    fac = _noise_factors(kind, nc, nmd, cuda)
    ev, std = fac
    plan = K3.launch_plan(nc, hi - lo, nmd // 2 + 1, kind == "batch", 132)
    assert plan["a_smem"] == (nc <= 152)
    scale = 1.0 / (nmd * 0.38)
    before = K3.launches
    got = K3.noise_halfspectrum(ev, std, 7, 1, lo, hi, scale,
                                packed=fac.packed)
    draw = K3.noise_halfspectrum_cuda(ev, std, 7, 1, lo, hi, draw_only=True)
    torch.cuda.synchronize()
    assert K3.launches == before + 2
    assert got.shape == (hi - lo, nc, nmd // 2 + 1)
    want_draw = K3.draw_plain(std.double(), 7, 1, lo, hi)
    assert _rel(draw, want_draw) < 1e-6
    want = K3.halfspectrum_plain(ev.to(torch.complex128), std.double(), 7, 1,
                                 lo, hi, scale)
    assert _rel(got, want) < 1e-5
    assert not got[..., 0].imag.any() and not got[..., -1].imag.any()
    again = K3.noise_halfspectrum(ev, std, 7, 1, lo, hi, scale)
    assert torch.equal(got, again)       # packed here or by Factors


@pytest.mark.parametrize("kind,nc", [("batch", 90), ("prop", 150),
                                     ("prop", 37), ("prop", 48),
                                     ("batch", 48), ("prop", 200)])
def test_noise_synth_same_bits_at_every_launch_shape(cuda, kind, nc):
    """Only the work-to-warp map changes with the launch shape: fewer
    consumer warps (each walking several m-tiles) and a grid of other
    sizes write the same bits; a window of a chunk is bitwise the chunk's
    columns."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    fac = _noise_factors(kind, nc, 128, cuda)
    ev, std = fac
    ref = K3.noise_halfspectrum(ev, std, 3, 0, 0, 70, packed=fac.packed)
    plan = K3.launch_plan(nc, 70, 65, kind == "batch", 132)
    shapes = 0
    for cw in sorted({1, 3, plan["cw"]}):
        p = K3.launch_plan(nc, 70, 65, kind == "batch", 132, cw=cw)
        for grid in {p["grid"], 7} if kind == "prop" else {p["grid"]}:
            got = K3.noise_halfspectrum_cuda(ev, std, 3, 0, 0, 70,
                                             plan=dict(p, grid=grid),
                                             packed=fac.packed)
            assert torch.equal(got, ref), (cw, grid)
            shapes += 1
    assert shapes >= 3
    assert torch.equal(K3.noise_halfspectrum(ev, std, 3, 0, 20, 33,
                                             packed=fac.packed),
                       ref[20:33])


@pytest.mark.parametrize("kind,nc", [("prop", 150), ("batch", 37)])
def test_noise_series_chunk_invariant(cuda, kind, nc):
    """A trajectory's series (K3, then the C2R plan and the permute) is
    bitwise the same from a chunk of 256 and one of 64, and across two
    calls."""
    from sclmd_tpu_torch.ops.noise import schedule_noise
    fac = _noise_factors(kind, nc, 1024 if kind == "prop" else 256, cuda)
    ev, std = fac
    nmd = 2 * (std.shape[0] - 1)
    a = schedule_noise(ev, std, 9, 1, 0, 256, 0.38, nmd, packed=fac.packed)
    b = schedule_noise(ev, std, 9, 1, 192, 256, 0.38, nmd, packed=fac.packed)
    assert a.shape == (256, nmd, nc) and a.is_contiguous()
    assert torch.equal(a[192:], b)
    assert torch.equal(a, schedule_noise(ev, std, 9, 1, 0, 256, 0.38, nmd))


@pytest.mark.parametrize("shape", [(3, 150, 1024), (2, 5, 90, 2048),
                                   (70000, 3, 5), (1, 37, 33)])
def test_noise_transpose_matches_twin(cuda, shape):
    """The series' layout kernel: bitwise the twin's transpose, ragged
    32 x 32 tiles and more matrices than one grid's z extent."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    x = torch.randn(shape, device=cuda)
    before = K3.launches_transpose
    got = K3.transpose(x)
    assert K3.launches_transpose > before
    assert torch.equal(got, K3.transpose_plain(x))


def test_init_draw_matches_twin_bitwise(cuda):
    """K3b's uniforms are exact functions of the Philox words (bitwise);
    its amplitudes agree with the twin's to float32 rounding, and the
    runner's start (one launch, one product) with ``thermal_init`` on the
    same uniforms."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.ops import philox
    before = K3.launches_init
    got = K3.init_uniforms_cuda(11, 2, 5, 1029, 603, cuda, torch.float32)
    assert K3.launches_init == before + 1
    want = philox.uniforms(11, 2, 5, 1029, 603)
    assert torch.equal(got.cpu(), want)
    r = TMD.md(0.5, 64, 300.0, dyn=chain_dynmat(36, 0.05).numpy(),
               dtype=torch.float32, device=cuda)
    st = r._thermal_start(r.T)
    amps = K3.thermal_amplitudes(11, 2, 5, 1029, st.am, st.hw)
    assert K3.launches_init == before + 2 and amps.shape == (2, 1024, 36)
    ref = K3.thermal_amplitudes_plain(11, 2, 5, 1029, st.am.double().cpu(),
                                      st.hw.double().cpu())
    assert _rel(amps, ref) < 1e-6
    system = r._build_system()
    s1 = st.states(system, 11, 2, 5, 1029)
    s0 = TMD.thermal_init(philox.uniforms(11, 2, 5, 1029, 36).to(cuda),
                          system, r.hw, r.U, r.T)
    assert _rel(s1.p, s0.p) < 1e-5 and _rel(s1.q, s0.q) < 1e-5


def test_noise_synth_refuses_float64(cuda):
    from sclmd_tpu_torch.kernels import noise_synth as K3
    ev, std = _noise_factors("batch", 5, 32, cuda)
    with pytest.raises(TypeError, match="float64"):
        K3.noise_halfspectrum(ev.to(torch.complex128), std.double(), 1, 0,
                              0, 4)
    with pytest.raises(TypeError, match="float64"):
        K3.init_uniforms_cuda(1, 2, 0, 4, 9, cuda, torch.float64)
    am = torch.ones(9, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float64"):
        K3.thermal_amplitudes(1, 2, 0, 4, am, am)
    with pytest.raises(TypeError, match="float64"):
        K3.c2r_series(torch.zeros((17, 2, 3), dtype=torch.complex128,
                                  device=cuda), 32)


@pytest.mark.parametrize("kind,nc", [("batch", 90), ("prop", 150),
                                     ("prop", 37)])
def test_noise_series_is_the_mirrored_spectrums_transform(cuda, kind, nc):
    """K3 and the C2R stage give the real part of the forward FFT of the
    mirrored spectrum (the reference's definition), complex eigenvectors
    included: the edge rows' imaginary parts must not reach the series."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    from sclmd_tpu_torch.ops import noise as TN
    from sclmd_tpu_torch.ops.functions import fourier_w2t
    nmd, dt = 256, 0.38
    ev, std = _noise_factors(kind, nc, nmd, cuda, seed=4)
    got = TN.schedule_noise(ev, std, 2, 0, 0, 16, dt, nmd)
    xi = TN.halfspectrum_from_draw(K3.draw_plain(std.double(), 2, 0, 0, 16),
                                   ev.to(torch.complex128))
    want = torch.real(fourier_w2t(TN.mirror_halfspectrum(xi, nmd), dt,
                                  dim=-2))
    assert _rel(got, want) < 1e-5


def test_c2r_series_leaves_its_input_and_neighbours(cuda):
    """cuFFT's C2R uses its input as scratch: the public call runs on a
    copy, so a view into a larger tensor and the memory past its end stay
    as they were; only K3's own buffer, given up with ``consume``, is
    transformed in place, to the same bits."""
    from sclmd_tpu_torch.kernels import noise_synth as K3
    nmd, nc = 256, 5
    h = nmd // 2 + 1
    big = torch.randn((40, nc, h), dtype=torch.complex64, device=cuda)
    big[..., 0].imag.zero_()
    big[..., -1].imag.zero_()
    keep = big.clone()
    y = big[3:7]                      # storage runs on past the view
    got = K3.c2r_series(y, nmd)
    assert torch.equal(big, keep)
    assert _rel(got, K3.c2r_plain(keep[3:7].cpu(), nmd).to(cuda)) < 1e-5
    buf = K3.spectrum_buffer(y.shape, cuda).copy_(y)
    assert torch.equal(K3.c2r_series(buf, nmd, consume=True), got)
    assert torch.equal(K3.c2r_series(y, nmd, consume=True), got)
    assert torch.equal(big, keep)     # a view is never taken as scratch


# --- K9 (Stillinger-Weber) and K10 (EAM) -------------------------------------
def _slot_pair(kind, cuda, **kw):
    """A driver of ``kind`` in float32 on the card (its kernel) and its
    float64 twin on the CPU: "si" a periodic diamond cell, "si_open" an
    open one, "au"/"au_tab" a periodic fcc cell (analytic, tabulated),
    "alloy" a two-element setfl table on it."""
    from sclmd_tpu_torch.models import eam as E
    from sclmd_tpu_torch.models import sw as S
    if kind.startswith("si"):
        pos, cell = S.diamond_cell(3, 2, 2)
        axyz = [["Si", *p] for p in pos]
        kw.setdefault("cell", None if kind == "si_open" else cell)
        make = S.SWDriver
    else:
        pos, cell = E.fcc_cell(3, 3, 3, 4.08)
        els = ["Au", "Ag"] if kind == "alloy" else ["Au"]
        axyz = [[els[i % len(els)], *p] for i, p in enumerate(pos)]
        kw.setdefault("cell", cell)
        if kind == "au":
            kw.setdefault("rcut", 5.5)
        else:
            kw["setfl"] = _alloy_table(els)
        make = E.EAMDriver
    return (make(axyz, dtype=torch.float32, device=cuda, **kw),
            make(axyz, dtype=torch.float64, device="cpu", **kw))


def _alloy_table(els):
    """A setfl dict of the Sutton-Chen sets of ``els`` (cutoff 5.5) on one
    grid, the cross pair the mean of the two."""
    from sclmd_tpu_torch.models import eam as E
    tabs = [E.sutton_chen_tables(e, rcut=5.5, rho_max=600.0) for e in els]
    rphi = [tabs[0]["rphi"][0]]
    if len(els) == 2:
        rphi += [0.5 * (tabs[0]["rphi"][0] + tabs[1]["rphi"][0]),
                 tabs[1]["rphi"][0]]
    t = dict(tabs[0])
    t.update(elements=list(els), mass=np.zeros(len(els)),
             F=np.concatenate([x["F"] for x in tabs]),
             rho=np.concatenate([x["rho"] for x in tabs]),
             rphi=np.stack(rphi),
             pair_index=np.array([[0, 1], [1, 2]] if len(els) == 2
                                 else [[0]], np.int32))
    return t


_SI_REAL = dict(p=4.5, q=0.25, A=7.049556277, B=0.6022245584,
                sigma=2.0951, a=1.80, lam=21.0, gam=1.20,
                costheta0=-1.0 / 3.0, eps=2.1683)
_AU_REAL = dict(eps=7.8052e-3, a=4.08, c=34.408, n=10.5, m=7.75)


@pytest.mark.parametrize("kind,kw", [
    ("si", {}), ("si_open", {}), ("si", dict(max_nnei=10)),
    ("si", dict(params=_SI_REAL)),
    ("au", {}), ("au", dict(max_nnei=30)), ("au", dict(params=_AU_REAL)),
    ("au_tab", {}), ("alloy", {}), ("alloy", dict(max_nnei=30))])
@pytest.mark.parametrize("ntraj", [1, 37, 64, 65])
def test_slot_forces_match_float64_twin(cuda, kind, kw, ntraj):
    """K9 and K10 (both modes, one and two elements) against their float64
    twins, tables truncated below their occupancy included (not
    symmetric), and powers that are not integers (powf): force within
    1e-4 and energy within 1e-5 of the largest; batches of one, a
    partial and two whole warps of trajectories and one lane past them;
    one evaluation counted a call; bitwise repeats; exactly zero at
    rest; a single (nph,) vector goes through as a batch of one."""
    from sclmd_tpu_torch.kernels import eam_force as K10
    from sclmd_tpu_torch.kernels import sw_force as K9
    mod = K9 if kind.startswith("si") else K10
    drv, ref = _slot_pair(kind, cuda, **kw)
    assert drv.kernel.cuda is not None
    # K10 takes its symmetric route on a full table, the general one on a
    # truncated table
    sym = mod is K10 and "max_nnei" not in kw
    assert mod is K9 or drv.kernel.cuda.pack["sym"] == sym
    gen = torch.Generator(device=cuda).manual_seed(ntraj)
    conv = torch.as_tensor(drv.conv, dtype=torch.float32, device=cuda)
    q = 0.1 * torch.randn((ntraj, 3 * drv.number), device=cuda,
                          generator=gen) / conv
    before, before_sym = mod.launches, K10.launches_sym
    e, f = drv.energy_force_torch(q)
    f2 = drv.force_torch(q)
    torch.cuda.synchronize()
    assert mod.launches == before + 2
    assert K10.launches_sym == before_sym + (2 if sym else 0)
    assert torch.equal(f, f2)
    ew, fw = ref.energy_force_torch(q.double().cpu())
    assert _rel(f, fw) < 1e-4
    assert _rel(e, ew) < 1e-5
    assert not drv.force_torch(torch.zeros_like(q)).any()
    assert torch.equal(drv.force_torch(q[0]), f[0])
    assert _rel(drv.kernel.plain(q), fw) < 1e-3


def test_sw_force_through_the_cutoff(cuda):
    """Pairs pulled across the cutoff a sigma (the tail's exponential
    underflows before 1/(r - a sigma)^2 blows up): finite, and within
    1e-4 of the float64 twin."""
    drv, ref = _slot_pair("si", cuda)
    x0 = np.array(drv.xyz).reshape(-1, 3)
    rng = np.random.default_rng(3)
    u = rng.normal(size=(16, drv.number, 3)) * np.linspace(
        0.0, 0.5, 16)[:, None, None]
    q = torch.as_tensor((u.reshape(16, -1)) / drv.conv, dtype=torch.float32,
                        device=cuda)
    f = drv.force_torch(q)
    fw = ref.force_torch(q.double().cpu())
    assert torch.isfinite(f).all() and x0.shape[0] == drv.number
    assert _rel(f, fw) < 1e-4


def test_sw_force_divergent_lanes_keep_their_bits(cuda):
    """A batch of 40 trajectories (a whole warp and 8 lanes of another)
    at small displacements, in which trajectories 3, 17 and 35 pull one
    second neighbour (3.84 angstrom, outside the cutoff of 3.77) inside
    it: only those lanes of their warps take the slot. Every
    trajectory's force and energy equal, bitwise, those of the same
    trajectory run alone, and the force is within 1e-4 of the float64
    twin."""
    from sclmd_tpu_torch.kernels import slots
    drv, ref = _slot_pair("si", cuda)
    pack = drv.kernel.cuda.pack
    r0 = np.linalg.norm(pack["d0"], axis=1)
    k = int(np.nonzero((r0 > 3.8) & (r0 < 3.9))[0][0])
    i, unit = pack["slot_i"][k], pack["d0"][k] / r0[k]
    rng = np.random.default_rng(8)
    u = 0.01 * rng.normal(size=(40, drv.number, 3))
    pulled = [3, 17, 35]
    u[pulled, i] += 0.12 * unit
    qn = u.reshape(40, -1) / drv.conv
    inside = np.linalg.norm(slots.slot_vectors(pack, qn)[:, k], axis=-1) \
        < pack["params"]["rc"]
    assert np.array_equal(np.nonzero(inside)[0], pulled)
    q = torch.as_tensor(qn, dtype=torch.float32, device=cuda)
    e, f = drv.energy_force_torch(q)
    for t in range(40):
        et, ft = drv.energy_force_torch(q[t:t + 1])
        assert torch.equal(ft[0], f[t]) and torch.equal(et[0], e[t]), t
    assert _rel(f, ref.force_torch(q.double().cpu())) < 1e-4


@pytest.mark.parametrize("kind", ["si", "si_trunc", "au", "au_tab",
                                  "au_trunc"])
def test_slot_force_launch_shapes_give_the_same_bits(cuda, kind):
    """Every launch shape of the centre passes (1, 2 or 4 centres a
    block, and the wide route: rows from global memory, K9's kept entries
    in a global scratch) gives the same bits, force and energy, at 37 and
    64 trajectories (K10 on its symmetric route on the full tables, the
    general one truncated); the scratch is kept per trajectory stride and
    the force is a tensor of its own at every call."""
    from sclmd_tpu_torch.kernels import slots
    drv, _ = _slot_pair(kind.replace("_trunc", ""), cuda, **(
        dict(max_nnei=10 if kind == "si_trunc" else 30) if "trunc" in kind
        else {}))
    kern = drv.kernel.cuda
    assert kind.startswith("si") or kern.pack["sym"] == ("trunc" not in kind)
    gen = torch.Generator(device=cuda).manual_seed(5)
    conv = torch.as_tensor(drv.conv, dtype=torch.float32, device=cuda)
    for n in (37, 64):
        q = 0.1 * torch.randn((n, 3 * drv.number), device=cuda,
                              generator=gen) / conv
        want = kern(q, energy=True)
        for plan in [slots.Plan(w, 0, False) for w in (1, 2, 4)] + [
                slots.Plan(slots.MAX_WARPS, 0, True)]:
            smem = 0 if plan.wide else \
                plan.wpb * kern.smem_per_warp(kern.pack)
            kern.plan = plan._replace(smem=smem)
            got = kern(q, energy=True)
            assert torch.equal(got[1], want[1]), plan
            assert torch.equal(got[0], want[0]), plan
            assert got[1].data_ptr() != want[1].data_ptr()
        kern.plan = slots.launch_plan(kern.smem_per_warp(kern.pack))
    assert {k[0] for k in kern._scratch} == {32, 64}


def _eam_routes(kind, cuda):
    """A float32 ``EAMDriver`` of ``_slot_pair`` on the card (its kernel
    on the symmetric route), the general route's kernel built on the same
    table, and 64 trajectories of 0.1 angstrom rms."""
    from sclmd_tpu_torch.kernels import eam_force as K10
    drv, _ = _slot_pair(kind, cuda)
    kern = drv.kernel.cuda
    assert kern.pack["sym"]
    general = K10.EAMForceCuda(dict(kern.pack, sym=False), cuda)
    gen = torch.Generator(device=cuda).manual_seed(64)
    conv = torch.as_tensor(drv.conv, dtype=torch.float32, device=cuda)
    q = 0.1 * torch.randn((64, 3 * drv.number), device=cuda,
                          generator=gen) / conv
    return kern, general, q


@pytest.mark.parametrize("kind", ["au", "au_tab", "alloy"])
def test_eam_symmetric_route_matches_float64_twin(cuda, kind):
    """K10's symmetric route (analytic, tabulated, two elements) against
    its float64 twin (``symmetric_force_numpy``, f0 its own force at
    rest) within 1e-4 of the largest force and 1e-5 of the largest
    energy, and against the general route's kernel on the same table
    (float32 both, summed in other orders) within 1e-5 and 1e-6: three
    launches an evaluation either way, one counted each."""
    from sclmd_tpu_torch.kernels import eam_force as K10
    kern, general, q = _eam_routes(kind, cuda)
    before, before_sym = K10.launches, K10.launches_sym
    e, f = kern(q, energy=True)
    eg, fg = general(q, energy=True)
    torch.cuda.synchronize()
    assert (K10.launches, K10.launches_sym) == (before + 2, before_sym + 1)
    qn = q.double().cpu().numpy()
    _, f0 = K10.symmetric_force_numpy(kern.pack, np.zeros((1, qn.shape[1])))
    ew, fw = K10.symmetric_force_numpy(kern.pack, qn, f0=f0[0])
    assert _rel(f, torch.as_tensor(fw)) < 1e-4
    assert _rel(e, torch.as_tensor(ew)) < 1e-5
    assert _rel(f, fg) < 1e-5
    assert _rel(e, eg) < 1e-6


@pytest.mark.parametrize("kind", ["au", "au_tab", "alloy"])
def test_eam_symmetric_route_keeps_its_bits(cuda, kind):
    """On the symmetric route a trajectory's force and energy have the
    same bits in batches of 1, 33 and 64; two calls agree bitwise; the
    energy comes on request, before and after calls without it (the last
    block's counter is reset by each call that uses it)."""
    kern, _, q = _eam_routes(kind, cuda)
    e, f = kern(q, energy=True)
    assert torch.equal(kern(q), f)
    e2, f2 = kern(q, energy=True)
    assert torch.equal(f2, f) and torch.equal(e2, e)
    for n in (1, 33):
        en, fn = kern(q[:n], energy=True)
        assert torch.equal(fn, f[:n]) and torch.equal(en, e[:n]), n
        assert torch.equal(kern(q[:n]), f[:n]), n
    assert torch.isfinite(e).all() and (e < 0).all()


def test_slot_forces_refuse_what_the_kernel_does_not_take(cuda):
    """float64 on the card keeps the autograd route, and non-integer powers
    do not (the kernel takes powf); a float64 tensor or one of another
    width given to the kernel raises."""
    from sclmd_tpu_torch.models import sw as S
    drv, _ = _slot_pair("si", cuda)
    with pytest.raises(TypeError):
        drv.kernel(torch.zeros((2, 3 * drv.number), dtype=torch.float64,
                               device=cuda))
    with pytest.raises(ValueError):
        drv.kernel(torch.zeros((2, 3 * drv.number + 3), device=cuda))
    d64 = S.SWDriver(drv.axyz, dtype=torch.float64, device=cuda)
    assert d64.kernel is None
    odd = dict(S.SW_PARAMS["Si"], p=4.5)
    assert S.SWDriver(drv.axyz, dtype=torch.float32, device=cuda,
                      params=odd).kernel.cuda is not None


@pytest.mark.parametrize("kind", ["sw", "eam", "eam_tab"])
def test_slab_run_segment_card_against_cpu(cuda, kind):
    """A cut slab (the slab tool's layout, wideband baths at its ends)
    through 48 plain steps on the card (K9 or K10, K7) against float64 on
    the CPU, the same injected draws. Cells wide enough that no pair
    within the cutoff and skin lies near half a period (where float32 and
    float64 may take different images)."""
    from sclmd_tpu_torch.parallel.ensemble import bath_factors, fused_chunk
    from sclmd_tpu_torch.tools import slab as SL
    cells = (3, 2, 2) if kind == "sw" else (4, 4, 4)
    rng = np.random.default_rng(5)
    out, rs = [], None
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        r = SL.slab_runner(kind, dtype, device, "unused", cells=cells,
                           nmd=64)
        if rs is None:
            rs = [rng.standard_normal((3,) + np.shape(b.nstd))
                  for b in r.baths]
        fin, sums, ok = fused_chunk(
            r._build_system(), bath_factors(r.baths, device),
            [torch.as_tensor(x, dtype=dtype, device=device) for x in rs],
            48, 0, None, 12)
        assert bool(ok)
        out.append((fin.p, fin.q, sums))
    for a, b in zip(*out):
        assert _rel(a, b) < 1e-4


# --- the NEGF stack on the card: complex128 torch.linalg (no hand kernel)
def _free_chain_ps2(n=10, k=0.1):
    """A free 1-D chain's dynamical matrix in ps^-2 (singular: its
    translation)."""
    from sclmd_tpu_torch import units
    d = np.zeros((n, n))
    for i in range(n - 1):
        d[i, i] += k
        d[i + 1, i + 1] += k
        d[i, i + 1] -= k
        d[i + 1, i] -= k
    return d / units.RPC ** 2


def _within(got, want, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_bpt_gettm_card_against_cpu(cuda):
    """The Caroli sweep on the card against the CPU, w = 0 included (a
    singular matrix there: 0, no error), two chunk sizes."""
    from sclmd_tpu_torch.negf import bpt
    d = _free_chain_ps2()
    want = bpt(d, 0.7, 20.0, [[0, 1], [8, 9]], num=40,
               device="cpu").gettm()
    for bs in (7, 41):
        got = bpt(d, 0.7, 20.0, [[0, 1], [8, 9]], num=40, batch_size=bs,
                  device=cuda).gettm()
        assert got[0, 1] == 0.0
        _within(got[:, 1], want[:, 1])


def test_bpt_biased_getps_card_against_cpu(cuda):
    """The bias branch of the power spectrum (solve on A^T, the Keldysh
    block) and the equilibrium branch, card against CPU."""
    from sclmd_tpu_torch.negf import bpt
    d = _free_chain_ps2(6)
    out = []
    for device in (cuda, "cpu"):
        b = bpt(d, 0.7, 20.0, [[0], [5]], num=10, device=device)
        eq = b.getps(300.0, 0.6, 15).copy()
        b.setbias(0.05, bdamp=np.eye(2) * 0.02, chiplus=np.eye(2) * 0.01,
                  chiminus=np.eye(2) * 0.005, dofatomofbias=[2, 3])
        out.append((eq, b.getps(300.0, 0.6, 15)))
    for got, want in zip(*out):
        assert np.isfinite(got).all()
        _within(got[:, 1], want[:, 1])


def test_surface_gf_card_against_cpu(cuda):
    """The batched decimation with frozen carries: G within 1e-10 of its
    largest magnitude and the same iteration count for each frequency."""
    from sclmd_tpu_torch.selfenergy import surface_gf
    k = 0.1
    K00 = np.array([[2 * k, -k], [-k, 2 * k]])
    K01 = np.array([[0.0, 0.0], [-k, 0.0]])
    ws = np.array([0.05, 2.0, 0.6, 1.5, 0.3, 0.631, 3.0, 0.01])
    g, it, conv = surface_gf(ws, K00, K00, K01, eta=1e-5, device=cuda)
    gh, ith, convh = surface_gf(ws, K00, K00, K01, eta=1e-5, device="cpu")
    assert g.device.type == "cuda" and g.dtype == torch.complex128
    np.testing.assert_array_equal(it.cpu().numpy(), ith.numpy())
    assert bool(conv.all()) and bool(convh.all())
    assert len(set(ith.tolist())) >= 3
    _within(g.cpu().numpy(), gh.numpy())


def test_negf_no_singular_error_at_zero(cuda):
    """w = 0 on a free chain: T, the power spectrum, G itself and a lead
    self-energy come back without a singular-matrix error."""
    from sclmd_tpu_torch.negf import bpt
    from sclmd_tpu_torch.selfenergy import lead_selfenergy_from_blocks
    b = bpt(_free_chain_ps2(), 0.7, 20.0, [[0, 1], [8, 9]], num=4,
            device=cuda)
    assert b.tm(0.0) == 0.0
    ps = b._ps_batch(np.array([0.0, 0.1]), 300.0, range(10))
    assert float(ps[0]) == 0.0 and bool(torch.isfinite(ps).all())
    assert b.retargf(0.0).shape == (10, 10)
    se = lead_selfenergy_from_blocks(np.array([[0.2]]), np.array([[-0.1]]),
                                     np.array([[-0.1]]), [0.0, 0.1],
                                     eta=0.0, device=cuda)
    assert se.shape == (2, 1, 1)


def _dict_within(got, want, tol):
    for k, w in want.items():
        g = got[k]
        g = g.cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = w.cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), k


def test_lambda_pipeline_card_against_cpu(cuda):
    """The Lambda pipeline in complex128 on the card against the CPU at
    rundp's model (12 orbitals, 6 modes, 256 energies): the spectral
    functions, wideband and every array of full_lambda within 1e-9 of
    their largest values, the same at two mode chunks; kaverage_extract
    likewise at 3 k points."""
    from sclmd_tpu_torch.examples.current_induced.rundp import model
    from sclmd_tpu_torch.postprocess import hssigma as HS
    from sclmd_tpu_torch.postprocess import lambda_pipeline as LP
    args = model(n_el=12, nm=6, ne=256)
    ref = LP.LambdaPipeline(*args, device="cpu")
    want = (ref.wideband(0.05), ref.full_lambda(0.05, 0.25, -0.25))
    for chunk in (2, 6):
        pl = LP.LambdaPipeline(*args, device=cuda, mode_chunk=chunk)
        assert pl.sp["A"].device.type == "cuda"
        _dict_within(pl.sp, ref.sp, 1e-9)
        _dict_within(pl.wideband(0.05), want[0], 1e-9)
        _dict_within(pl.full_lambda(0.05, 0.25, -0.25), want[1], 1e-9)
    H, S, E, SigL, SigR, _, _ = args
    Hk = np.stack([H, H + 0.05, H.T])
    fk = np.array([1.0, 0.9, 1.1])[None, :, None, None]
    kargs = (Hk, np.stack([S] * 3), SigL[:, None] * fk, SigR[:, None] * fk,
             E, np.full(3, 1 / 3))
    _dict_within(HS.kaverage_extract(*kargs, eta=1e-3, device=cuda),
                 HS.kaverage_extract(*kargs, eta=1e-3, device="cpu"), 1e-9)


def test_biased_flagship_window_card_against_cpu(cuda, tmp_path):
    """The flagship under the biased centre bath (K7's wind/Berry route):
    48 plain steps of two trajectories on the card against float64 on
    the CPU, the same injected draws, within 1e-4 of the largest."""
    from sclmd_tpu_torch.kernels import bath_force as K7
    from sclmd_tpu_torch.parallel.ensemble import bath_factors, fused_chunk
    from sclmd_tpu_torch.tools import flagship as F
    _, part, _ = F.flagship_junction()
    wbf = str(tmp_path / "wb.npz")
    F.write_centre_bath(wbf, cuda, len(F.centre_dofs(part)), ne=512)
    rng = np.random.default_rng(5)
    out = []
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        r = F.biased_flagship_runner(dtype, device, str(tmp_path), wbf)
        if not out:
            rs = [rng.standard_normal((2,) + np.shape(b.nstd))
                  for b in r.baths]
            us = rng.uniform(size=(2, r.nph))
        system = r._build_system()
        before = K7.launches
        fin, sums, ok = fused_chunk(
            system, bath_factors(r.baths, device),
            [torch.as_tensor(x, dtype=dtype, device=device) for x in rs],
            48, 0, None, 12, states=TMD.thermal_init(
                torch.as_tensor(us, dtype=dtype, device=device), system,
                r.hw, r.U, F.T))
        if device != "cpu":
            assert K7.launches - before == 3 * 48
        assert bool(ok)
        out.append((fin.p, fin.q, sums))
    for a, b in zip(*out):
        assert _rel(a, b) < 1e-4
