"""The host side of the plain step's kernels K7 and K6, on the CPU.

What the CUDA kernels cannot show here their Python does: the operand
that K7 reads (a bath's matrices packed along the reduction axis,
transposed and padded) against the bath's own force rule in float64, the
way a CTA's threads and shared memory are dealt out, and the way K6's
taps are dealt out to CTAs. Tolerance 1e-13: the packed product and the
rule compute the same float64 terms in another order.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch.kernels import bath_force as K7
from sclmd_tpu_torch.kernels import conv_tails as K6

torch.set_num_threads(2)

DT, NMD = 0.4, 16
GWL = np.linspace(0.0, 0.6, 16)
ODD = [17, 3, 11, 4, 5, 20, 9]             # 7 scattered DOFs
EVEN = [2, 3, 4, 5, 6, 7, 8, 9]            # 8 contiguous ones


def _bath(kind, cats, seed=0):
    nc = len(cats)
    f64 = dict(dtype=torch.float64, device="cpu", factorize=False)
    if kind[0] == "phonon":
        gam = np.array([np.eye(nc) * 0.02 * np.exp(-(w / 0.3) ** 2)
                        + 0.001 * np.arange(nc * nc).reshape(nc, nc) / nc
                        for w in GWL])
        return TB.phbath(300.0, cats, 0.3, 32, DT, NMD, ml=kind[1],
                         gamma=gam, gwl=GWL, **f64)
    if kind[0] == "local":
        return TB.phbath(300.0, cats, 0.2, 32, DT, NMD, **f64)
    rng = np.random.default_rng(seed)
    a = 0.05 * rng.normal(size=(nc, nc))
    extra = {}
    if kind[0] == "biased":
        extra = dict(bias=0.2, exim=0.02 * rng.normal(size=(nc, nc)),
                     zeta1=0.02 * rng.normal(size=(nc, nc)),
                     zeta2=0.02 * rng.normal(size=(nc, nc)))
    return TB.ebath(cats, 300.0, DT, NMD, wmax=1.0,
                    efric=a @ a.T + 0.02 * np.eye(nc), **f64, **extra)


KINDS = [("phonon", 2), ("phonon", 9), ("local",), ("electron",),
         ("biased",)]


@pytest.mark.parametrize("cats", [ODD, EVEN], ids=["odd", "even"])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: "-".join(map(str, k)))
def test_packed_operand_matches_force_rule(kind, cats):
    """``n - s (M [x; h; q] + tail)`` from the packed operand equals the
    bath's ``force_pred`` and ``force_corr``, and ``M [x; h; q]`` equals
    ``Mv x + Mh h - Mq q / s``."""
    b = _bath(kind, cats)
    nc, ntraj = len(cats), 3
    rng = np.random.default_rng(nc)
    x, h, q, n = (torch.as_tensor(rng.normal(size=(ntraj, nc)))
                  for _ in range(4))
    tail = torch.as_tensor(rng.normal(size=(ntraj, nc, 2))) \
        if b.ml > 2 else None
    op = K7.pack_operands([b])[0]
    Mv, Mh, Mq, s = K7.bath_matrices(b)
    vec = torch.cat([x] + [h if src == K7.SRC_H else q for src in op.srcs],
                    dim=1)
    assert op.MT.shape == (vec.shape[1], -(-nc // 4) * 4)
    prod = vec @ op.MT[:, :nc]
    want = x @ Mv.T
    if Mh is not None:
        want = want + h @ Mh.T
    if Mq is not None:
        want = want - (q @ Mq.T) / s
    assert torch.allclose(prod, want, rtol=1e-13, atol=1e-13)
    assert (kind[0] == "biased") == (K7.SRC_Q in op.srcs)
    assert (kind[0] == "phonon") == op.has_h
    for col, rule in ((0, b.force_pred), (1, b.force_corr)):
        fb = n - op.s * (prod + (tail[..., col] if tail is not None else 0))
        # the predictor's h is old[0], handed over as old_c[:, 0]; the
        # corrector's is the pre-step p
        ref = rule(n, x, q, h[:, None] if col == 0 else h, tail)
        assert torch.allclose(fb, ref, rtol=1e-13, atol=1e-13)


def test_packed_operands_share_one_padded_buffer():
    """All baths sit in one contiguous buffer, each on a 16-byte
    boundary; rows are padded to 4 floats with zeros that stay outside
    every product (``[:, :nc]`` is the data)."""
    kinds = [("biased",), ("local",), ("phonon", 5), ("electron",)]
    sets = [ODD, [1, 2], [21, 22, 23, 24, 25], EVEN]
    baths = [_bath(k, c, seed=i) for i, (k, c) in
             enumerate(zip(kinds, sets))]
    ops = K7.pack_operands(baths)
    base = ops[0].MT.data_ptr()
    end = base
    for op, b in zip(ops, baths):
        K, ld = op.MT.shape
        assert ld % 4 == 0 and 0 <= ld - b.nc < 4
        assert K == b.nc * (1 + len(op.srcs))
        assert op.MT.is_contiguous() and op.MT.data_ptr() == end
        assert (op.MT.data_ptr() - base) % 16 == 0
        assert torch.count_nonzero(op.MT[:, b.nc:]) == 0
        assert op.cids.tolist() == list(b.cids)
        end += K * ld * op.MT.element_size()
    assert K7.pack_operands(baths[2:3])[0].MT.equal(ops[2].MT)


@pytest.mark.parametrize("tt", K7.TILES)
@pytest.mark.parametrize("shapes,nph", [
    ([(90, 180), (90, 180)], 300), ([(150, 150), (150, 150)], 603),
    ([(7, 21), (2, 2), (5, 10), (8, 8)], 24), ([(700, 2100)], 2100), ([], 9),
    ([(864, 864), (864, 864)], 10368)])
def test_launch_plan_deals_threads_and_memory(shapes, nph, tt):
    """Every bath gets whole warps, at least one K slice and a thread
    for some column; no two regions of shared memory overlap; the
    partial sums start on 16-byte boundaries; the vectors are staged
    with one or two trajectories per CTA where they fit."""
    plan = K7.launch_plan(shapes, nph, tt)
    assert plan["staged"] == (tt <= 2 and K7.launch_plan(
        shapes, nph, tt, staged=True)["smem_bytes"] <= K7.SMEM_LIMIT)
    regions = [(plan["f_off"], tt * nph)]
    if plan["staged"]:
        regions += [(plan[k], tt * nph) for k in
                    ("xs_off", "hs_off", "qs_off", "bs_off")]
        regions.append((plan["ms_off"], nph))
    t0 = 0
    for (nc, K), b in zip(shapes, plan["baths"]):
        assert b["t0"] == t0 and b["nt"] % 32 == 0 and b["nt"] >= 32
        t0 += b["nt"]
        assert 1 <= b["ncol"] <= b["ld"] // 4 and b["ncol"] <= b["nt"]
        assert 1 <= b["nsl"] <= K and b["ncol"] * b["nsl"] <= b["nt"]
        assert b["p_off"] % 4 == 0
        regions += [(b["v_off"], tt * K), (b["p_off"], b["nsl"] * tt * b["ld"]),
                    (b["z_off"], tt * nc), (b["tl_off"], tt * nc)]
        regions.append((plan["ci_off"] + b["c_off"], nc))
    assert t0 <= K7.THREADS
    regions.sort()
    for (a0, n0), (a1, _) in zip(regions, regions[1:]):
        assert a0 + n0 <= a1
    assert 4 * sum(regions[-1]) <= plan["smem_bytes"]


@pytest.mark.parametrize("tt", [1, 2])
def test_launch_plan_reads_a_wide_system_from_global_memory(tt):
    """The silicon slab (nph 10,368, two wideband baths of 864 DOFs,
    memory length 1, so K = nc): its five staged vectors and mask would
    take 248,832 bytes at one trajectory per CTA, over the card's
    232,448, so the plan reads x, h, q and base from global memory and
    fits."""
    shapes = [(864, 864), (864, 864)]
    plan = K7.launch_plan(shapes, 10368, tt)
    assert plan["staged"] == 0 and plan["smem_bytes"] <= K7.SMEM_LIMIT
    assert all(plan[k] == 0 for k in ("xs_off", "hs_off", "qs_off",
                                      "bs_off", "ms_off"))
    assert K7.launch_plan(shapes, 10368, tt, staged=True)["smem_bytes"] > \
        K7.SMEM_LIMIT
    assert plan["f_off"] == 0 and plan["baths"][0]["v_off"] == \
        tt * 10368


def test_launch_plan_keeps_the_flagship_staged():
    """At the flagship's shapes (its two electron baths, nph 603) and the
    primary junction's, every tile of one or two trajectories stays on
    the staged route with the plan it had before the wide route existed
    (the same offsets, so the same launch)."""
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools import primary as P
    for runner, nph in ((F.flagship_runner(torch.float64, "cpu", "unused"),
                         603),
                        (P.primary_runner(torch.float64, "cpu", "unused"),
                         300)):
        shapes = [(op.bath.nc, op.MT.shape[0])
                  for op in K7.pack_operands(runner.baths)]
        for tt in (1, 2):
            plan = K7.launch_plan(shapes, nph, tt)
            assert plan["staged"] == 1
            assert plan == K7.launch_plan(shapes, nph, tt, staged=True)
            assert plan["xs_off"] == 4 * ((tt * nph + 3) // 4)


def test_tile_size_follows_the_card():
    assert K7.tile_size(1, 132) == 1 and K7.tile_size(128, 132) == 1
    assert K7.tile_size(256, 132) == 2 and K7.tile_size(512, 132) == 4
    assert K7.tile_size(1024, 132) == 8 and K7.tile_size(10 ** 5, 132) == 8


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(st.integers(3, 1200), st.integers(1, 160)),
                min_size=1, max_size=4), st.integers(1, 200))
def test_tap_partition_takes_every_tap_once(baths, ncta):
    """ml 3-1200, nc 1-160, 1-4 baths, 1-200 CTAs: every tap of every
    bath exactly once, each CTA a contiguous non-empty range of one
    bath, no more CTAs than asked for (or one per bath, if that is
    more) nor than there are taps, and balanced: no CTA of a bath has
    more than one tap above another's."""
    taps = [ml - 2 for ml, _ in baths]
    parts = K6.tap_partition(taps, [4 * nc * nc for _, nc in baths], ncta)
    assert len(baths) <= len(parts) <= max(ncta, len(baths))
    assert len(parts) == max(len(baths), min(ncta, sum(taps)))
    seen = [[] for _ in baths]
    for stream, r0, r1 in parts:
        assert 0 <= r0 < r1 <= taps[stream]
        seen[stream].append((r0, r1))
    assert [s for s, _, _ in parts] == sorted(s for s, _, _ in parts)
    for i, ranges in enumerate(seen):
        assert ranges and ranges[0][0] == 0 and ranges[-1][1] == taps[i]
        for (_, e0), (b1, _) in zip(ranges, ranges[1:]):
            assert e0 == b1
        sizes = [e - b for b, e in ranges]
        assert max(sizes) - min(sizes) <= 1


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.integers(3, 1200), st.integers(1, 160)),
                min_size=1, max_size=4), st.integers(1, 300),
       st.sampled_from([1, 2, 64, 132]))
def test_stream_plan_covers_every_row_and_tap(baths, ntraj, nsm):
    """The launch plan of K6: every (bath, row, tap) belongs to exactly
    one CTA, a CTA's rows fit the kernel's register tile, its stage fits
    its tap rows off any 16-byte phase, and the ring fits shared
    memory."""
    ncs, mls = [nc for _, nc in baths], [ml for ml, _ in baths]
    plan = K6.stream_plan(ncs, mls, ntraj, nsm)
    assert plan["ntiles"] * plan["tt"] >= ntraj > \
        (plan["ntiles"] - 1) * plan["tt"]
    assert 2 <= plan["nstage"] <= K6.MAX_STAGES
    assert plan["smem_bytes"] <= K6.SMEM_LIMIT
    assert plan["kfloats"] % 4 == 0 and plan["hld"] % 4 == 0
    cover = [np.zeros((ml, nc), int) for ml, nc in baths]
    for c, (bi, a0, ra, r0, r1, stream, c0, cn) in enumerate(plan["desc"]):
        assert 1 <= ra <= K6.ROWS and ra * ncs[bi] + 3 <= plan["kfloats"]
        assert c0 <= c < c0 + cn
        assert plan["desc"][c0][5] == stream == plan["desc"][c0 + cn - 1][5]
        assert plan["streams"][stream] == (bi, a0, ra)
        cover[bi][r0:r1, a0:a0 + ra] += 1
    for cov in cover:
        assert (cov[2:] == 1).all() and (cov[:2] == 0).all()


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 300), st.integers(1, 3)),
                min_size=1, max_size=4), st.integers(0, 400),
       st.integers(1, 200), st.randoms(use_true_random=False))
def test_wide_plan_owns_every_bath_row_and_free_dof_once(baths, free, ntraj,
                                                        rnd):
    """K7's wide route at nc 1-300, K = nc, 2 nc or 3 nc, 1-4 disjoint
    baths on scattered DOFs, 1-200 trajectories: every (bath, row,
    trajectory) belongs to exactly one product CTA, every DOF of no bath
    of every trajectory to exactly one update CTA, no CTA owns nothing,
    and shared memory fits."""
    shapes = [(nc, nc * m) for nc, m in baths]
    nph = sum(nc for nc, _ in shapes) + free
    dofs = list(range(nph))
    rnd.shuffle(dofs)
    cids, at = [], 0
    for nc, _ in shapes:
        cids.append(dofs[at:at + nc])
        at += nc
    plan = K7.wide_plan(shapes, ntraj)
    assert plan["smem_bytes"] <= K7.SMEM_LIMIT
    assert plan["grid"] == plan["nprod"] + ntraj
    rows = [np.zeros((nc, ntraj), int) for nc, _ in shapes]
    dof = np.zeros((ntraj, nph), int)
    for i in range(plan["grid"]):
        kind, *own = K7.wide_cta(plan, ntraj, shapes, i)
        if kind == "product":
            b, r, t = own
            assert len(r) and len(t) and len(r) <= K7.WIDE_ROWS and \
                len(t) <= K7.WIDE_TRAJ
            rows[b][r.start:r.stop, t.start:t.stop] += 1
        else:
            (t,) = own
            dof[t] += 1
            dof[t, [c for cs in cids for c in cs]] -= 1
    for r in rows:
        assert (r == 1).all()
    bath = np.zeros(nph, bool)
    bath[[c for cs in cids for c in cs]] = True
    assert (dof[:, ~bath] == 1).all() and (dof[:, bath] == 0).all()


SLAB = ([(864, 864), (864, 864)], 10368)


def test_wide_plan_fills_the_card_at_the_slab():
    """The silicon slab at its 64 trajectories: 2 x 54 product CTAs of
    16 rows and all 64 trajectories (each operand element read once a
    launch) and 64 update CTAs, at least one CTA per SM of the H100's
    132; two CTAs fit an SM's shared memory."""
    plan = K7.wide_plan(SLAB[0], 64)
    assert plan["nrt"] == [54, 54] and plan["ntiles"] == 1
    assert plan["nprod"] == 108 and plan["grid"] == 172 >= 132
    assert plan["smem_bytes"] == 4 * (plan["ci_off"] + 864)
    assert 2 * plan["smem_bytes"] <= K7.SMEM_LIMIT


@pytest.mark.parametrize("ntraj,tile", [(1, None), (3, None), (64, None),
                                        (65, None), (130, None), (5, 2),
                                        (300, None), (1024, None)])
def test_the_silicon_slab_takes_the_wide_route(ntraj, tile):
    """The slab's shapes take the wide route at every batch and at a
    forced tile of two; baths that share a DOF keep the tiled kernel's
    unstaged form."""
    tt, plan, wide = K7.choose_route(*SLAB, ntraj, 132, tile)
    assert wide and tt <= 2 and plan["staged"] == 0
    assert plan == K7.launch_plan(*SLAB, tt)
    assert not K7.choose_route(*SLAB, ntraj, 132, tile, disjoint=False)[2]


def test_staged_systems_keep_the_tiled_kernel():
    """The flagship at 128 and 1,024 trajectories, the primary chain at
    md.Run's one and 37, the gold slab at 64 and a 1,270-atom C/H ribbon
    with two 150-DOF electron baths at 32: no wide route, and
    ``launch_plan``'s plan at ``tile_size``'s tile, as before the wide
    route existed."""
    from sclmd_tpu_torch.tools import flagship as F
    from sclmd_tpu_torch.tools import primary as P
    cases = []
    for runner, nph, counts in (
            (F.flagship_runner(torch.float64, "cpu", "unused"), 603,
             (128, 1024)),
            (P.primary_runner(torch.float64, "cpu", "unused"), 300, (1, 37))):
        shapes = [(op.bath.nc, op.MT.shape[0])
                  for op in K7.pack_operands(runner.baths)]
        cases += [(shapes, nph, n) for n in counts]
    cases += [([(432, 432), (432, 432)], 5184, 64),
              ([(150, 150), (150, 150)], 3 * 1270, 32)]
    for shapes, nph, ntraj in cases:
        tt, plan, wide = K7.choose_route(shapes, nph, ntraj, 132)
        assert not wide
        assert tt == K7.tile_size(ntraj, 132)
        assert plan == K7.launch_plan(shapes, nph, tt)
        assert plan["staged"] == (tt <= 2)
