"""The launch plan of K9's and K10's centre pass (``kernels.slots``) on the
CPU: how many centres (warps) a block takes, its shared memory, and where
a table is too wide to stage, the wide route. No JAX, no card."""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from sclmd_tpu_torch.kernels import eam_force as K10
from sclmd_tpu_torch.kernels import slots
from sclmd_tpu_torch.kernels import sw_force as K9
from sclmd_tpu_torch.models import eam as TE
from sclmd_tpu_torch.models import sw as TS


def _packs():
    """The silicon slab's cut (rows of 16) under K9 and a gold cell
    (rows of 86, as the gold slab's) under K10, analytic and tabulated."""
    pos, cell = TS.diamond_cell(3, 2, 2)
    si = TS.SWDriver([["Si", *p] for p in pos], cell=cell, max_nnei=16,
                     cutoff_skin=0.4, device="cpu")
    fcc, fcell = TE.fcc_cell(4, 4, 4, 4.08)
    au = [["Au", *p] for p in fcc]
    gold = TE.EAMDriver(au, cell=fcell, cutoff_skin=0.3, device="cpu")
    tab = TE.EAMDriver(au, cell=fcell, cutoff_skin=0.3, device="cpu",
                       setfl=TE.sutton_chen_tables("Au"))
    return (K9.pack_operands(si.energy_fn.terms, si.xyz, si.conv),
            *(K10.pack_operands(d.energy_fn.terms, d.xyz, d.conv)
              for d in (gold, tab)))


def test_slab_plans():
    """K9 on rows of 16: a warp keeps 5 floats of 32 lanes and a slot a
    column beside the 16-byte records, and a mask word a lane: 10,688
    bytes, four centres a block; K10 on rows of 86: the records (and the
    type and pair words when tabulated), four centres a block."""
    si, gold, tab = _packs()
    assert (si["width"], gold["width"], tab["width"]) == (16, 86, 86)
    assert K9.SWForceCuda.smem_per_warp(si) == 16 * (16 + 640 + 4) + 128
    assert slots.launch_plan(10688) == slots.Plan(4, 42752, False)
    assert slots.launch_plan(2 * 10688) == slots.Plan(2, 42752, False)
    assert K10.EAMForceCuda.smem_per_warp(gold) == 86 * 16
    assert K10.EAMForceCuda.smem_per_warp(tab) == 86 * 24
    assert slots.launch_plan(86 * 16) == slots.Plan(4, 5504, False)
    assert slots.launch_plan(86 * 24) == slots.Plan(4, 8256, False)


def test_plan_takes_any_width():
    """No table is refused: an empty one stages nothing; rows too wide
    for a block's aim run one warp a block; rows too wide for any block
    take the wide route (no shared memory)."""
    assert slots.launch_plan(0) == slots.Plan(4, 0, False)
    assert slots.launch_plan(200_000) == slots.Plan(1, 200_000, False)
    assert slots.launch_plan(slots.SMEM_MAX + 1) == \
        slots.Plan(slots.MAX_WARPS, 0, True)
    wide = {"width": 400}
    assert slots.launch_plan(K9.SWForceCuda.smem_per_warp(wide)).wide


@settings(max_examples=200, deadline=None)
@given(per_warp=st.integers(0, 1_000_000))
def test_plan_fits_the_card(per_warp):
    """Every staged plan fits a block's shared memory, takes the most
    warps within the aim, and sizes what the kernel stages."""
    p = slots.launch_plan(per_warp)
    assert 1 <= p.wpb <= slots.MAX_WARPS
    if p.wide:
        assert p.smem == 0 and per_warp > slots.SMEM_MAX
        return
    assert p.smem == p.wpb * per_warp <= slots.SMEM_MAX
    assert p.smem <= slots.SMEM_AIM or p.wpb == 1
    if p.wpb < slots.MAX_WARPS:
        assert 2 * p.wpb * per_warp > slots.SMEM_AIM


def test_lanes_round_up_to_whole_warps():
    assert [slots.lanes(n) for n in (1, 31, 32, 33, 37, 64, 65)] == \
        [32, 32, 32, 64, 64, 64, 96]


def test_table_of_the_slab_cell():
    """A cut of the silicon slab: rows of 16, each slot's record is its
    float32 reference vector and head, and the head lists cover every
    slot once; what the kernel reads of the table is 24 bytes a slot and
    32 an atom."""
    pack = _packs()[0]
    assert pack["width"] == 16 and pack["ns"] == 16 * pack["na"]
    assert np.array_equal(np.sort(pack["head"]), np.arange(pack["ns"]))
    assert slots.table_bytes(pack) == 24 * pack["ns"] + 32 * pack["na"]
