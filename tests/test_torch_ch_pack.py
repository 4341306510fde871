"""The host side of kernel K5 (``kernels.ch_force``) on the CPU: the
packed operands, the launch plan, the work count, the raise on a cell,
and the kernel's analytic gradient written out in numpy
(``analytic_force_numpy``: the formulas of csrc/ch_force.cu, slot by
slot) against the autograd twin, to float64 rounding. No JAX here."""

import os

import numpy as np
import pytest
import torch

from sclmd_tpu_torch.kernels import ch_force as K5
from sclmd_tpu_torch.models import hydrocarbon as TH
from sclmd_tpu_torch.models.tersoff import TERSOFF_PARAMS, graphene_ribbon

torch.set_num_threads(2)

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "flagship_negf.npz")


def benzene():
    axyz = []
    for r, el in ((1.40, "C"), (2.49, "H")):
        for k in range(6):
            th = np.pi / 3 * k
            axyz.append([el, r * np.cos(th), r * np.sin(th), 0.0])
    return axyz


def ribbon_h():
    return TH.terminate_with_h(
        [["C", *row] for row in graphene_ribbon(4, 3)])


def flagship():
    z = np.load(NPZ)
    return [[str(e)] + list(map(float, p))
            for e, p in zip(z["els"], z["pos"])]


def bare_dimer():
    """An isolated C-C bond (zeta = 0) with one H."""
    return [["C", 0.0, 0.0, 0.0], ["C", 1.45, 0.0, 0.0],
            ["H", -0.6, 0.9, 0.0]]


STRUCTURES = {"benzene": benzene, "ribbon_h": ribbon_h,
              "flagship": flagship, "bare_dimer": bare_dimer}


def _driver(name, **kw):
    return TH.CHDriver(STRUCTURES[name](), device="cpu", **kw)


def _pack(drv):
    return K5.pack_operands(drv.energy_fn.terms, drv.xyz, drv.conv)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_slots_cover_every_term_once(name):
    drv = _driver(name)
    t, p = drv.energy_fn.terms, _pack(drv)
    nc, nn = p["nc"], p["nn"]
    assert nn % 4 == 0 and nn >= t["nbr_c"].shape[1]
    assert p["nslots"] == nc * nn + p["npair"] + 3 * p["noop"] == \
        len(p["slot_ab"]) == len(p["d0"])
    # the table: live entries are the mask's, in the table's order
    live = p["nbr"] >= 0
    assert live[:, :t["mask_c"].shape[1]].sum() == t["mask_c"].sum()
    assert not live[:, t["mask_c"].shape[1]:].any()
    np.testing.assert_array_equal(
        p["nbr"][:, :t["nbr_c"].shape[1]][t["mask_c"]],
        t["c_ids"][t["nbr_c"]][t["mask_c"]])
    # bonds first, then springs with their rest lengths
    assert p["nbond"] == len(t["bonds"])
    np.testing.assert_array_equal(p["pair_ab"][:p["nbond"]], t["bonds"])
    np.testing.assert_array_equal(p["pair_ab"][p["nbond"]:], t["aux"])
    np.testing.assert_array_equal(p["pair_r0"][p["nbond"]:], t["aux_r0"])
    # reference vectors are the float64 geometry's differences
    x0 = drv.xyz.reshape(-1, 3)
    ab = p["slot_ab"]
    ok = ab[:, 0] >= 0
    np.testing.assert_array_equal(p["d0"][ok], x0[ab[ok, 1]] - x0[ab[ok, 0]])
    assert not p["d0"][~ok].any()
    # the wag slots: anchor -> H, anchor -> each adjacent
    if p["noop"]:
        w = ab[nc * nn + p["npair"]:].reshape(-1, 3, 2)
        np.testing.assert_array_equal(w[:, :, 0],
                                      np.repeat(t["oop"][:, 1:2], 3, 1))
        np.testing.assert_array_equal(w[:, :, 1], t["oop"][:, [0, 2, 3]])


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_atom_lists_take_every_live_slot_twice(name):
    """Every live slot appears once as a tail and once as a head, under
    the atoms it names, in rising slot order (the fixed order of the
    kernel's sums)."""
    p = _pack(_driver(name))
    seen = {}
    for at in range(p["na"]):
        ents = p["csr"][p["csr_ptr"][at]:p["csr_ptr"][at + 1]]
        assert list(ents) == sorted(ents)
        for ent in ents:
            slot, head = ent >> 1, ent & 1
            assert p["slot_ab"][slot][head] == at
            seen.setdefault(slot, []).append(head)
    live = np.nonzero(p["slot_ab"][:, 0] >= 0)[0]
    assert sorted(seen) == list(live)
    assert all(sorted(v) == [0, 1] for v in seen.values())
    assert p["csr_ptr"][-1] == 2 * len(live) == len(p["csr"])


@pytest.mark.parametrize("name", list(STRUCTURES))
@pytest.mark.parametrize("amp", [0.0, 0.05, 0.5])
def test_analytic_gradient_matches_autograd(name, amp):
    """The kernel's formulas against the twin, energy and force, at
    rest, at thermal displacements and far out (pairs cross the cutoff's
    switching zone): 1e-9 of the largest force (the twin's published form
    of g(theta) cancels two numbers near 7.7e7, which costs it some
    digits even in float64)."""
    drv = _driver(name)
    p = _pack(drv)
    rng = np.random.default_rng(len(name))
    q = amp / drv.conv.mean() * 0.02 * rng.standard_normal((2, 3 * p["na"]))
    e, f = K5.analytic_force_numpy(p, q, drv.f0.numpy())
    ew, fw = drv.kernel(torch.as_tensor(q), energy=True)
    scale = max(float(fw.abs().max()), float(drv.f0.abs().max()))
    np.testing.assert_allclose(f, fw.numpy(), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(e, ew.numpy(), rtol=1e-11)
    if amp == 0.0:
        assert np.abs(f).max() <= 1e-9 * scale


def test_analytic_gradient_with_lam3():
    table = {"C": dict(TERSOFF_PARAMS["C"], lam3=0.6)}
    drv = _driver("ribbon_h", tersoff_params=table)
    p = _pack(drv)
    assert p["scalars"]["lam3"] == 0.6
    q = 0.5 * np.random.default_rng(1).standard_normal((1, 3 * p["na"]))
    _, f = K5.analytic_force_numpy(p, q, drv.f0.numpy())
    fw = drv.force_torch(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(f, fw, rtol=0, atol=1e-10 * np.abs(fw).max())


def test_isolated_bond_and_collinear_wag_give_exact_zeros():
    """zeta = 0 takes b = 1 with no derivative; a wag term whose adjacent
    bonds are collinear has no normal and gives nothing."""
    drv = _driver("bare_dimer")
    p = _pack(drv)
    e, f = K5.analytic_force_numpy(p, np.zeros((1, 9)))
    assert np.isfinite(f).all() and np.isfinite(e).all()
    # an H passing through collinearity: put e1 x e2 = 0 by hand
    axyz = [["C", 0.0, 0.0, 0.0], ["C", 1.4, 0.0, 0.0],
            ["C", -1.4, 0.0, 0.0], ["H", 0.0, 1.09, 0.0]]
    terms = TH.ch_energy(axyz)[0].terms
    assert len(terms["oop"]) == 0        # set-up already drops the term
    terms = dict(terms, oop=np.array([[3, 0, 1, 2]]))
    xyz = np.array([a[1:] for a in axyz], float).ravel()
    pk = K5.pack_operands(terms, xyz, np.ones(12))
    q = np.zeros((1, 12))
    q[0, 11] = 0.3                       # the H out of the plane
    _, f_with = K5.analytic_force_numpy(pk, q)
    _, f_without = K5.analytic_force_numpy(
        K5.pack_operands(dict(terms, oop=np.zeros((0, 4), int)), xyz,
                         np.ones(12)), q)
    assert np.isfinite(f_with).all()
    np.testing.assert_array_equal(f_with, f_without)


@pytest.mark.parametrize("name,threads", [("benzene", 32), ("ribbon_h", 96),
                                          ("flagship", 288)])
def test_launch_plan(name, threads):
    p = _pack(_driver(name))
    plan = K5.launch_plan(p)
    assert plan["items"] == p["nc"] + p["npair"] + p["noop"]
    assert plan["threads"] == threads <= K5.MAX_THREADS
    assert plan["threads"] >= min(max(plan["items"], p["na"]),
                                  K5.MAX_THREADS)
    assert plan["smem_bytes"] == 4 * (-(-3 * p["na"] // 4) * 4
                                      + 3 * p["nslots"]
                                      + K5.MAX_THREADS // 32)
    assert plan["smem_bytes"] <= K5.SMEM_LIMIT


def test_launch_plan_refuses_what_does_not_fit():
    p = _pack(_driver("benzene"))
    with pytest.raises(ValueError, match="shared memory"):
        K5.launch_plan(dict(p, nslots=30000))
    many = K5.launch_plan(dict(p, nc=2000))
    assert many["threads"] == K5.MAX_THREADS


def test_work_counts_of_the_flagship():
    """What one evaluation needs on the flagship geometry: 171 rows of 8
    with 656 entries, 452 pairs inside the cutoff, 790 angular terms."""
    w = K5.work_counts(_pack(_driver("flagship")))
    assert (w["entries"], w["pairs"], w["triples"]) == (656, 452, 790)
    assert w["bytes"] == 2 * 4 * 603
    assert 1e5 < w["ops"] < 3e5


def test_cell_and_wide_tables_raise():
    x0 = graphene_ribbon(3, 3)
    cell = np.array([x0[:, 0].max() + 1.42, 40.0, 20.0])
    axyz = TH.terminate_with_h([["C", *row] for row in x0], cell=cell)
    drv = TH.CHDriver(axyz, cell=cell, device="cpu")
    with pytest.raises(NotImplementedError, match="periodic"):
        _pack(drv)
    assert drv.kernel.cuda is None
    # the twin serves the cell on the CPU
    assert torch.isfinite(drv.force_torch(torch.zeros(
        (2, 3 * len(axyz)), dtype=torch.float64))).all()
    wide = TH.CHDriver(ribbon_h(), cutoff_skin=2.5, device="cpu")
    assert wide.energy_fn.terms["nbr_c"].shape[1] > K5.MAX_NN
    with pytest.raises(ValueError, match="exceeds"):
        _pack(wide)


def test_wrapper_takes_the_twin_for_cpu_tensors_only():
    """A CPU tensor goes to the twin and counts no launch; the kernel's
    class refuses to be built off the card."""
    drv = _driver("benzene")
    before = K5.launches
    q = torch.zeros((3, 36), dtype=torch.float64)
    e, f = drv.energy_force_torch(q)
    assert K5.launches == before and e.shape == (3,) and f.shape == (3, 36)
    assert torch.equal(f, drv.kernel.plain(q))
    with pytest.raises(ValueError, match="CUDA"):
        K5.CHForceCuda(_pack(drv), "cpu")
    K5.reset_count()
    assert K5.launches == 0
