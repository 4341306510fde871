"""The host side of kernels K5 and K8 (``kernels.ch_force``) on the CPU:
the packed operands (C/H and Tersoff-only, open and periodic, narrow and
wide tables), the constant block, the launch plan, the work count, what
still raises, and the kernel's analytic gradient written out in numpy
(``analytic_force_numpy``: the formulas of csrc/ch_force.cu, phase by
phase) against the autograd twin, to float64 rounding. No JAX here;
tests/test_torch_models.py holds the same formulas against the JAX
package."""

import os

import numpy as np
import pytest
import torch

from sclmd_tpu_torch.kernels import ch_force as K5
from sclmd_tpu_torch.models import hydrocarbon as TH
from sclmd_tpu_torch.models.tersoff import TERSOFF_PARAMS, graphene_ribbon
from sclmd_tpu_torch.tools.sheet import sheet

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
    ne = p["ne"]
    assert p["nslots"] == ne + p["npair"] + 3 * p["noop"] == \
        len(p["slot_ab"]) == len(p["d0"])
    # the table: its live entries only, row by row in the table's order
    mask = t["mask_c"]
    assert ne == mask.sum()
    np.testing.assert_array_equal(np.diff(p["row_ptr"]), mask.sum(1))
    np.testing.assert_array_equal(p["ent_ab"][:, 1],
                                  t["c_ids"][t["nbr_c"]][mask])
    np.testing.assert_array_equal(p["ent_ab"][:, 0],
                                  t["c_ids"][p["ent_row"]])
    np.testing.assert_array_equal(p["slot_ab"][:ne], p["ent_ab"])
    # the threads' order: a permutation, entries inside the cutoff first
    assert sorted(p["order"]) == list(range(ne))
    r0 = np.linalg.norm(p["d0"][:ne][p["order"]], axis=-1)
    inside = r0 < p["scalars"]["R"] + p["scalars"]["D"]
    assert not (np.diff(inside.astype(int)) > 0).any()
    # bonds first, then springs with their rest lengths
    assert p["nbond"] == len(t["bonds"])
    np.testing.assert_array_equal(p["pair_ab"][:p["nbond"]], t["bonds"])
    np.testing.assert_array_equal(p["pair_ab"][p["nbond"]:], t["aux"])
    np.testing.assert_array_equal(p["pair_r0"][p["nbond"]:], t["aux_r0"])
    # reference vectors are the float64 geometry's differences
    x0 = drv.xyz.reshape(-1, 3)
    ab = p["slot_ab"]
    assert (ab >= 0).all() and not p["cell"].any()
    np.testing.assert_array_equal(p["d0"], x0[ab[:, 1]] - x0[ab[:, 0]])
    # the wag slots: anchor -> H, anchor -> each adjacent
    if p["noop"]:
        w = ab[ne + p["npair"]:].reshape(-1, 3, 2)
        np.testing.assert_array_equal(w[:, :, 0],
                                      np.repeat(t["oop"][:, 1:2], 3, 1))
        np.testing.assert_array_equal(w[:, :, 1], t["oop"][:, [0, 2, 3]])


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_atom_lists_take_every_live_slot_twice(name):
    """Every slot appears once as a tail and once as a head, under the
    atoms it names, in rising slot order (the fixed order of the
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
    assert sorted(seen) == list(range(p["nslots"]))
    assert all(sorted(v) == [0, 1] for v in seen.values())
    assert p["csr_ptr"][-1] == 2 * p["nslots"] == len(p["csr"])


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_constant_block_holds_the_pack(name):
    """The words the kernel stages: each array at its offset, atom pairs
    as a | b << 16, floats by their float32 bits, padded to 16 bytes."""
    p = _pack(_driver(name))
    words, off = K5.const_block(p)
    assert words.dtype == np.int32 and len(words) % 4 == 0
    u = words.view(np.uint32)

    def pairs(k, n):
        w = u[off[k]:off[k] + n]
        return np.stack([w & 0xFFFF, w >> 16], axis=1)

    np.testing.assert_array_equal(pairs("ent_ab", p["ne"]), p["ent_ab"])
    np.testing.assert_array_equal(pairs("pair_ab", p["npair"]),
                                  p["pair_ab"])
    np.testing.assert_array_equal(pairs("oop", 2 * p["noop"]).reshape(-1, 4),
                                  p["oop"])
    np.testing.assert_array_equal(
        words[off["d0"]:off["d0"] + 3 * p["nslots"]].view(np.float32),
        p["d0"].astype(np.float32).ravel())
    np.testing.assert_array_equal(
        words[off["pair_r0"]:off["pair_r0"] + p["npair"]].view(np.float32),
        p["pair_r0"].astype(np.float32))
    for k in ("ent_row", "row_ptr", "order", "csr_ptr", "csr"):
        np.testing.assert_array_equal(words[off[k]:off[k] + len(p[k])],
                                      p[k])
    nph = 3 * p["na"]
    np.testing.assert_array_equal(
        words[off["conv"]:off["conv"] + nph].view(np.float32),
        p["conv"].astype(np.float32))
    assert not words[off["f0"]:off["f0"] + nph].any()
    f0 = np.linspace(-1.0, 1.0, nph)
    np.testing.assert_array_equal(
        K5.const_block(p, f0)[0][off["f0"]:off["f0"] + nph].view(np.float32),
        f0.astype(np.float32))


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


@pytest.mark.parametrize("name,ntraj,threads,tpc,grid", [
    ("benzene", 1, 64, 1, 1), ("ribbon_h", 128, 192, 1, 128),
    ("flagship", 128, 800, 1, 128), ("flagship", 1024, 256, 4, 132),
    ("flagship", 300, 256, 3, 100)])
def test_launch_plan(name, ntraj, threads, tpc, grid):
    """One group per trajectory with a thread per work item (up to 1024)
    while the trajectories are no more than the SMs; beyond, groups of
    256, as
    many to a CTA as the SMs need, and one persistent CTA to an SM."""
    p = _pack(_driver(name))
    plan = K5.launch_plan(p, ntraj)
    assert plan["items"] == max(p["ne"] + p["npair"] + p["noop"], p["na"])
    assert (plan["threads"], plan["tpc"], plan["grid"]) == \
        (threads, tpc, grid)
    assert plan["threads"] * plan["tpc"] <= K5.MAX_THREADS
    assert plan["grid"] * plan["tpc"] >= min(ntraj, K5.H100_SMS)
    words = len(K5.const_block(p)[0])
    assert plan["cwords"] == words
    assert plan["g_off"] >= 2 * p["ne"] and plan["g_off"] >= 3 * p["na"]
    assert plan["s_off"] - plan["g_off"] == 4 * p["ne"]
    assert plan["red_off"] - plan["s_off"] >= 3 * p["nslots"]
    assert plan["smem_bytes"] == 4 * (words + plan["tpc"]
                                      * plan["traj_words"])
    assert plan["smem_bytes"] <= K5.SMEM_LIMIT
    assert plan["place"] == "shared" and plan["work_words"] == 0


def _big(kind, nx, ny):
    """A C/H ribbon or a periodic Tersoff sheet, packed."""
    from sclmd_tpu_torch.models.tersoff import TersoffDriver
    if kind == "ch":
        return _pack(TH.CHDriver(TH.terminate_with_h(
            [["C", *row] for row in graphene_ribbon(nx, ny)]),
            dtype=torch.float32, device="cpu"))
    axyz, cell = sheet(nx, ny)
    d = TersoffDriver(axyz, cell=cell, dtype=torch.float32, device="cpu")
    return K5.pack_tersoff(d.energy_fn.terms, d.xyz, d.conv)


@pytest.mark.parametrize("kind,nx,ny,na,place", [
    ("ch", 24, 6, 346, "shared"), ("ch", 48, 6, 682, "work"),
    ("ch", 90, 6, 1270, "global"), ("t", 16, 8, 256, "shared"),
    ("t", 20, 10, 400, "work"), ("t", 28, 14, 784, "global")])
def test_launch_plan_places_large_systems(kind, nx, ny, na, place):
    """Shared memory holds the constants and the working regions while
    they fit, then the regions alone, then nothing (the kernel reads
    global memory): a large system plans at every batch size, the 1,270
    atoms of the reference's large C/H ribbon included."""
    p = _big(kind, nx, ny)
    assert p["na"] == na
    for ntraj in (1, 128, 1024):
        plan = K5.launch_plan(p, ntraj)
        assert plan["place"] == place
        csm, wsm = K5.PLACES[place]
        assert plan["smem_bytes"] == 4 * (plan["cwords"] * csm + plan["tpc"]
                                          * plan["traj_words"] * wsm)
        assert plan["smem_bytes"] <= K5.SMEM_LIMIT
        assert plan["work_words"] == (0 if wsm else plan["grid"]
                                      * plan["tpc"] * plan["traj_words"])
        assert plan["grid"] * plan["tpc"] >= min(ntraj, K5.H100_SMS)
    if place != "shared":
        with pytest.raises(ValueError, match="shared memory"):
            K5.launch_plan(p, 128, place="shared")


def test_launch_plan_refuses_what_does_not_fit():
    p = _pack(_driver("benzene"))
    with pytest.raises(ValueError, match="shared memory"):
        K5.launch_plan(dict(p, nslots=30000), place="shared")
    assert K5.launch_plan(dict(p, nslots=30000))["place"] == "global"
    with pytest.raises(ValueError, match="groups per CTA"):
        K5.launch_plan(p, 64, tpc=K5.MAX_GROUPS + 1)
    many = K5.launch_plan(p, 100000, threads=32)
    assert many["tpc"] == K5.MAX_GROUPS and many["grid"] == K5.H100_SMS


def test_work_counts_of_the_flagship():
    """What one evaluation needs on the flagship geometry: 171 rows of 8
    with 656 entries, 452 pairs inside the cutoff, 790 angular terms."""
    w = K5.work_counts(_pack(_driver("flagship")))
    assert (w["entries"], w["pairs"], w["triples"]) == (656, 452, 790)
    assert w["bytes"] == 2 * 4 * 603
    assert 1e5 < w["ops"] < 3e5


def _ribbon_cell():
    x0 = graphene_ribbon(3, 3)
    cell = np.array([x0[:, 0].max() + 1.42, 40.0, 20.0])
    return TH.terminate_with_h([["C", *row] for row in x0], cell=cell), cell


def test_cell_and_wide_tables_pack():
    """A periodic cell and a table wider than 16 both pack: minimum-image
    reference vectors, every live entry of the wide rows."""
    axyz, cell = _ribbon_cell()
    drv = TH.CHDriver(axyz, cell=cell, device="cpu")
    p = _pack(drv)
    np.testing.assert_array_equal(p["cell"], cell)
    x0 = drv.xyz.reshape(-1, 3)
    d = x0[p["slot_ab"][:, 1]] - x0[p["slot_ab"][:, 0]]
    np.testing.assert_array_equal(p["d0"], d - np.round(d / cell) * cell)
    assert np.abs(p["d0"]).max() < 2.7 < np.abs(d).max()   # wrapped bonds
    assert K5.launch_plan(p, 128)["smem_bytes"] <= K5.SMEM_LIMIT
    wide = TH.CHDriver(ribbon_h(), cutoff_skin=2.5, device="cpu")
    t = wide.energy_fn.terms
    assert t["nbr_c"].shape[1] > 16
    pw = _pack(wide)
    assert pw["ne"] == t["mask_c"].sum()
    assert np.diff(pw["row_ptr"]).max() == t["mask_c"].sum(1).max() > 16
    assert K5.launch_plan(pw, 1024)["smem_bytes"] <= K5.SMEM_LIMIT


def test_what_the_kernel_does_not_take_raises():
    """A multi-element Tersoff table (K8b) and more shared memory than a
    CTA has raise at packing or planning; float64 on the card raises in
    the wrapper (tests/test_torch_kernels_cuda.py)."""
    from sclmd_tpu_torch.models.tersoff import TersoffDriver
    multi = TersoffDriver([["Si", 0, 0, 0], ["C", 1.85, 0, 0]],
                          dtype=torch.float32, device="cpu")
    assert multi.kernel is None
    with pytest.raises(NotImplementedError, match="multi-element"):
        K5.pack_tersoff(multi.energy_fn.terms, multi.xyz, multi.conv)
    big = _pack(_driver("flagship"))
    with pytest.raises(ValueError, match="shared memory"):
        K5.launch_plan(dict(big, na=20000), place="work")
    n = 65536                           # atom indices are 16 bits wide
    with pytest.raises(ValueError, match="65535"):
        K5.pack_tersoff(dict(nbr=np.zeros((n, 1), int),
                             mask=np.zeros((n, 1), bool),
                             params=TERSOFF_PARAMS["C"]),
                        np.zeros((n, 3)), np.ones(3 * n))
    f64 = TersoffDriver(sheet(4, 3)[0], device="cpu")
    assert f64.kernel is None           # float64 keeps autograd


@pytest.mark.parametrize("case", ["cell", "wide"])
@pytest.mark.parametrize("amp", [0.05, 0.5])
def test_analytic_gradient_cell_and_wide_rows(case, amp):
    """The kernel's formulas against the twin on the periodic sheet (with
    displacements that carry bonds across the cell's face) and on a
    ribbon whose table is 20 wide."""
    if case == "cell":
        axyz, cell = _ribbon_cell()
        drv = TH.CHDriver(axyz, cell=cell, device="cpu")
    else:
        drv = TH.CHDriver(ribbon_h(), cutoff_skin=2.5, device="cpu")
    p = _pack(drv)
    rng = np.random.default_rng(7)
    q = amp / drv.conv.mean() * 0.02 * rng.standard_normal((2, 3 * p["na"]))
    e, f = K5.analytic_force_numpy(p, q, drv.f0.numpy())
    ew, fw = drv.kernel(torch.as_tensor(q), energy=True)
    scale = max(float(fw.abs().max()), float(drv.f0.abs().max()))
    np.testing.assert_allclose(f, fw.numpy(), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(e, ew.numpy(), rtol=1e-11)


@pytest.mark.parametrize("lam3", [0.0, 0.6])
def test_tersoff_pack_and_gradient(lam3):
    """K8's pack on the periodic sheet: every atom a centre, no bonds,
    springs or wag terms; its formulas against the Tersoff twin."""
    from sclmd_tpu_torch.models.tersoff import TersoffDriver
    axyz, cell = sheet(4, 3)
    table = {"C": dict(TERSOFF_PARAMS["C"], lam3=lam3)}
    drv = TersoffDriver(axyz, cell=cell, params=table, dtype=torch.float32,
                        device="cpu")
    assert drv.kernel is not None and drv.kernel.cuda is None
    ref = TersoffDriver(axyz, cell=cell, params=table, device="cpu")
    p = K5.pack_tersoff(ref.energy_fn.terms, ref.xyz, ref.conv)
    assert p["kind"] == "tersoff" and p["nc"] == p["na"] == len(axyz)
    assert p["npair"] == p["noop"] == 0
    assert p["ne"] == ref.energy_fn.terms["mask"].sum()
    # three bonds inside the cutoff per atom; second neighbours (2.46
    # angstrom) sit in the skin
    assert K5.work_counts(p)["pairs"] == 3 * len(axyz) < p["ne"]
    assert p["scalars"]["lam3"] == lam3
    np.testing.assert_array_equal(p["cell"], cell)
    q = 0.5 * np.random.default_rng(3).standard_normal((2, 3 * p["na"]))
    e, f = K5.analytic_force_numpy(p, q, ref.f0.numpy())
    ew, fw = ref.energy_force_torch(torch.as_tensor(q))
    np.testing.assert_allclose(f, fw.numpy(), rtol=0,
                               atol=1e-9 * np.abs(fw.numpy()).max())
    np.testing.assert_allclose(e, ew.numpy(), rtol=1e-11)
    # the float32 driver on the CPU runs the twin and counts no launch
    before = K5.launches_tersoff
    f32 = drv.force_torch(torch.as_tensor(q, dtype=torch.float32))
    assert K5.launches_tersoff == before
    np.testing.assert_allclose(f32.numpy(), fw.numpy(), rtol=0,
                               atol=1e-4 * np.abs(fw.numpy()).max())


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
    assert K5.launches == K5.launches_tersoff == 0
