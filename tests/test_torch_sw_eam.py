"""Parity of the port's Stillinger-Weber and EAM potentials and drivers
with the JAX package, on the CPU in float64, and the formulas of kernels
K9 (``kernels.sw_force``) and K10 (``kernels.eam_force``) in numpy.

The same positions (a geometry plus a displacement from a numpy seed)
and the same neighbour table go through each ``sclmd_tpu.models``
energy function and its counterpart in ``sclmd_tpu_torch.models``;
energies and forces (``jax.grad`` against ``torch.autograd``) agree to
rtol 1e-10 of the largest: both sides evaluate the same formulas in
float64 and differ only in the order of their sums. Tables truncated
below their occupancy (not symmetric) are included. The kernels' numpy
formulas (the analytic gradient over the slot table, as the CUDA code
computes it) agree with the autograd twin to 1e-12. The rest mirrors
the physics checks of tests/test_sw.py and tests/test_eam.py on the
port.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sclmd_tpu.models import eam as JE
from sclmd_tpu.models import sw as JS
from sclmd_tpu.models.nnp import build_neighbors as j_build_neighbors

from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.convert import from_jax_driver
from sclmd_tpu_torch.kernels import eam_force as K10
from sclmd_tpu_torch.kernels import slots
from sclmd_tpu_torch.kernels import sw_force as K9
from sclmd_tpu_torch.models import eam as TE
from sclmd_tpu_torch.models import sw as TS
from sclmd_tpu_torch.models.nnp import build_neighbors, smooth_switch

torch.set_num_threads(2)

RTOL = 1e-10
SI_RCUT = TS.SW_PARAMS["Si"]["a"] * TS.SW_PARAMS["Si"]["sigma"]


def _displaced(pos, amp=0.05, seed=0):
    return pos + amp * np.random.default_rng(seed).normal(size=pos.shape)


def _parity(jfn, tfn, x):
    """Energy and force of the JAX and the port's function at x (na, 3)
    agree to RTOL of the largest."""
    xj = jnp.asarray(x)
    ej, gj = float(jfn(xj)), np.asarray(jax.grad(jfn)(xj))
    xt = torch.as_tensor(x).requires_grad_(True)
    et = tfn(xt)
    gt, = torch.autograd.grad(et, xt)
    assert abs(float(et.detach()) - ej) <= RTOL * abs(ej)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=RTOL * np.abs(gj).max())
    assert np.abs(gj).max() > 1e-3          # a displaced, loaded geometry


def _table(pos, rcut, nn, cell, skin=0.4):
    nbr, mask = build_neighbors(pos, rcut, nn, cell=cell, skin=skin)
    jn, jm = j_build_neighbors(pos, rcut, nn, cell=cell, skin=skin)
    assert np.array_equal(nbr, jn) and np.array_equal(mask, jm)
    return nbr, mask


def _asymmetric(nbr, mask):
    pairs = {(i, int(j)) for i in range(len(nbr))
             for j, m in zip(nbr[i], mask[i]) if m}
    return any((j, i) not in pairs for i, j in pairs)


# --- Stillinger-Weber -------------------------------------------------------
@pytest.mark.parametrize("element", ["Si", "Ge"])
@pytest.mark.parametrize("geom", ["periodic", "open", "truncated"])
def test_sw_energy_matches_jax(element, geom):
    """diamond_cell(2, 2, 2), periodic in its cell or open, and periodic
    with a table of 10 (below the 16 neighbours within the cutoff and
    skin: not symmetric)."""
    pos, cell = TS.diamond_cell(2, 2, 2)
    jpos, jcell = JS.diamond_cell(2, 2, 2)
    assert np.array_equal(pos, jpos) and np.array_equal(cell, jcell)
    p = TS.SW_PARAMS[element]
    rcut = p["a"] * p["sigma"]
    cell = None if geom == "open" else cell
    nbr, mask = _table(pos, rcut, 10 if geom == "truncated" else 16, cell)
    if geom == "truncated":
        assert _asymmetric(nbr, mask)
    x = _displaced(pos, 0.1)
    _parity(JS.sw_energy(element, nbr, mask, cell=cell),
            TS.sw_energy(element, nbr, mask, cell=cell), x)


def test_sw_powi_matches_jax():
    x = np.linspace(0.3, 2.0, 7)
    for e in (0, 1, 4, 7, 16, 2.5):
        np.testing.assert_allclose(
            TS._powi(torch.as_tensor(x), e).numpy(),
            np.asarray(JS._powi(jnp.asarray(x), e)), rtol=1e-15)


@pytest.fixture(scope="module")
def si_diamond():
    pos, cell = TS.diamond_cell(2, 2, 2)
    nbr, mask = build_neighbors(pos, SI_RCUT, 16, cell=cell)
    return pos, cell, TS.sw_energy("Si", nbr, mask, cell=cell)


def test_sw_cohesive_energy(si_diamond):
    """Published SW-silicon cohesive energy: -4.3364 eV/atom at
    a0 = 5.431 (Stillinger & Weber 1985)."""
    pos, _, efn = si_diamond
    assert float(efn(torch.as_tensor(pos))) / len(pos) == \
        pytest.approx(-4.3364, abs=2e-3)


def test_sw_equilibrium_forces_vanish(si_diamond):
    pos, _, efn = si_diamond
    x = torch.as_tensor(pos).requires_grad_(True)
    g, = torch.autograd.grad(efn(x), x)
    assert float(g.abs().max()) < 1e-10


def test_sw_lattice_constant_is_minimum(si_diamond):
    pos, _, efn = si_diamond
    e0 = float(efn(torch.as_tensor(pos)))
    for s in (0.99, 1.01):
        pos2, cell2 = TS.diamond_cell(2, 2, 2, a0=5.431 * s)
        nbr2, mask2 = build_neighbors(pos2, SI_RCUT, 16, cell=cell2)
        e2 = float(TS.sw_energy("Si", nbr2, mask2, cell=cell2)(
            torch.as_tensor(pos2)))
        assert e2 > e0 + 1e-3


def test_sw_cutoff_is_hard_zero():
    """phi2 and phi3 vanish at r >= a sigma, and so does the kernel's
    formula."""
    pos = np.array([[0.0, 0.0, 0.0], [SI_RCUT + 1e-6, 0.0, 0.0]])
    nbr, mask = build_neighbors(pos, SI_RCUT, 4)
    efn = TS.sw_energy("Si", nbr, mask)
    assert float(efn(torch.as_tensor(pos))) == 0.0
    pack = K9.pack_operands(efn.terms, pos, np.ones(6))
    e, f = K9.analytic_force_numpy(pack, np.zeros((1, 6)))
    assert e[0] == 0.0 and not f.any()


# --- EAM --------------------------------------------------------------------
def test_smooth_switch_matches_jax():
    from sclmd_tpu.models.nnp import smooth_switch as j_switch
    r = np.linspace(3.0, 6.5, 50)
    np.testing.assert_allclose(
        smooth_switch(torch.as_tensor(r), 5.0, 6.0).numpy(),
        np.asarray(j_switch(jnp.asarray(r), 5.0, 6.0)), rtol=0,
        atol=1e-14)


@pytest.mark.parametrize("element", sorted(TE.SUTTON_CHEN_PARAMS))
def test_sutton_chen_energy_matches_jax(element):
    """Every published set: fcc_cell(2, 2, 2) open at the default cutoff
    1.7 a, and fcc_cell(3, 3, 3) periodic at 1.4 a."""
    p = TE.SUTTON_CHEN_PARAMS[element]
    assert p == JE.SUTTON_CHEN_PARAMS[element]
    for n, periodic, rc in ((2, False, None), (3, True, 1.4 * p["a"])):
        pos, cell = TE.fcc_cell(n, n, n, p["a"])
        assert np.array_equal(pos, JE.fcc_cell(n, n, n, p["a"])[0])
        cell = cell if periodic else None
        rcut = 1.7 * p["a"] if rc is None else rc
        nbr, mask = _table(pos, rcut, None, cell, skin=0.3)
        x = _displaced(pos, 0.05, seed=n)
        _parity(JE.sutton_chen_energy(element, nbr, mask, cell=cell,
                                      rcut=rc),
                TE.sutton_chen_energy(element, nbr, mask, cell=cell,
                                      rcut=rc), x)


def test_sutton_chen_truncated_table_matches_jax():
    p = TE.SUTTON_CHEN_PARAMS["Au"]
    pos, cell = TE.fcc_cell(3, 3, 3, p["a"])
    nbr, mask = _table(pos, 5.5, 30, cell, skin=0.3)
    assert _asymmetric(nbr, mask)
    x = _displaced(pos, 0.08)
    _parity(JE.sutton_chen_energy("Au", nbr, mask, cell=cell, rcut=5.5),
            TE.sutton_chen_energy("Au", nbr, mask, cell=cell, rcut=5.5), x)


def _alloy(els, rcut=5.5):
    """Setfl arrays of the Sutton-Chen sets of ``els`` on one grid, the
    cross pair the mean of the two (port's tables)."""
    tabs = [TE.sutton_chen_tables(e, rcut=rcut, rho_max=600.0, nr=500,
                                  nrho=500) for e in els]
    rphi = [tabs[0]["rphi"][0]]
    if len(els) == 2:
        rphi += [0.5 * (tabs[0]["rphi"][0] + tabs[1]["rphi"][0]),
                 tabs[1]["rphi"][0]]
    t = tabs[0]
    return dict(elements=list(els),
                mass=[TE.U.AtomicMassTable[e] for e in els],
                F=np.concatenate([x["F"] for x in tabs]),
                rho=np.concatenate([x["rho"] for x in tabs]),
                rphi=np.stack(rphi), drho=t["drho"], dr=t["dr"],
                cutoff=t["cutoff"])


@pytest.fixture(params=[("Cu",), ("Cu", "Ag")], ids=["one", "two"])
def setfl(request, tmp_path):
    """A setfl file written by the port's write_setfl."""
    path = tmp_path / "alloy.eam.alloy"
    TE.write_setfl(str(path), **_alloy(request.param))
    return request.param, str(path)


def test_setfl_round_trip_reads_the_same_in_both(setfl):
    els, path = setfl
    mine, theirs = TE.read_setfl(path), JE.read_setfl(path)
    assert mine["elements"] == theirs["elements"] == list(els)
    for k in ("F", "rho", "rphi", "pair_index", "mass"):
        assert np.array_equal(mine[k], theirs[k]), k
    src = _alloy(els)
    np.testing.assert_allclose(mine["rphi"], src["rphi"], rtol=1e-12)
    assert mine["nr"] == 500 and mine["pair_index"].shape == (len(els),) * 2


@pytest.mark.parametrize("nn", [None, 30])
def test_eam_tabulated_energy_matches_jax(setfl, nn):
    """One and two elements (alternating on the fcc sites), the table
    read by each package from the same file; the full table and one
    truncated to 30."""
    els, path = setfl
    pos, cell = TE.fcc_cell(3, 3, 3, 3.61)
    types = np.arange(len(pos)) % len(els)
    nbr, mask = _table(pos, 5.5, nn, cell, skin=0.3)
    if nn:
        assert _asymmetric(nbr, mask)
    x = _displaced(pos, 0.05, seed=len(els))
    _parity(JE.eam_tabulated_energy(JE.read_setfl(path), types, nbr, mask,
                                    cell=cell),
            TE.eam_tabulated_energy(TE.read_setfl(path), types, nbr, mask,
                                    cell=cell), x)


def test_natural_cubic_coefs_and_spline_eval_match_jax():
    """The splines (coefficients bitwise; evaluation past the last knot
    extrapolates on the end segment)."""
    y = np.sin(np.linspace(0.0, 3.0, 40)) + 0.1 * np.arange(40) ** 0.5
    c = TE._natural_cubic_coefs(y, 0.1)
    assert np.array_equal(c, JE._natural_cubic_coefs(y, 0.1))
    x = np.linspace(-0.05, 4.5, 90)
    sel = np.zeros(90, np.int64)
    np.testing.assert_allclose(
        TE._spline_eval(torch.as_tensor(c[None]), 0.1, torch.as_tensor(x),
                        torch.as_tensor(sel)).numpy(),
        np.asarray(JE._spline_eval(jnp.asarray(c[None]), 0.1,
                                   jnp.asarray(x), jnp.asarray(sel))),
        rtol=1e-14)


def test_sutton_chen_tables_match_jax():
    for k, v in TE.sutton_chen_tables("Au").items():
        w = JE.sutton_chen_tables("Au")[k]
        assert np.array_equal(np.asarray(v), np.asarray(w)), k


def _small_cu(rcut=None):
    """2x2x2 periodic Cu cell; rcut covering the first fcc shell only."""
    a0 = TE.SUTTON_CHEN_PARAMS["Cu"]["a"]
    pos, cell = TE.fcc_cell(2, 2, 2, a0)
    return [["Cu"] + list(p) for p in pos], cell, \
        (0.9 * a0 if rcut is None else rcut)


def test_eam_driver_protocol():
    axyz, cell, rc = _small_cu()
    drv = TE.EAMDriver(axyz, cell=cell, rcut=rc, device="cpu")
    n = 3 * len(axyz)
    np.testing.assert_allclose(drv.f0.numpy(), 0.0, atol=1e-9)
    q = np.zeros(n)
    q[0] = 0.01
    f = drv.force(q).numpy()
    assert f.shape == (n,) and np.isfinite(f).all() and f[0] < 0.0


def test_eam_cohesion_and_equilibrium_lattice():
    """Energy per atom is minimised within 2% of the published
    Sutton-Chen lattice constant, and the cohesive energy is in the
    fitted range (Cu: about -3.5 eV/atom)."""
    p = TE.SUTTON_CHEN_PARAMS["Cu"]
    scales = np.linspace(0.94, 1.06, 13)
    epa = []
    for s in scales:
        pos, cell = TE.fcc_cell(4, 4, 4, s * p["a"])
        drv = TE.EAMDriver([["Cu"] + list(x) for x in pos], cell=cell,
                           device="cpu")
        epa.append(drv.energy() / len(pos))
    epa = np.array(epa)
    assert abs(scales[np.argmin(epa)] - 1.0) <= 0.02, epa
    assert -4.2 < epa.min() < -2.8, epa.min()


def test_eam_dynmat_translation_invariance():
    axyz, cell, rc = _small_cu()
    d = TE.EAMDriver(axyz, cell=cell, rcut=rc, device="cpu").dynmat().numpy()
    np.testing.assert_allclose(d, d.T, atol=1e-10)
    for ax in range(3):
        v = np.zeros(3 * len(axyz))
        v[ax::3] = 1.0
        assert np.abs(d @ v).max() / np.abs(d).max() < 1e-8


def test_eam_nve_energy_conservation():
    """512 plain steps without baths conserve the total energy."""
    axyz, cell, rc = _small_cu()
    drv = TE.EAMDriver(axyz, cell=cell, rcut=rc, device="cpu")
    nph = 3 * len(axyz)
    system = TMD.GLESystem(dyn=None, baths=(), mask=torch.ones(
        nph, dtype=torch.float64), dt=0.05, nph=nph, ml=1, nmd=512,
        force_fn=drv.force_torch)
    st = TMD.initial_state(system, 1, dtype=torch.float64)
    st = st.replace(p=torch.as_tensor(0.02 * np.random.default_rng(
        3).normal(size=(1, nph))))

    def etot(s):
        return 0.5 * float((s.p * s.p).sum()) + \
            drv.energy(s.q[0].numpy()) - drv.energy()

    e0 = etot(st)
    fin, _ = TMD.run_segment(system, st, 512)
    assert torch.isfinite(fin.q).all()
    assert abs(etot(fin) - e0) < 2e-3 * max(abs(e0), 1e-3)


def test_eam_driver_refuses_setfl_with_rcut_or_params():
    axyz, cell, _ = _small_cu()
    tbl = TE.sutton_chen_tables("Cu", rcut=3.2)
    for kw in (dict(rcut=3.0), dict(params=TE.SUTTON_CHEN_PARAMS["Cu"])):
        with pytest.raises(ValueError, match="setfl"):
            TE.EAMDriver(axyz, setfl=tbl, cell=cell, device="cpu", **kw)
    with pytest.raises(ValueError, match="lacks"):
        TE.EAMDriver([["Ag", 0.0, 0.0, 0.0]], setfl=tbl, device="cpu")
    with pytest.raises(NotImplementedError):
        TE.EAMDriver([["Cu", 0.0, 0.0, 0.0], ["Ag", 2.5, 0.0, 0.0]],
                     device="cpu")


# --- drivers across packages ------------------------------------------------
def _driver_parity(jdrv, tdrv, seed=4):
    q = 0.05 * np.random.default_rng(seed).normal(size=3 * len(jdrv.axyz)) \
        / np.asarray(jdrv.conv)
    fj = np.asarray(jdrv.force(q))
    np.testing.assert_allclose(tdrv.force(q).numpy(), fj, rtol=0,
                               atol=RTOL * np.abs(fj).max())
    assert abs(tdrv.energy(q) - float(jdrv.energy(q))) <= \
        RTOL * abs(float(jdrv.energy(q)))


@pytest.mark.parametrize("case", ["sw", "sw_open", "sc", "tab_one",
                                  "tab_two"])
def test_from_jax_driver(case, tmp_path):
    """SWDriver and EAMDriver (analytic, tabulated with one and two
    elements) carried across: the same table, energy and force; another
    skin (a different table) raises."""
    if case.startswith("sw"):
        pos, cell = JS.diamond_cell(2, 2, 2)
        axyz = [["Si", *p] for p in pos]
        kw = {} if case == "sw_open" else dict(cell=cell)
        jdrv = JS.SWDriver(axyz, max_nnei=12, **kw)
        skin = 1.5
    else:
        pos, cell = JE.fcc_cell(3, 3, 3, 3.61)
        els = ("Cu", "Ag") if case == "tab_two" else ("Cu",)
        axyz = [[els[i % len(els)], *p] for i, p in enumerate(pos)]
        if case == "sc":
            jdrv = JE.EAMDriver(axyz, cell=cell, rcut=5.0)
        else:
            path = tmp_path / "t.eam.alloy"
            TE.write_setfl(str(path), **_alloy(els))
            jdrv = JE.EAMDriver(axyz, cell=cell, setfl=str(path))
        skin = 1.0
    tdrv = from_jax_driver(jdrv, device="cpu")
    assert type(tdrv).__name__ == type(jdrv).__name__
    assert tdrv.dtype == torch.float64
    _driver_parity(jdrv, tdrv)
    with pytest.raises(ValueError, match="differs"):
        from_jax_driver(jdrv, device="cpu", cutoff_skin=skin)


# --- the kernels' formulas --------------------------------------------------
def _formula_case(kind):
    """A float64 CPU driver and its kernel's pack."""
    if kind.startswith("sw"):
        pos, cell = TS.diamond_cell(2, 2, 2)
        kw = dict(max_nnei=10) if kind == "sw_truncated" else {}
        if kind != "sw_open":
            kw["cell"] = cell
        if kind == "sw_real":
            kw["params"] = dict(TS.SW_PARAMS["Si"], p=4.5, q=0.25)
        drv = TS.SWDriver([["Si", *p] for p in pos], device="cpu", **kw)
        return drv, K9.pack_operands(drv.energy_fn.terms, drv.xyz,
                                     drv.conv), K9
    pos, cell = TE.fcc_cell(3, 3, 3, 3.61)
    els = ("Cu", "Ag") if kind == "eam_alloy" else ("Cu",)
    axyz = [[els[i % len(els)], *p] for i, p in enumerate(pos)]
    kw = {} if kind == "eam_open" else dict(cell=cell)
    if kind == "eam_truncated":
        kw["max_nnei"] = 30
    if kind in ("eam_sc", "eam_open", "eam_truncated", "eam_real"):
        kw["rcut"] = 5.5
        if kind == "eam_real":
            kw["params"] = dict(TE.SUTTON_CHEN_PARAMS["Cu"], n=9.5, m=5.75)
    else:
        t = _alloy(els)
        kw["setfl"] = dict(t, nrho=500, nr=500, pair_index=np.array(
            [[0, 1], [1, 2]] if len(els) == 2 else [[0]], np.int32))
    drv = TE.EAMDriver(axyz, device="cpu", **kw)
    return drv, K10.pack_operands(drv.energy_fn.terms, drv.xyz,
                                  drv.conv), K10


@pytest.mark.parametrize("kind", ["sw", "sw_open", "sw_truncated", "sw_real",
                                  "eam_sc", "eam_open", "eam_truncated",
                                  "eam_real", "eam_tab", "eam_alloy"])
def test_kernel_formulas_match_autograd(kind):
    """K9's and K10's arithmetic (numpy, float64, per slot from the
    centre's own row, then the gather) against the autograd twin at
    displacements of 0.1 angstrom rms, truncated tables and powers that
    are not integers (the kernels' powf) included; exactly zero at rest
    with the kernel's own f0."""
    drv, pack, mod = _formula_case(kind)
    q = 0.1 * np.random.default_rng(7).normal(size=(3, 3 * drv.number)) \
        / drv.conv
    e, f = mod.analytic_force_numpy(pack, q)
    qt = torch.as_tensor(q)
    fw = drv._drv._abs_force(qt).numpy()
    ew = drv.energy_torch(qt).detach().numpy()
    np.testing.assert_allclose(f, fw, rtol=0, atol=1e-12 * np.abs(fw).max())
    np.testing.assert_allclose(e, ew, rtol=1e-12)
    _, f0 = mod.analytic_force_numpy(pack, np.zeros((1, 3 * drv.number)))
    _, rest = mod.analytic_force_numpy(pack, np.zeros((2, 3 * drv.number)),
                                       f0=f0[0])
    assert not rest.any()


def test_slot_table_lists_every_slot_twice():
    """Each live entry is one slot, listed once as a tail (in its centre's
    row, whose share the kernel keeps in registers) and once as a head
    (in its neighbour's ``head`` list, which the gather walks), each list
    in rising slot order; the kernel's record holds d0's float32 bits and
    the head; d0 is the minimum-image reference vector."""
    drv, pack, _ = _formula_case("sw_truncated")
    t = drv.energy_fn.terms
    assert pack["ns"] == int(t["mask"].sum())
    assert np.array_equal(np.diff(pack["row_ptr"]), t["mask"].sum(1))
    assert pack["width"] == int(t["mask"].sum(1).max()) == 10
    seen = np.zeros((pack["ns"], 2), int)
    for a in range(pack["na"]):
        tails = np.arange(pack["row_ptr"][a], pack["row_ptr"][a + 1])
        heads = pack["head"][pack["head_ptr"][a]:pack["head_ptr"][a + 1]]
        assert np.all(np.diff(heads) > 0)
        assert (pack["slot_i"][tails] == a).all()
        assert (pack["slot_j"][heads] == a).all()
        seen[tails, 0] += 1
        seen[heads, 1] += 1
    assert (seen == 1).all()
    rec = pack["rec"]
    assert rec.dtype == np.int32 and rec.shape == (pack["ns"], 4)
    assert np.array_equal(rec[:, 3], pack["slot_j"])
    assert np.array_equal(np.ascontiguousarray(rec[:, :3]).view(np.float32),
                          pack["d0"].astype(np.float32))
    x0 = drv.xyz.reshape(-1, 3)
    assert np.linalg.norm(pack["d0"], axis=1).max() < SI_RCUT + 0.4
    d = x0[pack["slot_j"]] - x0[pack["slot_i"]]
    cell = pack["cell"]
    np.testing.assert_allclose(pack["d0"], d - cell * np.round(d / cell),
                               atol=1e-12)


def _jax_energy(kind, drv):
    """The JAX package's energy function on the driver's own table."""
    t = drv.energy_fn.terms
    if kind.startswith("sw"):
        return JS.sw_energy("Si", t["nbr"], t["mask"], cell=t.get("cell"),
                            params=t["params"])
    return JE.sutton_chen_energy("Cu", t["nbr"], t["mask"],
                                 cell=t.get("cell"), params=t["params"],
                                 rcut=t["rcut"],
                                 switch_width=t["rcut"] - t["r_on"])


_LANE_NTRAJ = 65


@functools.lru_cache(maxsize=None)
def _lane_case(kind):
    """A case of ``_formula_case`` at _LANE_NTRAJ trajectories of 0.1
    angstrom rms: the driver, the pack, q, the kernel's slot gradients
    and cutoff tests (numpy), and the JAX force conv F in q's units."""
    drv, pack, mod = _formula_case(kind)
    q = 0.1 * np.random.default_rng(11).normal(
        size=(_LANE_NTRAJ, 3 * drv.number)) / drv.conv
    _, grad, inside = mod.slot_gradients_numpy(pack, q)
    x = drv.xyz.reshape(-1, 3) + (drv.conv * q).reshape(_LANE_NTRAJ, -1, 3)
    fj = -np.asarray(jax.vmap(jax.grad(_jax_energy(kind, drv)))(
        jnp.asarray(x))).reshape(_LANE_NTRAJ, -1) * drv.conv
    return drv, pack, q, grad, inside, fj


@pytest.mark.parametrize("ntraj", [1, 37, _LANE_NTRAJ])
@pytest.mark.parametrize("kind", ["sw", "sw_open", "sw_truncated", "eam_sc",
                                  "eam_open", "eam_truncated"])
def test_lane_gather_matches_gather_and_twins(kind, ntraj):
    """The kernel's route from slot gradients to forces
    (``slots.gather_lanes_numpy``: a trajectory on each lane, g at (3 k +
    c) tp + t for K9, the scalar at k tp + t for K10, the live slots of
    each group, the centres' own shares, the head-only lists, the pad
    lanes of a last group of 1, 5 or 1 of 32) against ``gather_numpy``,
    the autograd twin and the JAX package's gradient, within 1e-12 of the
    largest force in float64; the last trajectory's force alone has the
    same bits as in the batch."""
    drv, pack, q, grad, inside, fj = _lane_case(kind)
    q, grad, inside, fj = q[:ntraj], grad[:ntraj], inside[:ntraj], \
        fj[:ntraj]
    d = None if kind.startswith("sw") else slots.slot_vectors(pack, q)
    f = slots.gather_lanes_numpy(pack, grad, inside, d=d)
    tol = 1e-12 * np.abs(fj).max()
    np.testing.assert_allclose(f, slots.gather_numpy(pack, grad), rtol=0,
                               atol=tol)
    fw = drv._drv._abs_force(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(f, fw, rtol=0, atol=tol)
    np.testing.assert_allclose(f, fj, rtol=0, atol=tol)
    alone = slots.gather_lanes_numpy(pack, grad[-1:], inside[-1:],
                                     d=None if d is None else d[-1:])
    assert np.array_equal(alone[0], f[-1])
    if kind.startswith("sw") and ntraj > 1:
        # second neighbours sit just outside the cutoff: some lanes of a
        # group take a slot that others do not
        took = inside[:32].sum(0)
        assert ((took > 0) & (took < min(ntraj, 32))).any()


def test_work_counts_of_the_diamond_lattice():
    """At rest every silicon has 4 bonds inside the cutoff and 12 ordered
    angular pairs; every copper 12 neighbours inside 3.2 angstrom."""
    _, pack, _ = _formula_case("sw")
    w = K9.work_counts(pack)
    assert w["pairs"] == 4 * pack["na"] and w["triples"] == 12 * pack["na"]
    assert w["bytes"] == 24 * pack["na"] and w["ops"] > 0
    pos, cell = TE.fcc_cell(3, 3, 3, 3.61)
    drv = TE.EAMDriver([["Cu", *p] for p in pos], cell=cell, rcut=3.2,
                       device="cpu")
    w = K10.work_counts(K10.pack_operands(drv.energy_fn.terms, drv.xyz,
                                          drv.conv))
    assert w["inside"] == 12 * len(pos)


def test_float32_drivers_take_the_twin_on_cpu():
    """In float32 on the CPU the drivers route through the kernels'
    wrappers, which take the autograd twin for a CPU tensor; no kernel is
    built."""
    pos, cell = TS.diamond_cell(2, 2, 2)
    drv = TS.SWDriver([["Si", *p] for p in pos], cell=cell,
                      dtype=torch.float32, device="cpu")
    assert isinstance(drv.kernel, slots.KernelForce) and drv.kernel.cuda is None
    q = torch.randn((2, 3 * drv.number)) * 0.01
    assert torch.equal(drv.force_torch(q), drv._drv.force_torch(q))
    e, f = drv.energy_force_torch(q)
    assert e.shape == (2,) and f.shape == q.shape
    d64 = TS.SWDriver([["Si", *p] for p in pos], cell=cell, device="cpu")
    assert d64.kernel is None


def test_powers_that_are_not_integers_keep_the_kernel():
    """A float32 driver whose powers are not small integers still routes
    through its kernel's wrapper (the kernel takes powf: the integer it
    is given is -1, the float the power); whole powers go as integers."""
    pos, cell = TS.diamond_cell(2, 2, 2)
    odd = dict(TS.SW_PARAMS["Si"], p=4.5, q=0.0)
    drv = TS.SWDriver([["Si", *p] for p in pos], cell=cell, params=odd,
                      dtype=torch.float32, device="cpu")
    assert isinstance(drv.kernel, slots.KernelForce)
    par = drv.kernel.pack()["params"]
    assert (par["p"], par["pf"], par["q"], par["qf"]) == (-1, 4.5, 0, 0.0)
    fcc, fcell = TE.fcc_cell(2, 2, 2, 3.61)
    drv = TE.EAMDriver([["Cu", *p] for p in fcc], cell=fcell, rcut=3.2,
                       params=dict(TE.SUTTON_CHEN_PARAMS["Cu"], n=9.5,
                                   m=33.0),
                       dtype=torch.float32, device="cpu")
    assert isinstance(drv.kernel, slots.KernelForce)
    pack = drv.kernel.pack()
    assert (pack["n"], pack["nf"], pack["m"], pack["mf"]) == \
        (-1, 9.5, -1, 33.0)
    whole = TE.EAMDriver([["Cu", *p] for p in fcc], cell=fcell, rcut=3.2,
                         dtype=torch.float32, device="cpu").kernel.pack()
    assert (whole["n"], whole["nf"], whole["m"], whole["mf"]) == \
        (9, 9.0, 6, 6.0)
