"""Parity of the port's force drivers and potentials with the JAX
package, on the CPU in float64.

The same positions (a geometry plus a displacement from a numpy seed) go
through each ``sclmd_tpu.models`` energy function and its counterpart in
``sclmd_tpu_torch.models``; energies and forces (``jax.grad`` against
``torch.autograd``) must agree to rtol 1e-10 of the largest force: both
sides evaluate the same formulas in float64 and differ only in the order
of their sums. Hessians (``dynmat``) agree to 1e-9. The rest mirrors the
physics checks of tests/test_tersoff.py and tests/test_hydrocarbon.py on
the port.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sclmd_tpu.models import hydrocarbon as JH
from sclmd_tpu.models import pair as JP
from sclmd_tpu.models import tersoff as JT
from sclmd_tpu.models.harmonic import HarmonicDriver as JHarmonic
from sclmd_tpu.models.nnp import build_neighbors as j_build_neighbors

from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch.convert import from_jax_driver
from sclmd_tpu_torch.models import hydrocarbon as TH
from sclmd_tpu_torch.models import pair as TP
from sclmd_tpu_torch.models import tersoff as TT
from sclmd_tpu_torch.models.driver import HostDriver, TorchDriver
from sclmd_tpu_torch.models.nnp import build_neighbors

torch.set_num_threads(2)

RTOL = 1e-10
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
        [["C", *row] for row in TT.graphene_ribbon(4, 3)])


def flagship():
    z = np.load(NPZ)
    return [[str(e)] + list(map(float, p))
            for e, p in zip(z["els"], z["pos"])]


STRUCTURES = {"benzene": benzene, "ribbon_h": ribbon_h, "flagship": flagship}


def _positions(axyz, seed, amp=0.03):
    x0 = np.array([a[1:] for a in axyz], dtype=float)
    return x0 + amp * np.random.default_rng(seed).standard_normal(x0.shape)


def _jax_ef(fn, x):
    e, g = jax.value_and_grad(fn)(jnp.asarray(x))
    return float(e), -np.asarray(g)


def _torch_ef(fn, x):
    xt = torch.tensor(x, requires_grad=True)
    e = fn(xt)
    g, = torch.autograd.grad(e, xt)
    return float(e.detach()), -g.numpy()


def _assert_ef(jfn, tfn, x):
    ej, fj = _jax_ef(jfn, x)
    et, ft = _torch_ef(tfn, x)
    assert np.isfinite(ft).all()
    scale = np.abs(fj).max()
    assert scale > 0
    np.testing.assert_allclose(ft, fj, rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(et, ej, rtol=RTOL, atol=RTOL * scale)


def _carbons(axyz):
    return np.array([a[1:] for a in axyz if a[0] == "C"], dtype=float)


def _pair_case(name, mod, x0, cell=None):
    pairs = mod.neighbor_pairs(x0, 2.0, skin=0.3, cell=cell)
    if name == "morse":
        return mod.morse_energy(3.0, 1.9, 1.42, 2.0, pairs, cell=cell,
                                shift=True)
    if name == "morse_raw":
        return mod.morse_energy(4.3, 1.885, 1.09, 2.9, pairs, cell=cell)
    if name == "harmonic":
        r0 = 1.3 + 0.01 * np.arange(len(pairs[0]))
        return mod.harmonic_bond_energy(
            4.0, jnp.asarray(r0) if mod is JP else r0, pairs, cell=cell)
    if name == "lj":
        return mod.lennard_jones_energy(0.05, 1.3, 2.0, pairs, cell=cell)
    if name == "lj_mixed":
        n = len(pairs[0])
        return mod.lennard_jones_energy(
            0.05 + 0.001 * np.arange(n), 1.3 + 0.002 * np.arange(n), 2.0,
            pairs, cell=cell, shift=False)
    if name == "sum":
        return mod.sum_energies(
            mod.morse_energy(3.0, 1.9, 1.42, 2.0, pairs),
            mod.lennard_jones_energy(0.05, 1.3, 2.0, pairs))
    raise KeyError(name)


@pytest.mark.parametrize("structure", list(STRUCTURES))
@pytest.mark.parametrize("name", ["morse", "morse_raw", "harmonic", "lj",
                                  "lj_mixed", "sum"])
def test_pair_energies_match_jax(name, structure):
    axyz = STRUCTURES[structure]()
    x0 = np.array([a[1:] for a in axyz], dtype=float)
    _assert_ef(_pair_case(name, JP, x0), _pair_case(name, TP, x0),
               _positions(axyz, 1))


def test_pair_energy_with_cell_matches_jax():
    """Minimum-image displacements across an orthorhombic box."""
    x0 = TT.graphene_ribbon(3, 2)
    cell = np.array([x0[:, 0].max() + 1.42, x0[:, 1].max() + 1.23, 20.0])
    ij, it = (m.neighbor_pairs(x0, 2.0, cell=cell) for m in (JP, TP))
    assert np.array_equal(ij[0], it[0]) and np.array_equal(ij[1], it[1])
    x = x0 + 0.03 * np.random.default_rng(2).standard_normal(x0.shape)
    _assert_ef(_pair_case("morse", JP, x0, cell),
               _pair_case("morse", TP, x0, cell), x)


@pytest.mark.parametrize("structure", list(STRUCTURES))
@pytest.mark.parametrize("max_nnei", [None, 3, 8])
def test_build_neighbors_tables_equal(structure, max_nnei):
    x0 = _carbons(STRUCTURES[structure]())
    (nj, mj), (nt, mt) = (f(x0, 2.1, max_nnei, skin=0.4)
                          for f in (j_build_neighbors, build_neighbors))
    assert np.array_equal(nj, nt) and np.array_equal(mj, mt)


def test_build_neighbors_cell_and_backends():
    x0 = TT.graphene_ribbon(3, 2)
    cell = np.array([x0[:, 0].max() + 1.42, x0[:, 1].max() + 1.23, 20.0])
    (nj, mj), (nt, mt) = (f(x0, 2.1, None, cell=cell, skin=0.4)
                          for f in (j_build_neighbors, build_neighbors))
    assert np.array_equal(nj, nt) and np.array_equal(mj, mt)
    assert mt.sum(1).min() >= 3          # the box closes the edges
    with pytest.raises(NotImplementedError):
        build_neighbors(x0, 2.1, 8, backend="native")
    with pytest.raises(ValueError):
        build_neighbors(x0, 2.1, 8, backend="gpu")


@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_tersoff_energy_matches_jax(structure):
    axyz = STRUCTURES[structure]()
    x0 = _carbons(axyz)
    nbr, mask = build_neighbors(x0, 2.1, None, skin=0.4)
    x = x0 + 0.03 * np.random.default_rng(3).standard_normal(x0.shape)
    _assert_ef(JT.tersoff_energy("C", nbr, mask),
               TT.tersoff_energy("C", nbr, mask), x)


def test_tersoff_energy_lam3_and_cell_match_jax():
    """A parameter set with the lam3 exponential on, in a periodic box."""
    x0 = TT.graphene_ribbon(3, 2)
    cell = np.array([x0[:, 0].max() + 1.42, x0[:, 1].max() + 1.23, 20.0])
    p = dict(TT.TERSOFF_PARAMS["C"], lam3=0.7)
    nbr, mask = build_neighbors(x0, 2.1, None, cell=cell, skin=0.4)
    x = x0 + 0.03 * np.random.default_rng(4).standard_normal(x0.shape)
    _assert_ef(JT.tersoff_energy("C", nbr, mask, cell=cell, params=p),
               TT.tersoff_energy("C", nbr, mask, cell=cell, params=p), x)


@pytest.mark.parametrize("lam3", [0.0, 0.4])
def test_tersoff_energy_multi_matches_jax(lam3):
    """A Si/C cluster with the 1989 mixing rules."""
    rng = np.random.default_rng(5)
    x0 = np.array([[0, 0, 0], [1.9, 0, 0], [0.95, 1.65, 0], [0.95, 0.55, 1.55],
                   [2.85, 1.65, 0.2], [-0.9, 1.6, 0.3]], dtype=float)
    els = ["Si", "C", "Si", "C", "C", "Si"]
    table = {e: dict(TT.TERSOFF_PARAMS[e], lam3=lam3) for e in ("Si", "C")}
    nbr, mask = build_neighbors(x0, 3.0, None, skin=0.4)
    x = x0 + 0.03 * rng.standard_normal(x0.shape)
    _assert_ef(JT.tersoff_energy_multi(els, nbr, mask, params=table),
               TT.tersoff_energy_multi(els, nbr, mask, params=table), x)


@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_ch_energy_matches_jax(structure):
    axyz = STRUCTURES[structure]()
    (jfn, jb), (tfn, tb) = JH.ch_energy(axyz), TH.ch_energy(axyz)
    assert np.array_equal(np.asarray(jb), tb)
    _assert_ef(jfn, tfn, _positions(axyz, 6))


def test_ch_energy_with_cell_and_options_matches_jax():
    x0 = TT.graphene_ribbon(3, 3)
    cell = np.array([x0[:, 0].max() + 1.42, 40.0, 20.0])
    axyz = TH.terminate_with_h([["C", *row] for row in x0], cell=cell)
    kw = dict(cell=cell, k_bend=3.0, k_oop=1.5,
              morse=dict(D=4.0, r0=1.1, alpha=1.8, cutoff=1.8))
    (jfn, _), (tfn, _) = JH.ch_energy(axyz, **kw), TH.ch_energy(axyz, **kw)
    _assert_ef(jfn, tfn, _positions(axyz, 7))


def _kernel_force_against_jax(pack, jfn, x0, conv, seed, amp=0.05):
    """The K5/K8 kernel's formulas (``analytic_force_numpy``, float64)
    against ``jax.grad`` of the JAX energy at the same positions: 1e-9
    of the largest force (the published g(theta) of both twins costs a
    few digits near cos = h)."""
    from sclmd_tpu_torch.kernels.ch_force import analytic_force_numpy
    rng = np.random.default_rng(seed)
    q = amp * rng.standard_normal((2, x0.size)) / conv
    for qt, (e, f) in zip(q, zip(*analytic_force_numpy(pack, q))):
        ej, fj = _jax_ef(jfn, x0 + (conv * qt).reshape(x0.shape))
        want = conv * fj.ravel()
        np.testing.assert_allclose(f, want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
        np.testing.assert_allclose(e, ej, rtol=1e-11)


@pytest.mark.parametrize("case", ["cell", "wide"])
def test_ch_kernel_formulas_match_jax(case):
    """The periodic graphene_ribbon(3, 3) sheet with its cell (minimum
    images across the x face), and the ribbon at cutoff_skin 2.5 (a
    carbon table 20 wide): both now pack for the kernel."""
    from sclmd_tpu_torch.kernels.ch_force import pack_operands
    if case == "cell":
        x0 = TT.graphene_ribbon(3, 3)
        cell = np.array([x0[:, 0].max() + 1.42, 40.0, 20.0])
        axyz = TH.terminate_with_h([["C", *row] for row in x0], cell=cell)
        kw = dict(cell=cell)
    else:
        axyz, kw = ribbon_h(), dict(cutoff_skin=2.5)
    drv = TH.CHDriver(axyz, device="cpu", **kw)
    if case == "wide":
        assert drv.energy_fn.terms["nbr_c"].shape[1] > 16
    jfn, _ = JH.ch_energy(axyz, **kw)
    pack = pack_operands(drv.energy_fn.terms, drv.xyz, drv.conv)
    _kernel_force_against_jax(pack, jfn, drv.xyz.reshape(-1, 3), drv.conv,
                              8, amp=0.08)


@pytest.mark.parametrize("lam3", [0.0, 0.7])
def test_tersoff_kernel_formulas_match_jax(lam3):
    """K8's pack (every atom a centre) on a periodic sheet with its lattice
    cell, the published carbon set and one with the lam3 exponential on,
    against jax.grad of the JAX ``tersoff_energy``."""
    from sclmd_tpu_torch.kernels.ch_force import pack_tersoff
    from sclmd_tpu_torch.tools.sheet import sheet
    axyz, cell = sheet(4, 3)
    x0 = np.array([a[1:] for a in axyz])
    p = dict(TT.TERSOFF_PARAMS["C"], lam3=lam3)
    nbr, mask = build_neighbors(x0, 2.1, None, cell=cell, skin=0.4)
    terms = TT.tersoff_energy("C", nbr, mask, cell=cell, params=p).terms
    conv = np.full(x0.size, 0.7)
    pack = pack_tersoff(terms, x0.ravel(), conv)
    _kernel_force_against_jax(
        pack, JT.tersoff_energy("C", nbr, mask, cell=cell, params=p), x0,
        conv, 9)


def test_energy_functions_are_batched():
    """Leading axes are the trajectory batch: the batch's energies and
    forces equal each member's own."""
    axyz = ribbon_h()
    tfn, _ = TH.ch_energy(axyz)
    xs = np.stack([_positions(axyz, s) for s in range(3)])
    xt = torch.tensor(xs, requires_grad=True)
    e = tfn(xt)
    g, = torch.autograd.grad(e.sum(), xt)
    assert e.shape == (3,)
    for k in range(3):
        ek, fk = _torch_ef(tfn, xs[k])
        assert abs(float(e[k]) - ek) < 1e-12 * abs(ek)
        np.testing.assert_allclose(-g[k].numpy(), fk, rtol=0, atol=1e-12)


# --- drivers ---------------------------------------------------------------
def _jax_drivers():
    c8 = [["C", *row] for row in JT.graphene_ribbon(2, 2)]
    return {
        "ch": lambda: JH.CHDriver(ribbon_h()),
        "tersoff": lambda: JT.TersoffDriver(
            [["C", *row] for row in JT.graphene_ribbon(3, 2)]),
        "tersoff_sic": lambda: JT.TersoffDriver(
            [["Si", 0, 0, 0], ["C", 1.85, 0, 0]]),
        "pair_morse": lambda: JP.PairDriver(
            c8, kind="morse", params=dict(D=1.0, alpha=2.0, r0=1.4)),
        "pair_lj": lambda: JP.PairDriver(
            c8, kind="lj", params=dict(epsilon=0.1, sigma=1.3)),
    }


@pytest.mark.parametrize("kind", ["ch", "tersoff", "tersoff_sic",
                                  "pair_morse", "pair_lj"])
def test_from_jax_driver_protocol(kind):
    """The converted driver computes the JAX driver's forces, energy and
    positions, batched and single."""
    jd = _jax_drivers()[kind]()
    td = from_jax_driver(jd, device="cpu")
    nph = 3 * jd.number
    assert td.number == jd.number and td.els == jd.els
    np.testing.assert_allclose(td.conv, jd.conv)
    q = 0.2 * np.random.default_rng(8).standard_normal((2, nph))
    fj = np.stack([np.asarray(jd.force(r)) for r in q])
    scale = np.abs(fj).max()
    for got in (td.force_torch(torch.as_tensor(q)).numpy(),
                np.stack([td.force(r).numpy() for r in q])):
        np.testing.assert_allclose(got, fj, rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(td.f0.numpy(), np.asarray(jd.f0), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(td.absforce(q[0]).numpy(),
                               np.asarray(jd.absforce(q[0])), rtol=0,
                               atol=1e-10)
    assert abs(td.energy(q[0]) - jd.energy(q[0])) < 1e-10 * abs(jd.energy())
    assert abs(td.energy() - jd.energy()) < 1e-10 * abs(jd.energy())
    np.testing.assert_allclose(td.newx(q[0]), jd.newx(q[0]))
    np.testing.assert_allclose(
        td.energy_torch(torch.as_tensor(q)).numpy(),
        [jd.energy(r) for r in q], rtol=1e-10)


def test_from_jax_driver_harmonic_and_mismatch():
    from sclmd_tpu.models.harmonic import chain_dynmat
    jd = JHarmonic(chain_dynmat(6, 0.1), dtype=jnp.float64)
    td = from_jax_driver(jd, device="cpu")
    q = np.random.default_rng(9).standard_normal((3, 6))
    np.testing.assert_allclose(
        td.force_torch(torch.as_tensor(q)).numpy(),
        np.stack([np.asarray(jd.force(jnp.asarray(r))) for r in q]),
        rtol=1e-13)
    # a driver built with another skin than the default cannot be read
    # back from its closure: the table check says so
    jd = JH.CHDriver(ribbon_h(), cutoff_skin=0.1)
    with pytest.raises(ValueError, match="skin"):
        from_jax_driver(jd, device="cpu")
    td = from_jax_driver(jd, device="cpu", cutoff_skin=0.1)
    assert td.energy_fn.terms["nbr_c"].shape[1] == 4
    with pytest.raises(TypeError):
        from_jax_driver(object(), device="cpu")


@pytest.mark.parametrize("kind", ["ch", "tersoff"])
def test_dynmat_full_blocked_and_jax(kind):
    """The full Hessian, its 16-row blocks of Hessian-vector products and
    the JAX driver's agree (1e-9 of the largest element)."""
    jd = _jax_drivers()[kind]()
    td = from_jax_driver(jd, device="cpu")
    full = td.dynmat().numpy()
    blocked = td.dynmat(chunk=16).numpy()
    ref = np.asarray(jd.dynmat())
    scale = np.abs(ref).max()
    np.testing.assert_allclose(full, full.T, atol=1e-14)
    np.testing.assert_allclose(blocked, full, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(full, ref, rtol=0, atol=1e-9 * scale)
    q = 0.05 * np.random.default_rng(10).standard_normal(full.shape[0])
    np.testing.assert_allclose(td.dynmat(q).numpy(),
                               np.asarray(jd.dynmat(q)), rtol=0,
                               atol=1e-9 * scale)


def test_dynmat_is_float64_for_a_float32_driver():
    axyz = ribbon_h()
    d32 = TH.CHDriver(axyz, dtype=torch.float32, device="cpu")
    d64 = TH.CHDriver(axyz, device="cpu")
    h = d32.dynmat()
    assert h.dtype == torch.float64 and h.device.type == "cpu"
    assert torch.equal(h, d64.dynmat())


def test_flagship_dynmat_reproduces_committed_hessian():
    """``CHDriver(flagship).dynmat()`` (603 DOFs: three 256-row blocks of
    Hessian-vector products, the whole matrix) against ``dyn_ev2`` of
    scripts/flagship_negf.npz, which the JAX package computed from the
    same geometry: 1e-8 of the largest element (0.34 eV^2)."""
    axyz = flagship()
    ref = np.load(NPZ)["dyn_ev2"]
    d = TH.CHDriver(axyz, device="cpu").dynmat().numpy()
    assert d.shape == (603, 603)
    np.testing.assert_allclose(d, ref, rtol=0, atol=1e-8 * np.abs(ref).max())


def test_flagship_table_shape():
    """On the flagship geometry the carbon table is 8 wide (cutoff 2.1 A
    plus skin reaches the second shell), 3 entries of a row at most lie
    inside the cutoff, and every H is terminated."""
    axyz = flagship()
    fn, bonds = TH.ch_energy(axyz)
    t = fn.terms
    assert t["nbr_c"].shape == (171, 8) and len(bonds) == 30
    x0 = _carbons(axyz)
    r = np.linalg.norm(x0[t["nbr_c"]] - x0[:, None], axis=-1)
    assert ((r < 2.1) & t["mask_c"]).sum(1).max() == 3


def test_float32_twin_keeps_the_angular_function():
    """Below float64 g(theta) is taken in its form without cancellation:
    the float32 force on the flagship stays within 1e-4 (conv-scaled
    units; largest force 0.02) of the float64 one. The published form
    gives 1e-2 there."""
    axyz = flagship()
    d32 = TH.CHDriver(axyz, dtype=torch.float32, device="cpu")
    d64 = TH.CHDriver(axyz, device="cpu")
    q = 0.05 * torch.as_tensor(
        np.random.default_rng(11).standard_normal((2, 603)))
    err = (d32.force_torch(q.float()).double() - d64.force_torch(q)).abs()
    assert float(err.max()) < 1e-4


def test_host_driver_round_trip():
    class Host:
        conv, f0, axyz = np.ones(6), np.zeros(6), None

        def force(self, q):
            return -2.0 * np.asarray(q)

        def energy(self, q):
            return float(np.sum(np.asarray(q) ** 2))

    hd = HostDriver(Host(), 6, dtype=torch.float64)
    q = torch.as_tensor(np.random.default_rng(12).standard_normal((3, 6)))
    assert torch.equal(hd.force_torch(q), -2.0 * q)
    assert torch.equal(hd.force_torch(q[0]), -2.0 * q[0])
    np.testing.assert_allclose(hd.force(q[0]), -2.0 * q[0].numpy())
    assert hd.energy(q[0].numpy()) > 0 and hd.dynmat() is None
    hd.quit()


@pytest.mark.parametrize("make", [
    lambda: TH.CHDriver(benzene()),
    lambda: TT.TersoffDriver([["C", 0, 0, 0], ["C", 1.4, 0, 0]]),
    lambda: TP.PairDriver([["C", 0, 0, 0], ["C", 1.4, 0, 0]]),
    lambda: TorchDriver(lambda x: (x ** 2).sum((-2, -1)),
                        [["C", 0, 0, 0]]),
], ids=["ch", "tersoff", "pair", "torch"])
def test_drivers_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        make()


# --- mirrors of tests/test_tersoff.py --------------------------------------
def _dimer_energy(r, element="C"):
    x = np.array([[0.0, 0, 0], [r, 0, 0]])
    nbr, mask = build_neighbors(x, 2.2, 4)
    return float(TT.tersoff_energy(element, nbr, mask)(torch.as_tensor(x)))


def test_dimer_binding_curve():
    e_eq = _dimer_energy(1.45)
    assert e_eq < -4.0
    assert _dimer_energy(2.5) == 0.0
    assert _dimer_energy(0.8) > e_eq
    rs = np.linspace(1.2, 1.8, 61)
    rmin = rs[int(np.argmin([_dimer_energy(r) for r in rs]))]
    assert 1.3 < rmin < 1.6, rmin


def test_isolated_bond_has_finite_gradient_and_hessian():
    """zeta = 0: the safe-where form keeps (beta zeta)^n out of the
    gradient."""
    drv = TT.TersoffDriver([["C", 0, 0, 0], ["C", 1.45, 0, 0]], device="cpu")
    assert torch.isfinite(drv.force(np.zeros(6))).all()
    assert torch.isfinite(drv.dynmat()).all()


def test_bond_order_is_many_body():
    r = 1.45
    x3 = np.array([[0.0, 0, 0], [r, 0, 0], [-r / 2, r * 0.866, 0]])
    nbr, mask = build_neighbors(x3, 2.2, 4)
    e3 = float(TT.tersoff_energy("C", nbr, mask)(torch.as_tensor(x3)))
    pair_sum = sum(_dimer_energy(np.linalg.norm(x3[a] - x3[b]))
                   for a, b in ((0, 1), (0, 2), (1, 2)))
    assert abs(e3 - pair_sum) > 0.1


def test_forces_match_finite_differences():
    rng = np.random.default_rng(13)
    x = TT.graphene_ribbon(2, 2) + rng.normal(size=(8, 3)) * 0.02
    nbr, mask = build_neighbors(x, 2.2, 8)
    efn = TT.tersoff_energy("C", nbr, mask)
    _, f = _torch_ef(efn, x)
    eps = 1e-6
    for i, c in ((0, 0), (3, 1), (7, 2)):
        xp, xm = x.copy(), x.copy()
        xp[i, c] += eps
        xm[i, c] -= eps
        fd = -(float(efn(torch.as_tensor(xp))) -
               float(efn(torch.as_tensor(xm)))) / (2 * eps)
        np.testing.assert_allclose(f[i, c], fd, rtol=1e-5, atol=1e-7)


def _tersoff_driver():
    return TT.TersoffDriver(
        [["C", *row] for row in TT.graphene_ribbon(3, 2)], device="cpu")


def test_graphene_cohesion_and_dynmat_stability():
    drv = _tersoff_driver()
    assert drv.energy() / drv.number < -4.0
    d = drv.dynmat().numpy()
    np.testing.assert_allclose(d, d.T, atol=1e-10)
    ev = np.linalg.eigvalsh(d)
    assert ev.min() > -2e-3 and ev.max() > 1e-3


def test_md_runs_with_tersoff():
    """``run_segment`` with a driver's ``force_fn`` and no ``dyn``."""
    from sclmd_tpu_torch import baths as TB
    drv = _tersoff_driver()
    nph = 3 * drv.number
    dt, nmd = 0.4, 64
    eb = TB.ebath(range(6), 300.0, dt, nmd, wmax=1.0,
                  efric=np.eye(6) * 0.02, dtype=torch.float64, device="cpu",
                  factorize=False)
    noise = 0.01 * np.random.default_rng(14).standard_normal((1, nmd, 6))
    system = TMD.GLESystem(
        dyn=None, baths=(eb.replace(noise=torch.as_tensor(noise)),),
        mask=torch.ones(nph, dtype=torch.float64), dt=dt, nph=nph, ml=1,
        nmd=nmd, force_fn=drv.force_torch)
    final, ys = TMD.run_segment(system, TMD.initial_state(system, 1), nmd)
    assert torch.isfinite(final.p).all()
    assert float(final.q.abs().max()) < 10.0
    with pytest.raises(ValueError, match="no driver, no md"):
        system.replace(force_fn=None).potential_force(final.q)


def test_multi_element_cases():
    with pytest.raises(NotImplementedError):
        TT.TersoffDriver([["C", 0, 0, 0], ["H", 1, 0, 0]], device="cpu")
    rng = np.random.default_rng(15)
    x = np.array([[0, 0, 0], [2.35, 0, 0], [1.2, 2.0, 0],
                  [3.5, 2.0, 0.3]]) + rng.normal(size=(4, 3)) * 0.02
    nbr, mask = build_neighbors(x, 3.0, 3)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(
        float(TT.tersoff_energy_multi(["Si"] * 4, nbr, mask)(xt)),
        float(TT.tersoff_energy("Si", nbr, mask)(xt)), rtol=1e-10)
    drv = TT.TersoffDriver([["Si", 0, 0, 0], ["C", 1.85, 0, 0]],
                           device="cpu")
    assert drv.energy() < -2.0
    assert torch.isfinite(drv.force(np.zeros(6))).all()
    assert torch.isfinite(drv.dynmat()).all()


def test_chi_weakens_hetero_bond():
    x = np.array([[0.0, 0, 0], [1.85, 0, 0]])
    nbr, mask = build_neighbors(x, 3.0, 2)
    xt = torch.as_tensor(x)
    v_chi = float(TT.tersoff_energy_multi(["Si", "C"], nbr, mask)(xt))
    old = TT.TERSOFF_CHI[("Si", "C")]
    try:
        TT.TERSOFF_CHI[("Si", "C")] = 1.0
        v_nochi = float(TT.tersoff_energy_multi(["Si", "C"], nbr, mask)(xt))
    finally:
        TT.TERSOFF_CHI[("Si", "C")] = old
    assert v_chi > v_nochi


# --- mirrors of tests/test_hydrocarbon.py ----------------------------------
def test_ribbon_edges_passivated():
    x = TT.graphene_ribbon(4, 3)
    axyz = [["C", *row] for row in x]
    out = TH.terminate_with_h(axyz)
    assert out == JH.terminate_with_h(axyz)
    nh = sum(1 for a in out if a[0] == "H")
    assert nh > 0
    pos = np.array([a[1:] for a in out])
    for i, a in enumerate(out):
        if a[0] != "H":
            continue
        d = np.linalg.norm(pos[: len(axyz)] - pos[i], axis=1)
        assert abs(d.min() - 1.09) < 1e-6 and (d < 1.3).sum() == 1
    drv = TH.CHDriver(out, device="cpu")
    assert len(drv.ch_bonds) == nh
    assert torch.isfinite(drv.force(np.zeros(3 * len(out)))).all()


def test_ch_driver_rejects_and_bonds():
    with pytest.raises(NotImplementedError):
        TH.ch_energy([["C", 0, 0, 0], ["O", 1.2, 0, 0]])
    with pytest.raises(ValueError, match="no C within"):
        TH.ch_energy([["C", 0, 0, 0], ["H", 5.0, 0, 0]])
    axyz = benzene()
    drv = TH.CHDriver(axyz, device="cpu")
    assert len(drv.ch_bonds) == 6 and len(set(drv.ch_bonds[:, 1])) == 6
    q = np.zeros(3 * len(axyz))
    q[0] = 0.01
    f = drv.force(q)
    assert f.shape == (36,) and torch.isfinite(f).all()
    assert not drv.force(np.zeros(36)).any()


def test_benzene_nve_energy_conservation():
    """The integrator applies relative forces f(q) - f0, whose conserved
    quantity is KE + PE(q) + f0.q."""
    axyz = benzene()
    drv = TH.CHDriver(axyz, device="cpu")
    nph = 3 * len(axyz)
    system = TMD.GLESystem(dyn=None, baths=(),
                           mask=torch.ones(nph, dtype=torch.float64),
                           dt=0.05, nph=nph, ml=1, nmd=512,
                           force_fn=drv.force_torch)
    p0 = 0.02 * np.random.default_rng(16).standard_normal((2, nph))
    st = TMD.initial_state(system, 2).replace(p=torch.as_tensor(p0))

    def etot(s):
        ke = 0.5 * (s.p * s.p).sum(-1)
        pe = drv.energy_torch(s.q) - drv.energy()
        return (ke + pe + s.q @ drv.f0).numpy()

    e0 = etot(st)
    fin, _ = TMD.run_segment(system, st, 512)
    e1 = etot(fin)
    assert torch.isfinite(fin.q).all()
    assert (np.abs(e1 - e0) < 2e-3 * np.maximum(np.abs(e0), 1e-3)).all()
