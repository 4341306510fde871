"""The port's DeepPot-SE (``sclmd_tpu_torch.models.nnp``) against the JAX
package's on the CPU in float64, and its driver ``deepmddriver``.

The same weights (the JAX model's own, with random biases added so that
every term is exercised) and the same neighbour table go into both
packages; energies and forces (``jax.grad`` against ``torch.autograd``)
agree to rtol 1e-10 of the largest, since both evaluate the same formulas
in float64 and differ only in the order of their sums. The port also
holds against the benchmark's plain reference
(``benchmarks/configs/si_dp_slab_reference.py``) at DeePMD-kit's
published widths on a cut silicon slab, to the same tolerance and for
the same reason.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sclmd_tpu.models import nnp as JN

from sclmd_tpu_torch import precision_pinned
from sclmd_tpu_torch.models import nnp as TN
from sclmd_tpu_torch.models.driver import TorchDriver
from sclmd_tpu_torch.models.sw import SWDriver, diamond_cell
from sclmd_tpu_torch.utils import profiling

torch.set_num_threads(2)

RTOL = 1e-10
SMALL = dict(embed_sizes=(8, 16), fit_sizes=(16, 16), naxis=4)
PUBLISHED = dict(embed_sizes=(25, 50, 100), fit_sizes=(240, 240, 240),
                 naxis=16)


def _slab(cells=(2, 2, 2), amp=0.05, seed=0):
    """Si diamond cells displaced by ``amp`` angstrom (so no distance
    sits at a tie or half a period), their periodic cell and axyz."""
    pos, cell = diamond_cell(*cells)
    pos = pos + amp * np.random.default_rng(seed).normal(size=pos.shape)
    return pos, cell, [["Si", *p] for p in pos]


def _models(ntypes, periodic, widths=SMALL, rcut=4.0, rcut_smth=3.0):
    """(JAX model, port model, positions) on one table with the JAX
    model's weights plus random biases, in both packages."""
    pos, cell, _ = _slab()
    cell = cell if periodic else None
    types = np.arange(len(pos)) % ntypes
    nbr, mask = TN.build_neighbors(pos, rcut, None, cell=cell)
    jn, jm = JN.build_neighbors(pos, rcut, None, cell=cell)
    assert np.array_equal(nbr, jn) and np.array_equal(mask, jm)
    jmod = JN.DeepPotSE(types, ntypes, rcut, rcut_smth, nbr, mask,
                        cell=cell, dtype=jnp.float64, seed=3, **widths)
    rng = np.random.default_rng(ntypes)
    jmod.params = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.standard_normal(a.shape)
        if a.ndim == 1 else a, jmod.params)
    tmod = TN.DeepPotSE(types, ntypes, rcut, rcut_smth, nbr, mask,
                        cell=cell, dtype=torch.float64, device="cpu",
                        **widths)
    tmod.set_params(jmod.params)
    return jmod, tmod, pos


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("ntypes", [1, 2])
def test_energy_and_forces_match_jax(ntypes, periodic):
    jmod, tmod, pos = _models(ntypes, periodic)
    ej = float(jmod.energy(jmod.params, jnp.asarray(pos)))
    fj = np.asarray(jmod.forces(jmod.params, jnp.asarray(pos)))
    x = torch.as_tensor(pos)
    et = float(tmod.energy(tmod.params, x))
    ft = tmod.forces(tmod.params, x).numpy()
    assert abs(et - ej) <= RTOL * abs(ej)
    _close(ft, fj)
    assert np.abs(fj).max() > 1e-6


def test_published_widths_match_jax():
    """DeePMD-kit's se_e2_a widths (embedding 25-50-100, 16 axis columns,
    fitting 240-240-240) at its cutoffs 6.0 / 0.5 on 64 periodic atoms."""
    jmod, tmod, pos = _models(1, True, PUBLISHED, rcut=6.0, rcut_smth=0.5)
    assert tmod.params["fit"][0][0][0].shape == (1600, 240)
    ej = float(jmod.energy(jmod.params, jnp.asarray(pos)))
    fj = np.asarray(jmod.forces(jmod.params, jnp.asarray(pos)))
    x = torch.as_tensor(pos)
    assert abs(float(tmod.energy(tmod.params, x)) - ej) <= RTOL * abs(ej)
    _close(tmod.forces(tmod.params, x).numpy(), fj)


@pytest.mark.parametrize("ntypes", [1, 2])
def test_leading_axes_are_a_batch(ntypes):
    """Positions (2, 3, na, 3) give the (2, 3) energies of each set
    alone, and their gradient each set's forces."""
    _, tmod, pos = _models(ntypes, True)
    rng = np.random.default_rng(7)
    xs = torch.as_tensor(pos + 0.03 * rng.standard_normal((2, 3) + pos.shape))
    e = tmod.energy(tmod.params, xs)
    f = tmod.forces(tmod.params, xs)
    assert e.shape == (2, 3) and f.shape == xs.shape
    for i in range(2):
        for j in range(3):
            one = xs[i, j]
            assert float(e[i, j]) == pytest.approx(
                float(tmod.energy(tmod.params, one)), rel=RTOL)
            _close(f[i, j].numpy(), tmod.forces(tmod.params, one).numpy())


def test_invariances_and_gradient():
    """A translation and a rotation of an open cluster leave the energy;
    the force is minus the energy's difference quotient."""
    _, tmod, pos = _models(2, False)
    x = torch.as_tensor(pos)
    e = float(tmod.energy(tmod.params, x))
    assert float(tmod.energy(tmod.params, x + 3.7)) == pytest.approx(
        e, rel=1e-12)
    th = 0.7
    rot = torch.as_tensor([[np.cos(th), -np.sin(th), 0],
                           [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    assert float(tmod.energy(tmod.params, x @ rot.T)) == pytest.approx(
        e, rel=1e-10)
    f = tmod.forces(tmod.params, x)
    # a central difference of 1e-4 angstrom: its truncation is about 1e-8
    # of the force here, the energy's rounding (|E| ~ 70 eV) 1e-10
    h = 1e-4
    for i, c in [(0, 0), (5, 1), (17, 2)]:
        dx = torch.zeros_like(x)
        dx[i, c] = h
        fd = -(float(tmod.energy(tmod.params, x + dx))
               - float(tmod.energy(tmod.params, x - dx))) / (2 * h)
        assert float(f[i, c]) == pytest.approx(fd, rel=1e-6)


def test_weights_file_is_shared_with_jax(tmp_path):
    """Each package reads the weights file the other writes."""
    jmod, tmod, pos = _models(2, True)
    jmod.save(str(tmp_path / "j.npz"))
    other = TN.DeepPotSE(tmod.types, 2, 4.0, 3.0, tmod.nbr, tmod.nmask,
                         cell=tmod.cell, dtype=torch.float64, device="cpu",
                         seed=9, **SMALL)
    x = torch.as_tensor(pos)
    assert float(other.energy(other.params, x)) != pytest.approx(
        float(tmod.energy(tmod.params, x)), rel=1e-6)
    other.load(str(tmp_path / "j.npz"))
    assert float(other.energy(other.params, x)) == float(
        tmod.energy(tmod.params, x))
    other.save(str(tmp_path / "t.npz"))
    jmod.params = jax.tree_util.tree_map(jnp.zeros_like, jmod.params)
    jmod.load(str(tmp_path / "t.npz"))
    assert float(jmod.energy(jmod.params, jnp.asarray(pos))) == \
        pytest.approx(float(tmod.energy(tmod.params, x)), rel=RTOL)


def test_seeded_weights_follow_the_jax_initialisation():
    """``init_params``: w of fan_in rows scaled by 1/sqrt(fan_in), zero
    biases, the JAX layout; the same seed gives the same weights."""
    a = TN.init_params(5, 2, (25, 50, 100), (240, 240, 240), 16)
    b = TN.init_params(5, 2, (25, 50, 100), (240, 240, 240), 16)
    assert [w.shape for w, _ in a["fit"][1]] == \
        [(1600, 240), (240, 240), (240, 240), (240, 1)]
    assert [w.shape for w, _ in a["embed"][0]] == \
        [(1, 25), (25, 50), (50, 100)]
    for x, y in zip(TN._flat(a), TN._flat(b)):
        assert np.array_equal(x, y)
    w = a["fit"][0][0][0]
    assert np.std(w) * np.sqrt(1600) == pytest.approx(1.0, rel=0.02)
    assert not any(bb.any() for _, bb in a["embed"][0])
    c = TN.init_params(6, 2, (25, 50, 100), (240, 240, 240), 16)
    assert not np.array_equal(a["fit"][0][0][0], c["fit"][0][0][0])


def _sw_and_dp(cells=(3, 3, 3), baseline=True):
    from sclmd_tpu_torch.tools import slab as SL
    axyz, cell = SL.si_slab(*cells)
    sw = SWDriver(axyz, cell=cell, max_nnei=16, cutoff_skin=0.4,
                  dtype=torch.float64, device="cpu")
    model = SL.dp_model(axyz, cell, torch.float64, "cpu")
    # a random net's force is 1e-6 to 1e-5 of the SW force: its output
    # layer scaled up, as the benchmark's weights are
    w, b = model.params["fit"][0][-1]
    model.params["fit"][0][-1] = (w * 1e4, b)
    drv = TN.deepmddriver(model, axyz, dtype=torch.float64, device="cpu",
                          baseline=sw if baseline else None)
    return drv, sw


def test_overlay_force_is_the_sum_of_the_two_drivers():
    """The overlay's force is the network driver's plus the baseline's,
    each relative to its own f0; f0, ``absforce`` and the energy add up
    the same way; the table of the published cutoff is 48 wide."""
    drv, sw = _sw_and_dp()
    net, _ = _sw_and_dp(baseline=False)
    assert drv.model.nbr.shape[1] == 48
    rng = np.random.default_rng(2)
    q = torch.as_tensor(0.06 * rng.standard_normal((3, drv.number * 3))
                        / drv.conv)
    want = net.force_torch(q) + sw.force_torch(q)
    got = drv.force_torch(q)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=RTOL * float(want.abs().max()))
    assert float(net.force_torch(q).abs().max()) > \
        1e-3 * float(sw.force_torch(q).abs().max())
    np.testing.assert_allclose(drv.f0.numpy(), (net.f0 + sw.f0).numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        drv.absforce(q[0]).numpy(), (net.absforce(q[0])
                                     + sw.absforce(q[0])).numpy(),
        rtol=0, atol=RTOL * float(want.abs().max()))
    assert drv.energy() == pytest.approx(net.energy() + sw.energy(),
                                         rel=1e-12)
    e, f = drv.energy_force_torch(q)
    assert torch.equal(f, got)
    np.testing.assert_allclose(e.numpy(), (net.energy_torch(q)
                                           + sw.energy_torch(q)).numpy(),
                               rtol=1e-12)


def test_the_driver_counts_evaluations_and_opens_its_span():
    before = profiling.counters()["launches.DP"]
    drv, _ = _sw_and_dp(cells=(2, 2, 2))
    q = torch.zeros((2, drv.number * 3), dtype=torch.float64)
    drv.force_torch(q)
    drv.force_torch(q)
    assert TN.launches == profiling.counters()["launches.DP"] == before + 2
    assert profiling.process_report().span_count("setup/driver") >= 2
    assert precision_pinned()


def test_capturable_follows_the_baseline():
    from sclmd_tpu_torch.models.pair import PairDriver
    drv, _ = _sw_and_dp(cells=(2, 2, 2))
    assert drv.capturable
    alone, _ = _sw_and_dp(cells=(2, 2, 2), baseline=False)
    assert alone.capturable
    assert not getattr(PairDriver, "capturable", False)
    drv.baseline = PairDriver.__new__(PairDriver)
    assert not drv.capturable


def test_refresh_takes_new_weights_and_refuses_other_atoms(tmp_path):
    drv, sw = _sw_and_dp(cells=(2, 2, 2))
    q = torch.as_tensor(0.05 * np.random.default_rng(4).standard_normal(
        (1, drv.number * 3)) / drv.conv)
    f1 = drv.force_torch(q)
    drv.model.save(str(tmp_path / "w.npz"))
    drv.model.set_params(TN._map(lambda t: 2 * t, drv.model.params))
    drv.refresh()
    f2 = drv.force_torch(q)
    assert not torch.allclose(f1, f2)
    drv.dpstart(str(tmp_path / "w.npz"))
    np.testing.assert_allclose(drv.force_torch(q).numpy(), f1.numpy(),
                               rtol=0, atol=1e-14)
    other = SWDriver(sw.axyz[:-8], max_nnei=16, dtype=torch.float64,
                     device="cpu")
    with pytest.raises(ValueError, match="other atoms"):
        TN.deepmddriver(drv.model, drv.axyz, dtype=torch.float64,
                        device="cpu", baseline=other)


def test_dynmat_is_the_sum_and_symmetric():
    drv, sw = _sw_and_dp(cells=(2, 2, 2))
    net, _ = _sw_and_dp(cells=(2, 2, 2), baseline=False)
    h = drv.dynmat()
    assert torch.equal(h, h.T)
    np.testing.assert_allclose(h.numpy(), (net.dynmat() + sw.dynmat())
                               .numpy(), rtol=0,
                               atol=1e-10 * float(h.abs().max()))


@pytest.fixture(scope="module")
def cut_reference():
    """The benchmark's configuration cut to 3 x 3 x 3 cells (216 atoms:
    the smallest whose half period, 8.1 angstrom, exceeds the cutoff and
    the skin, 6.5: in 2 x 2 x 2 cells the shell at a0 = 5.43 angstrom
    sits at half a period, where the program's minimum image and the
    reference's stored image may part), its weights of seed 2^33 + 5
    (the reference's)."""
    from benchmarks import spec
    from benchmarks.configs import si_dp_slab_reference as REF
    with open(os.path.join(spec.HERE, "configs", "si_dp_slab.json")) as f:
        cfg = json.load(f)
    cfg["cells"] = [3, 3, 3]
    cfg["deeppot"]["weights_seed"] = 2 ** 33 + 5
    return cfg, REF.weights(cfg)


def test_port_matches_the_plain_reference_at_published_widths(
        cut_reference):
    """The port's network at the configuration's widths, cutoffs, table
    and weights against the reference's own (its table keeps each
    entry's image; the port's takes the minimum image) in float64:
    per-atom energies summed and forces."""
    from benchmarks.configs import si_dp_slab_reference as REF
    from benchmarks.configs.si_slab import geometry
    from benchmarks.reference import gle
    cfg, nets = cut_reference
    dp = cfg["deeppot"]
    axyz, cell = geometry(cfg)
    x0 = np.array([a[1:] for a in axyz])
    nbr, mask = TN.build_neighbors(x0, dp["rcut"], None, cell=cell,
                                   skin=dp["skin"])
    model = TN.DeepPotSE(np.zeros(len(x0), int), 1, dp["rcut"],
                         dp["rcut_smth"], nbr, mask,
                         embed_sizes=dp["neuron"],
                         fit_sizes=dp["fitting_neuron"],
                         naxis=dp["axis_neuron"], cell=cell,
                         dtype=torch.float64, device="cpu")
    model.set_params({"embed": [nets[0]], "fit": [nets[1]]})
    ref = REF.DeepPotModel(x0, cell, dp)
    assert ref.nbr.shape == nbr.shape == (216, 48)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(x0 + 0.08 * rng.standard_normal((2,) + x0.shape))
    f64 = gle.Prec("float64")
    net = [[(torch.as_tensor(w), torch.as_tensor(b)) for w, b in n]
           for n in nets]
    xr = x.clone().requires_grad_(True)
    er = ref.energy(xr, net, f64)
    gr, = torch.autograd.grad(er.sum(), xr)
    et = model.energy(model.params, x)
    np.testing.assert_allclose(et.numpy(), er.detach().numpy(), rtol=RTOL)
    _close(model.forces(model.params, x).numpy(), -gr.numpy())


def _plain(model):
    """The same model without its reverse slots: autograd's scatter."""
    model._consts._np.pop("rev")
    model._consts._cache = {}
    return model


@pytest.mark.parametrize("periodic", [True, False])
def test_the_gather_gradient_is_autograds(periodic):
    """On a full table the gradient gathers each atom's share through the
    reverse slots; without them autograd scatters: the same forces and
    Hessian (``dynmat``: forward mode and vmap through the gather), to
    the rounding of a sum in another order."""
    jmod, tmod, pos = _models(2, periodic)
    assert "rev" in tmod._consts._np
    rng = np.random.default_rng(5)
    x = torch.as_tensor(pos + 0.03 * rng.standard_normal((2,) + pos.shape))
    axyz = [["Si", *p] for p in pos]
    drv = TorchDriver(tmod.energy_fn(), axyz, dtype=torch.float64,
                         device="cpu")
    f, h = tmod.forces(tmod.params, x), drv.dynmat()
    _plain(tmod)
    _close(f.numpy(), tmod.forces(tmod.params, x).numpy())
    _close(h.numpy(), drv.dynmat().numpy())


def test_reverse_slots_of_full_and_truncated_tables():
    pos, cell, _ = _slab()
    nbr, mask = TN.build_neighbors(pos, 4.0, None, cell=cell)
    rev = TN.reverse_slots(nbr, mask)
    i, s = np.nonzero(mask)
    j = nbr[i, s]
    assert np.array_equal(nbr[j, rev[i, s]], i) and mask[j, rev[i, s]].all()
    short, smask = TN.build_neighbors(pos, 4.0, 8, cell=cell)
    assert int(mask.sum(1).max()) > 8
    assert TN.reverse_slots(short, smask) is None


def test_a_truncated_table_matches_jax():
    """A table cut below its occupancy has no reverse slots: the
    scatter's route, against the JAX package."""
    pos, cell, _ = _slab()
    nbr, mask = TN.build_neighbors(pos, 4.0, 8, cell=cell)
    jmod = JN.DeepPotSE(np.zeros(len(pos), int), 1, 4.0, 3.0, nbr, mask,
                        cell=cell, dtype=jnp.float64, seed=4, **SMALL)
    tmod = TN.DeepPotSE(np.zeros(len(pos), int), 1, 4.0, 3.0, nbr, mask,
                        cell=cell, dtype=torch.float64, device="cpu",
                        **SMALL)
    tmod.set_params(jmod.params)
    assert "rev" not in tmod._consts._np
    fj = np.asarray(jmod.forces(jmod.params, jnp.asarray(pos)))
    _close(tmod.forces(tmod.params, torch.as_tensor(pos)).numpy(), fj)


def _per_entry(h2, R, w3, b3, ntype, naxis):
    """D by the per-entry form, the whole embedding on each entry (as before
    K13): G^T = R^T e / nn with e = h2 W3 + b3 of each entry's own type."""
    emb = None
    for t, (w, b) in enumerate(zip(w3, b3)):
        e = h2 @ w + b
        emb = e if emb is None else \
            torch.where((ntype == t)[..., None], e, emb)
    GT = R.transpose(-1, -2) @ emb / R.shape[-2]
    D = GT.transpose(-1, -2) @ GT[..., :naxis]
    return D.reshape(D.shape[:-2] + (-1,))


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("ntypes", [1, 2])
def test_the_reassociated_twin_matches_the_per_entry_form_and_jax(
        ntypes, periodic, monkeypatch):
    """The energy and forces, by autograd and by torch.func, go through
    ``kernels.dp_descriptor``'s twin (the last embedding layer after the
    sum over entries); with the per-entry form in its place they are the
    same to the rounding of sums in another order, and both hold against
    the JAX package."""
    from sclmd_tpu_torch.kernels import dp_descriptor as K13
    calls = []
    plain = K13.descriptor_plain
    monkeypatch.setattr(K13, "descriptor_plain",
                        lambda *a: calls.append(1) or plain(*a))
    jmod, tmod, pos = _models(ntypes, periodic)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(pos + 0.03 * rng.standard_normal((2,) + pos.shape))
    ej = np.array([float(jmod.energy(jmod.params, jnp.asarray(xi)))
                   for xi in x.numpy()])
    fj = np.stack([np.asarray(jmod.forces(jmod.params, jnp.asarray(xi)))
                   for xi in x.numpy()])
    et = tmod.energy(tmod.params, x)
    ft = tmod.forces(tmod.params, x)
    assert len(calls) == 2
    ff = -torch.func.grad(lambda y: tmod.energy(tmod.params, y).sum())(x)
    assert len(calls) == 3
    monkeypatch.setattr(K13, "descriptor_plain", _per_entry)
    fe = tmod.forces(tmod.params, x)
    assert len(calls) == 3
    np.testing.assert_allclose(et.numpy(), ej, rtol=RTOL)
    np.testing.assert_allclose(tmod.energy(tmod.params, x).numpy(), ej,
                               rtol=RTOL)
    for f in (ft, ff, fe):
        _close(f.numpy(), fj)
    _close(ft.numpy(), fe.numpy())


def _descriptor_operands(ntypes, lead=(2,), na=5, nn=9, h=6, e=10, seed=0):
    rng = np.random.default_rng(seed)
    h2 = torch.as_tensor(np.tanh(rng.standard_normal(lead + (na, nn, h))))
    R = torch.as_tensor(rng.standard_normal(lead + (na, nn, 4)))
    R[..., -2:, :] = 0.0                       # two padding entries a row
    w3 = [torch.as_tensor(rng.standard_normal((h, e))) for _ in range(ntypes)]
    b3 = [torch.as_tensor(rng.standard_normal(e)) for _ in range(ntypes)]
    ntype = None if ntypes == 1 else \
        torch.as_tensor(rng.integers(0, ntypes, (na, nn)))
    return h2, R, w3, b3, ntype


@pytest.mark.parametrize("ntypes", [1, 2, 3])
def test_the_descriptor_twin_is_the_per_entry_form(ntypes):
    """``descriptor_plain`` against G^T = R^T e / nn with e = h2 W3 + b3 of
    each entry's own type, D and both gradients, in float64."""
    from sclmd_tpu_torch.kernels import dp_descriptor as K13
    h2, R, w3, b3, ntype = _descriptor_operands(ntypes)
    naxis = 4

    def per_entry(h2, R):
        return _per_entry(h2, R, w3, b3, ntype, naxis)

    rng = np.random.default_rng(1)
    dD = torch.as_tensor(rng.standard_normal(h2.shape[:-2] + (40,)))
    got, want = [], []
    for fn, out in ((lambda a, b: K13.descriptor(a, b, w3, b3, ntype, naxis),
                     got), (per_entry, want)):
        a, b = h2.clone().requires_grad_(), R.clone().requires_grad_()
        D = fn(a, b)
        D.backward(dD)
        out += [D.detach(), a.grad, b.grad]
    assert got[0].shape == (2, 5, 40)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())


def test_padding_entries_add_exact_zeros():
    """A padding entry (R = 0) leaves D's bits whatever its activation, and
    its activation's gradient is exactly zero."""
    from sclmd_tpu_torch.kernels import dp_descriptor as K13
    h2, R, w3, b3, ntype = _descriptor_operands(2)
    other = h2.clone()
    other[..., -2:, :] = 7.5
    D = K13.descriptor(h2, R, w3, b3, ntype, 4)
    assert torch.equal(K13.descriptor(other, R, w3, b3, ntype, 4), D)
    a = h2.clone().requires_grad_()
    K13.descriptor(a, R, w3, b3, ntype, 4).sum().backward()
    pad = a.grad[..., -2:, :]
    assert torch.equal(pad, torch.zeros_like(pad))
    assert a.grad[..., :-2, :].abs().min() > 0


def test_dynmat_takes_the_per_entry_form(monkeypatch):
    """The float64 Hessian (``dynmat``, torch.func on the CPU) goes through
    K13's twin and holds against the JAX package's Hessian of the same
    energy, to the rounding of sums in another order."""
    from sclmd_tpu_torch.kernels import dp_descriptor as K13
    calls = []
    plain = K13.descriptor_plain
    monkeypatch.setattr(K13, "descriptor_plain",
                        lambda *a: calls.append(1) or plain(*a))
    jmod, tmod, pos = _models(2, True)
    axyz = [["Si", *p] for p in pos]
    drv = TorchDriver(tmod.energy_fn(), axyz, dtype=torch.float64,
                      device="cpu")
    h = drv.dynmat()
    assert calls
    xyz, conv = jnp.asarray(drv.xyz), jnp.asarray(drv.conv)
    want = np.asarray(jax.hessian(lambda q: jmod.energy(
        jmod.params, (xyz + conv * q).reshape(-1, 3)))(
            jnp.zeros(3 * len(pos), dtype=jnp.float64)))
    _close(h.numpy(), 0.5 * (want + want.T))


def test_the_kernel_route_needs_cuda_float32():
    """``descriptor`` runs the twin on CPU tensors in either precision and
    ``launches.DP_desc`` stays; other tensors go to K13, which refuses
    float64 and weights that take a gradient before any launch (shown on
    the meta device, which no kernel runs on)."""
    from sclmd_tpu_torch.kernels import dp_descriptor as K13
    h2, R, w3, b3, ntype = _descriptor_operands(2)
    before = profiling.counters()["launches.DP_desc"]
    for dt in (torch.float32, torch.float64):
        c = [t.to(dt) for t in (h2, R)]
        D = K13.descriptor(*c, [t.to(dt) for t in w3],
                           [t.to(dt) for t in b3], ntype, 4)
        assert D.dtype == dt and D.shape == (2, 5, 40)
    assert profiling.counters()["launches.DP_desc"] == before == K13.launches
    meta = [t.to("meta") for t in (h2, R)]
    with pytest.raises(TypeError, match="float32"):
        K13.descriptor(*meta, [t.to("meta") for t in w3],
                       [t.to("meta") for t in b3], ntype, 4)
    meta = [t.to("meta", torch.float32) for t in (h2, R)]
    w = [t.to("meta", torch.float32).requires_grad_() for t in w3]
    with pytest.raises(ValueError, match="gradient"):
        K13.descriptor(*meta, w, [t.to("meta", torch.float32) for t in b3],
                       ntype, 4)
    assert K13.launches == before
