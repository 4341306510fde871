"""The port's relaxers (``models.relax``, ``utils.junction.
relax_for_model``) on the CPU in float64: analytic minima, frozen atoms,
and the same minimum as the JAX package's relaxers on a C/H ribbon (both
stop at fmax <= tol; the minima agree to what tol allows)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sclmd_tpu.models import hydrocarbon as JH
from sclmd_tpu.models import relax as JR

from sclmd_tpu_torch.models import hydrocarbon as TH
from sclmd_tpu_torch.models.relax import fire_relax, lbfgs_relax
from sclmd_tpu_torch.models.tersoff import graphene_ribbon
from sclmd_tpu_torch.utils.junction import relax_for_model

torch.set_num_threads(2)


def _ribbon():
    return TH.terminate_with_h(
        [["C", *row] for row in graphene_ribbon(3, 2)])


@pytest.mark.parametrize("relaxer", [fire_relax, lbfgs_relax],
                         ids=["fire", "lbfgs"])
def test_quadratic_well_exact(relaxer):
    k = torch.tensor([[1.0, 3.0, 0.5], [2.0, 1.5, 4.0]], dtype=torch.float64)
    x_star = np.array([[0.3, -1.2, 2.0], [0.0, 5.0, -2.5]])

    def e(x):
        return 0.5 * (k * (x - torch.as_tensor(x_star)) ** 2).sum()

    x, fmax, it = relaxer(e, np.zeros((2, 3)), tol=1e-8)
    assert fmax <= 1e-8
    np.testing.assert_allclose(x, x_star, atol=1e-6)
    assert 0 < it < 5000


@pytest.mark.parametrize("relaxer", [fire_relax, lbfgs_relax],
                         ids=["fire", "lbfgs"])
def test_fixed_mask_freezes_atoms(relaxer):
    axyz = _ribbon()
    drv = TH.CHDriver(axyz, device="cpu")
    x0 = np.array([a[1:] for a in axyz])
    fixed = np.zeros(x0.shape, bool)
    fixed[:4] = True
    e0 = float(drv.energy_fn(torch.as_tensor(x0)))
    x, fmax, it = relaxer(drv.energy_fn, x0, tol=5e-3, maxit=3000,
                          fixed_mask=fixed)
    np.testing.assert_array_equal(x[:4], x0[:4])
    assert fmax <= 5e-3 and it > 0
    assert float(drv.energy_fn(torch.as_tensor(x))) < e0
    # fmax counts the free coordinates only
    g = torch.autograd.functional.jacobian(drv.energy_fn,
                                           torch.as_tensor(x)).numpy()
    assert np.abs(g[~fixed]).max() <= 5e-3 + 1e-12


def test_converged_start_takes_no_step():
    x, fmax, it = lbfgs_relax(lambda x: (x ** 2).sum(), np.zeros((2, 3)))
    assert it == 0 and fmax == 0.0
    x, fmax, it = fire_relax(lambda x: (x ** 2).sum(), np.zeros((2, 3)))
    assert it == 0 and fmax == 0.0


@pytest.mark.parametrize("method", ["lbfgs", "fire"])
def test_relax_for_model_matches_jax_minimum(method):
    """Two rounds of rebuild and relax of the terminated ribbon, in both
    packages: the same basin, positions to 2e-2 angstrom and energies to
    1e-3 eV at tol 2e-3 eV/angstrom (the minimum's soft directions move
    by tol over their curvature)."""
    from sclmd_tpu.utils.junction import relax_for_model as j_relax
    axyz = _ribbon()
    fixed = [0, 1]
    tout, tf, tn = relax_for_model(
        axyz, lambda a: TH.CHDriver(a, device="cpu"), fixed_atoms=fixed,
        tol=2e-3, maxit=4000, method=method)
    jout, jf, jn = j_relax(axyz, JH.CHDriver, fixed_atoms=fixed, tol=2e-3,
                           maxit=4000, method=method)
    assert tf <= 2e-3 and jf <= 2e-3 and tn > 0
    xt = np.array([a[1:] for a in tout])
    xj = np.array([a[1:] for a in jout])
    x0 = np.array([a[1:] for a in axyz])
    np.testing.assert_array_equal(xt[fixed], x0[fixed])
    assert [a[0] for a in tout] == [a[0] for a in axyz]
    np.testing.assert_allclose(xt, xj, atol=2e-2)
    et = TH.CHDriver(tout, device="cpu").energy()
    ej = TH.CHDriver([[a[0]] + [float(v) for v in a[1:]] for a in jout],
                     device="cpu").energy()
    assert abs(et - ej) < 1e-3
    # the rebuilt driver sits at its own minimum: f0 is small
    f0 = TH.CHDriver(tout, device="cpu").f0.numpy()
    free = np.ones(len(axyz), bool)
    free[fixed] = False
    conv = TH.CHDriver(tout, device="cpu").conv
    assert np.abs((f0 / conv).reshape(-1, 3)[free]).max() < 0.05
