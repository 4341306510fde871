"""Parity of the port's functions and noise synthesis with the JAX package.

Inputs are made with numpy from a seed and given to both packages; the
JAX side runs in CPU float64 as its own tests run it. The oracle values
are the golden scalar re-derivations of tests/test_functions.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sclmd_tpu.ops import functions as JF
from sclmd_tpu.ops import noise as JN
from test_functions import bose_ref, equ_ref, flinterp_ref

import sclmd_tpu_torch
from sclmd_tpu_torch.ops import functions as TF
from sclmd_tpu_torch.ops import noise as TN

torch.set_num_threads(2)


@pytest.mark.parametrize("T", [0.0, 10.0, 300.0])
def test_bose(T):
    ws = np.array([-0.2, -1e-3, 0.0, 1e-3, 0.05, 1.0])
    got = TF.bose(ws, T)
    np.testing.assert_allclose(got, [bose_ref(w, T) for w in ws], rtol=1e-12)
    np.testing.assert_allclose(got, np.asarray(JF.bose(jnp.asarray(ws), T)),
                               rtol=1e-12)


@pytest.mark.parametrize("classical", [False, True])
@pytest.mark.parametrize("zp", [False, True])
@pytest.mark.parametrize("T", [0.0, 300.0])
def test_equ_spectrum(T, classical, zp):
    ws = np.array([-0.5, 0.0, 1e-4, 0.3, 0.999, 1.0, 2.0])
    got = TF.equ_spectrum(ws, 1.0, T, classical, zp)
    np.testing.assert_allclose(got, [equ_ref(w, 1.0, T, classical, zp)
                                     for w in ws], rtol=1e-12)
    np.testing.assert_allclose(
        got, np.asarray(JF.equ_spectrum(jnp.asarray(ws), 1.0, T, classical,
                                        zp)), rtol=1e-12)


@pytest.mark.parametrize("trail", [(), (3, 3)])
def test_flinterp_np(trail):
    rng = np.random.default_rng(4)
    xs = np.linspace(0.0, 1.0, 11)
    ys = rng.normal(size=(11,) + trail)
    xq = np.array([0.0, 0.03, 0.07, 0.25, 0.5001, 0.96, 0.99, 1.0, 1.5, -0.3])
    got = TF.flinterp_np(xq, xs, ys)
    np.testing.assert_allclose(got, JF.flinterp_np(xq, xs, ys), rtol=1e-12)
    for k, x in enumerate(xq):
        np.testing.assert_allclose(got[k], flinterp_ref(x, xs, ys),
                                   rtol=1e-12)


def test_fourier_mirror_rpadleft():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(16, 3)) + 1j * rng.normal(size=(16, 3))
    np.testing.assert_allclose(
        TF.fourier_w2t(torch.as_tensor(a), 0.7).numpy(),
        np.asarray(JF.fourier_w2t(jnp.asarray(a), 0.7)), rtol=1e-12)
    xi = rng.normal(size=(9, 3)) + 1j * rng.normal(size=(9, 3))
    np.testing.assert_array_equal(
        TN.mirror_halfspectrum(torch.as_tensor(xi), 16).numpy(),
        np.asarray(JN.mirror_halfspectrum(jnp.asarray(xi), 16)))
    hist = rng.normal(size=(5, 4))
    new = rng.normal(size=(4,))
    np.testing.assert_array_equal(
        TF.rpadleft(torch.as_tensor(hist), torch.as_tensor(new)).numpy(),
        np.asarray(JF.rpadleft(jnp.asarray(hist), jnp.asarray(new))))


def _psd_inputs(nc, seed=6):
    rng = np.random.default_rng(seed)
    gwl = np.linspace(0.0, 0.6, 24)
    if nc >= 8:        # scalar profile: the frequency-proportional path
        base = rng.normal(size=(nc, nc))
        base = base @ base.T / nc + np.eye(nc)
        gam = np.array([base * 0.01 * np.exp(-(w / 0.3) ** 2) for w in gwl])
    else:              # frequency-dependent structure: the full path
        a = rng.normal(size=(len(gwl), nc, nc))
        gam = 0.01 * (a @ np.swapaxes(a, 1, 2)) / nc
    nmd, dt = 64, 0.5
    wl = 2 * np.pi / dt / nmd * np.arange(nmd // 2 + 1)
    return wl, gam, gwl, nmd, dt


@pytest.mark.parametrize("nc", [4, 12])
def test_phonon_psd_and_factors(nc):
    wl, gam, gwl, nmd, dt = _psd_inputs(nc)
    args = (wl, gam, gwl, 300.0, 0.5, False, True, dt * nmd)
    psd_t = TN.phonon_psd(*args)
    psd_j = JN.phonon_psd(*args, xp=np)
    np.testing.assert_allclose(psd_t, psd_j, rtol=1e-12, atol=1e-300)
    ev_t, std_t = TN.noise_factors(psd_t, dtype=np.float64)
    ev_j, std_j = JN.noise_factors(psd_j, dtype=np.float64)
    assert (ev_t.strides[0] == 0) == (ev_j.strides[0] == 0) == (nc >= 8)
    # the eigenvectors' phases are free: compare U diag(std^2) U^dagger
    rec_t = np.einsum("wij,wj,wkj->wik", ev_t, std_t ** 2, ev_t.conj())
    rec_j = np.einsum("wij,wj,wkj->wik", ev_j, std_j ** 2, ev_j.conj())
    scale = np.abs(rec_j).max()
    np.testing.assert_allclose(rec_t, rec_j, rtol=1e-12,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(rec_t, psd_j, rtol=1e-10, atol=1e-10 * scale)


@pytest.mark.parametrize("nc", [4, 12])
def test_sample_noise_from_r(nc):
    """Same standard-normal draws through both samplers (the JAX host
    sampler draws them from the same numpy generator state)."""
    wl, gam, gwl, nmd, dt = _psd_inputs(nc)
    psd = JN.phonon_psd(wl, gam, gwl, 300.0, 0.5, delta=dt * nmd, xp=np)
    ev, std = JN.noise_factors(psd, dtype=np.float64)
    want = np.stack([JN.sample_noise_np(np.random.default_rng(s), ev, std,
                                        dt, nmd) for s in (1, 2)])
    r = np.stack([np.random.default_rng(s).standard_normal(std.shape)
                  for s in (1, 2)])
    got = TN.sample_noise_from_r(
        torch.as_tensor(r), torch.as_tensor(TN.factor_matrix(ev)),
        torch.as_tensor(std), dt, nmd)
    assert got.shape == (2, nmd, nc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_factor_matrix_ships_one_matrix_for_proportional():
    wl, gam, gwl, nmd, dt = _psd_inputs(12)
    ev, _ = TN.noise_factors(TN.phonon_psd(wl, gam, gwl, 300.0, 0.5),
                             dtype=np.float32)
    assert ev.strides[0] == 0 and ev.dtype == np.complex64
    assert TN.factor_matrix(ev).shape == (12, 12)


def test_precision_pinned():
    """Importing the port pins full-fp32 matmuls (no TF32)."""
    assert sclmd_tpu_torch.precision_pinned()
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_odd_nmd_rejected():
    with pytest.raises(ValueError, match="even"):
        TN.sample_noise_from_r(torch.zeros((1, 4, 2)),
                               torch.eye(2, dtype=torch.complex128),
                               torch.ones((4, 2)), 0.5, 7)
