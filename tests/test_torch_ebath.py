"""Parity of the port's electron bath and the functions it needs with
the JAX package.

Both packages build baths from the same numpy inputs in CPU float64;
the golden scalar values are those of tests/test_functions.py. Noise
factors are compared through the PSD they rebuild (U diag(std^2) U^H),
since eigenvectors are fixed only up to a phase.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu.ops import functions as JF
from sclmd_tpu.ops import noise as JN
from test_functions import bose_ref

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import units as TU
from sclmd_tpu_torch.convert import from_jax_bath
from sclmd_tpu_torch.ops import functions as TF
from sclmd_tpu_torch.ops import noise as TN

torch.set_num_threads(2)

KB = TU.KB


# --- ops/functions ----------------------------------------------------------
def test_fermi_golden():
    assert float(TF.fermi(0.0, 0.5, 0.0)) == 1.0
    assert float(TF.fermi(1.0, 0.5, 0.0)) == 0.0
    assert float(TF.fermi(0.5, 0.5, 0.0)) == 0.5
    want = 1 / (np.exp((0.6 - 0.5) / KB / 300.0) + 1)
    np.testing.assert_allclose(float(TF.fermi(0.6, 0.5, 300.0)), want,
                               rtol=1e-12)
    ep = np.linspace(-0.3, 0.3, 13)
    for T in (0.0, 30.0, 300.0):
        np.testing.assert_allclose(
            TF.fermi(ep, 0.05, T),
            np.asarray(JF.fermi(jnp.asarray(ep), 0.05, T)), rtol=1e-12)


@pytest.mark.parametrize("classical", [False, True])
def test_nonequ_spectrum(classical):
    T, bias, w = 300.0, 0.1, 0.05
    if not classical:
        np.testing.assert_allclose(
            float(TF.nonequ_spectrum(w, bias, T, -1)),
            2.0 * (w - bias) * (bose_ref(w - bias, T) - bose_ref(w, T)),
            rtol=1e-10)
        np.testing.assert_allclose(
            float(TF.nonequ_spectrum(w, bias, T, +1)),
            2.0 * (w + bias) * (bose_ref(w + bias, T) - bose_ref(w, T)),
            rtol=1e-10)
    ws = np.array([0.0, 0.01, 0.3, 1.0]) / TU.HBAR
    for sign in (-1, 1):
        np.testing.assert_allclose(
            TF.nonequ_spectrum(ws, bias, T, sign, classical),
            np.asarray(JF.nonequ_spectrum(jnp.asarray(ws), bias, T, sign,
                                          classical)), rtol=1e-12)


def test_fourier_t2w():
    rng = np.random.default_rng(0)
    n, dt = 32, 0.5
    a = rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3))
    dw = 2 * np.pi / dt / n
    got = TF.fourier_t2w(torch.as_tensor(a), dt, dim=0)
    np.testing.assert_allclose(got.numpy(), np.fft.ifft(a, axis=0)
                               * 2 * np.pi / dw, atol=1e-12)
    back = TF.fourier_w2t(got, dt, dim=0)
    np.testing.assert_allclose(back.numpy(), a, atol=1e-12)


def test_powerspec_match_jax():
    rng = np.random.default_rng(1)
    nmd, dt, nph = 256, 0.4, 5
    ps = rng.normal(size=(nmd, nph))
    sp = TF.powerspecp(torch.as_tensor(ps), dt, nmd).numpy()
    sq = TF.powerspecq(torch.as_tensor(ps), dt, nmd).numpy()
    np.testing.assert_allclose(
        sp, np.asarray(JF.powerspecp(jnp.asarray(ps), dt, nmd)), rtol=1e-12,
        atol=1e-14)
    np.testing.assert_allclose(
        sq, np.asarray(JF.powerspecq(jnp.asarray(ps), dt, nmd)), rtol=1e-12,
        atol=1e-14)
    # the sum rule of tests/test_functions.py
    dw = 2 * np.pi / dt / nmd
    np.testing.assert_allclose(sp[:, 1].sum() * dw / (2 * np.pi),
                               (ps ** 2).sum() / nmd, rtol=1e-8)
    np.testing.assert_allclose(sq[:, 1], sp[:, 0] ** 2 * sp[:, 1],
                               rtol=1e-8, atol=1e-12)
    with pytest.raises(ValueError, match="shape"):
        TF.powerspecp(torch.zeros((8, 2)), dt, nmd)


def test_matrix_helpers():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(4, 4))
    np.testing.assert_allclose(TF.symmetrize(a), (a + a.T) / 2)
    np.testing.assert_allclose(TF.antisymmetrize(a), (a - a.T) / 2)
    np.testing.assert_allclose(TF.symmetrize(torch.as_tensor(a)).numpy(),
                               np.asarray(JF.symmetrize(a)))
    np.testing.assert_allclose(TF.antisymmetrize(torch.as_tensor(a)).numpy(),
                               np.asarray(JF.antisymmetrize(a)))
    assert TF.chkShape(np.eye(3)) == 3 == TF.chkShape(torch.eye(3))
    with pytest.raises(ValueError):
        TF.chkShape(np.zeros((2, 3)))


# --- ops/noise.electron_psd ---------------------------------------------------
def _mats(nc, seed=3):
    rng = np.random.default_rng(seed)

    def m():
        return rng.normal(size=(nc, nc)) * 0.01
    a = m()
    efric = a @ a.T + 0.01 * np.eye(nc)
    return dict(efric=efric, exim=m(), exip=m(), zeta1=m(), zeta2=m())


@pytest.mark.parametrize("classical", [False, True])
@pytest.mark.parametrize("bias", [0.0, 0.3])
def test_electron_psd_matches_jax(bias, classical):
    mt = _mats(5)
    exim = TF.antisymmetrize(mt["exim"])
    exip = TF.symmetrize(mt["exip"])
    wl = np.linspace(0.0, 2.0, 40)
    args = (wl, mt["efric"], exim, exip, bias, 250.0, 1.2, classical, True,
            3.7)
    want = np.asarray(JN.electron_psd(*args, xp=np))
    got = TN.electron_psd(*args)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert np.abs(got - np.conj(np.swapaxes(got, 1, 2))).max() == 0.0


# --- baths.ebath ------------------------------------------------------------
def _psd_of(b):
    ev, std = np.asarray(b.nevecs), np.asarray(b.nstd)
    return np.einsum("wij,wj,wkj->wik", ev, std ** 2, ev.conj())


def _ebaths(nc, bias=0.0, which=("exim", "zeta1", "zeta2"), **kw):
    mt = _mats(nc)
    extra = {k: mt[k] for k in which}
    common = dict(cats=range(2, 2 + nc), T=310.0, dt=0.4, nmd=64, wmax=1.0,
                  nw=50, bias=bias, efric=mt["efric"], **extra, **kw)
    return (JB.ebath(dtype=jnp.float64, **common),
            TB.ebath(dtype=torch.float64, **common, device="cpu"))


def _assert_bath_match(tb, jb):
    for k in ("efric", "exim", "exip", "zeta1", "zeta2"):
        np.testing.assert_allclose(getattr(tb, k).numpy(),
                                   np.asarray(getattr(jb, k)), rtol=1e-15,
                                   atol=0, err_msg=k)
    assert tb.bias_terms == jb.bias_terms
    assert (tb.nc, tb.ml, tb.cs, tb.T, tb.bias) == \
        (jb.nc, jb.ml, jb.cs, float(jb.T), float(jb.bias))
    want = _psd_of(jb)
    np.testing.assert_allclose(_psd_of(tb), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("case", ["proportional", "small", "biased",
                                  "exip_only_biased", "friction_only"])
def test_ebath_matches_jax(case):
    """Both factor paths: one eigh of efric for an unbiased bath with
    nc >= 8, the per-frequency electron_psd batch otherwise."""
    kw = {"proportional": dict(nc=9),
          "small": dict(nc=4),
          "biased": dict(nc=9, bias=0.2),
          "exip_only_biased": dict(nc=9, bias=0.2, which=("exip",)),
          "friction_only": dict(nc=9, which=())}[case]
    jb, tb = _ebaths(**kw)
    _assert_bath_match(tb, jb)
    proportional = np.asarray(tb.nevecs).strides[0] == 0
    assert proportional == (case in ("proportional", "friction_only"))
    # the symmetrised matrices are symmetric / antisymmetric
    for k, s in (("efric", 1), ("exip", 1), ("zeta1", 1), ("exim", -1),
                 ("zeta2", -1)):
        m = getattr(tb, k).numpy()
        np.testing.assert_array_equal(m, s * m.T)


def test_ebath_setters_refactor():
    jb, tb = _ebaths(9)
    _assert_bath_match(tb.SetT(120.0), jb.SetT(120.0))
    _assert_bath_match(tb.setbias(0.15), jb.setbias(0.15))
    _assert_bath_match(tb.SetMDsteps(0.3, 128), jb.SetMDsteps(0.3, 128))
    assert tb.SetMDsteps(0.3, 128).nstd.shape == (65, 9)


def test_ebath_rejects_bad_shapes():
    with pytest.raises(ValueError, match="efric"):
        TB.ebath(range(3), 300.0, 0.4, 64, efric=np.eye(4), device="cpu")
    with pytest.raises(ValueError, match="zeta1"):
        TB.ebath(range(3), 300.0, 0.4, 64, efric=np.eye(3),
                 zeta1=np.eye(2), device="cpu")
    with pytest.raises(ValueError, match="required"):
        TB.ebath(range(3), 300.0, 0.4, 64, device="cpu")


def test_from_jax_ebath():
    jb, tb = _ebaths(9, bias=0.2)
    cb = from_jax_bath(jb, device="cpu")
    assert isinstance(cb, TB.EBath) and cb.bias_terms
    _assert_bath_match(cb, jb)
    np.testing.assert_array_equal(cb.cids, tb.cids)
