"""Parity of the port's phonon baths and kernel K2 with the JAX package.

Both packages build baths from the same numpy inputs (CPU float64). The
kernel wrappers take their plain twins on CPU tensors; the CUDA kernels
themselves are compared with those twins on the card by
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sclmd_tpu import baths as JB
from sclmd_tpu.md import _next_pow2

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch.convert import from_jax_bath
from sclmd_tpu_torch.kernels import block_corr as K2
from sclmd_tpu_torch.kernels import gle_block as K1

torch.set_num_threads(2)

GWL = np.linspace(0.0, 0.6, 16)


def _gamma(nc, seed=2):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(nc, nc))
    base = a @ a.T / nc + np.eye(nc)
    return np.array([base * 0.02 * np.exp(-(w / 0.3) ** 2) for w in GWL])


def _both(mode, eta_ad=0.0, nc=4, ml=17):
    kw = dict(T=290.0, cats=range(3, 3 + nc), debye=0.3, nw=32, dt=0.4,
              nmd=64, ml=ml, eta_ad=eta_ad)
    if mode == "gamma":
        kw.update(gamma=_gamma(nc), gwl=GWL)
    elif mode == "sig":
        sig = -1j * GWL[:, None, None] * _gamma(nc) + 0.01 * _gamma(nc, 3)
        kw.update(sig=sig, gwl=GWL)
    jb = JB.phbath(dtype=jnp.float64, **kw)
    tb = TB.phbath(dtype=torch.float64, **kw, device="cpu")
    return jb, tb


@pytest.mark.parametrize("eta_ad", [0.0, 0.05])
@pytest.mark.parametrize("mode", ["gamma", "sig", "debye"])
def test_phbath_matches_jax(mode, eta_ad):
    jb, tb = _both(mode, eta_ad)
    assert tb.ml == jb.ml and tb.local == jb.local and tb.mode == jb.mode
    assert tb.cs == jb.cs == 3
    np.testing.assert_allclose(tb.kernel.numpy(), np.asarray(jb.kernel),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tb.gamma, np.asarray(jb.gamma), rtol=1e-12,
                               atol=1e-15)
    rec = [np.einsum("wij,wj,wkj->wik", np.asarray(b.nevecs),
                     np.asarray(b.nstd) ** 2, np.asarray(b.nevecs).conj())
           for b in (tb, jb)]
    np.testing.assert_allclose(rec[0], rec[1], rtol=1e-12,
                               atol=1e-12 * np.abs(rec[1]).max())


@pytest.mark.parametrize("eta_ad", [0.0, 0.05])
def test_gamt_matches_jax(eta_ad):
    tl = 0.4 * np.arange(9)
    wl = np.linspace(0.0, 0.6, 32, endpoint=False)
    gam = _gamma(3)
    np.testing.assert_allclose(TB.gamt(tl, wl, GWL, gam, eta_ad),
                               JB.gamt(tl, wl, GWL, gam, eta_ad, xp=np),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("block", [4, 32])
def test_block_tap_kernel_matches_jax(block):
    """block+1 taps inside ml-1 (block 4) and zero-padded past it (32)."""
    jb, tb = _both("gamma")
    np.testing.assert_array_equal(tb.block_tap_kernel(block).numpy(),
                                  np.asarray(jb.block_tap_kernel(block)))


@pytest.mark.parametrize("block", [4, 16])
def test_block_corr_matches_jax(block):
    jb, tb = _both("gamma", ml=17)
    nfft = _next_pow2(jb.ml + block + 2)
    kpad = np.pad(np.asarray(jb.kernel), ((0, nfft - jb.ml), (0, 0), (0, 0)))
    khat = np.fft.rfft(kpad, axis=0)
    rng = np.random.default_rng(block)
    hist = rng.normal(size=(3, jb.ml - 1, jb.nc))
    want = np.stack([np.asarray(jb.block_corr(jnp.asarray(h), block,
                                              jnp.asarray(khat), nfft))
                     for h in hist])
    got = tb.block_corr(torch.as_tensor(hist), block, torch.as_tensor(khat),
                        nfft)
    assert got.shape == (3, block + 1, jb.nc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def test_from_jax_bath_roundtrip():
    jb, tb = _both("gamma")
    cb = from_jax_bath(jb, device="cpu")
    np.testing.assert_array_equal(cb.kernel.numpy(), tb.kernel.numpy())
    np.testing.assert_array_equal(cb.cids, tb.cids)
    assert (cb.cs, cb.ml, cb.nmd, cb.dt) == (tb.cs, tb.ml, tb.nmd, tb.dt)
    eb = JB.ebath(range(3), 300.0, 0.4, 64, wmax=1.0, efric=np.eye(3) / 60,
                  dtype=jnp.float64)
    ce = from_jax_bath(eb, device="cpu")
    assert isinstance(ce, TB.EBath) and (ce.cs, ce.ml, ce.nc) == (0, 1, 3)
    np.testing.assert_array_equal(ce.efric.numpy(), np.asarray(eb.efric))
    local = from_jax_bath(JB.phbath(300.0, [1, 4], 0.3, 32, 0.4, 64,
                                    dtype=jnp.float64), device="cpu")
    assert local.local and local.ml == 1 and local.cs is None
    with pytest.raises(TypeError, match="unknown bath"):
        from_jax_bath(object(), device="cpu")


def test_lead_block_mode_not_ported():
    """The K00/K01/V01 lead-block mode no longer raises: at the same
    blocks it builds the JAX package's mode "K" bath (the decimated
    Sigma's Gamma table and kernel within 1e-10 of their largest)."""
    k = np.eye(2)
    kw = dict(ml=8, K00=k, K01=k, V01=k)
    tb = TB.phbath(300.0, range(2), 0.3, 32, 0.4, 64, dtype=torch.float64,
                   device="cpu", **kw)
    jb = JB.phbath(300.0, range(2), 0.3, 32, 0.4, 64, dtype=jnp.float64,
                   **kw)
    assert tb.mode == jb.mode == "K" and tb.UseK()
    for got, want in ((tb.gamma, np.asarray(jb.gamma)),
                      (tb.kernel.numpy(), np.asarray(jb.kernel))):
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_noncontiguous_cids_use_index_columns():
    kw = dict(gamma=_gamma(3), gwl=GWL, ml=5, dtype=torch.float64)
    tb = TB.phbath(300.0, [0, 2, 5], 0.3, 32, 0.4, 64, **kw, device="cpu")
    assert tb.cs is None and torch.equal(tb.cols, torch.tensor([0, 2, 5]))
    assert TB.phbath(300.0, [4, 5, 6], 0.3, 32, 0.4, 64, **kw,
                     device="cpu").cols == slice(4, 7)


def test_wrappers_take_twins_only_on_cpu():
    """CPU tensors reach the plain twins; the CUDA entry points refuse
    them instead of falling back (no hidden device switch)."""
    rng = np.random.default_rng(0)
    khat = torch.as_tensor(rng.normal(size=(5, 3, 3))
                           + 1j * rng.normal(size=(5, 3, 3)))
    hhat = torch.as_tensor(rng.normal(size=(2, 5, 3))
                           + 1j * rng.normal(size=(2, 5, 3)))
    before = K2.launches
    np.testing.assert_array_equal(K2.block_corr_freq(khat, hhat).numpy(),
                                  K2.block_corr_freq_plain(khat, hhat).numpy())
    assert K2.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        K2.block_corr_freq_cuda(khat, hhat)
    with pytest.raises(ValueError, match="CUDA"):
        K1.gle_block_cuda(torch.zeros((1, 2)), torch.zeros((1, 2)),
                          torch.zeros((1, 2)), torch.zeros((2, 2)),
                          torch.ones(2), [], 0, 4, 0.1, True, 2)



@pytest.mark.parametrize("kind", ["profile", "wideband", "matrix", "narrow"])
def test_phonon_factors_skip_the_psd_batch_alike(kind):
    """``phonon_factors`` against ``noise_factors`` of the whole PSD batch:
    a proportional friction table (a scalar profile times a matrix, the
    wideband 0.01 I of the slabs) gives the same eigenvectors and the
    same standard deviations to 1e-12 without the batch; a table that is
    not proportional, and a bath narrower than 8, take the batch itself
    (the same bits)."""
    from sclmd_tpu_torch.ops import noise as NZ
    rng = np.random.default_rng(2)
    nc = 5 if kind == "narrow" else 12
    gwl = np.linspace(0.0, 0.6, 16)
    a = rng.normal(size=(nc, nc))
    base = a @ a.T / nc + 0.1 * np.eye(nc)
    prof = np.exp(-(gwl / 0.3) ** 2)
    gamma = {"profile": prof[:, None, None] * base,
             "wideband": np.broadcast_to(0.01 * np.eye(nc), (16, nc, nc)),
             "matrix": prof[:, None, None] * base
             + np.linspace(0, 0.05, 16)[:, None, None] * np.diag(
                 np.arange(nc, dtype=float)),
             "narrow": prof[:, None, None] * base}[kind]
    wl = 2.0 * np.pi / 0.4 / 256 * np.arange(129)
    args = (wl, gamma, gwl, 300.0, 0.6, False, True)
    want = NZ.noise_factors(NZ.phonon_psd(*args, delta=102.4),
                            dtype=np.float64)
    got = NZ.phonon_factors(*args, delta=102.4, dtype=np.float64)
    if kind in ("matrix", "narrow"):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        return
    assert got[0].strides[0] == 0 and want[0].strides[0] == 0
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=1e-12 * want[1].max())
