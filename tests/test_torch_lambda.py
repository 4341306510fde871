"""Parity of the port's Lambda pipeline
(``sclmd_tpu_torch.postprocess.lambda_pipeline``, complex128 torch on the
CPU) with the JAX package's numpy backend on the same inputs: every
result within 1e-10 of the largest magnitude of the compared quantity.
The port's results do not depend on ``mode_chunk`` or ``batch_size``
(within 1e-12 of the largest), and the FFT route agrees with direct
integration as the JAX package's tests hold it.
"""

import numpy as np
import pytest
import torch

from sclmd_tpu.postprocess import lambda_pipeline as JL

from sclmd_tpu_torch.postprocess import lambda_pipeline as TL

TOL = 1e-10
CPU = "cpu"


def close(got, want, tol=TOL):
    got = np.asarray(TL._host(got))
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def model(rng, n=8, nm=5, ne=128, emax=4.0, gam=0.8):
    """Random Hermitian junction with smooth energy-dependent leads
    (tests/test_lambda.py's small_model)."""
    E = JL.fft_order_grid(emax, ne)
    h = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    H = 0.3 * (h + h.conj().T) / 2
    S = np.eye(n, dtype=complex)
    gl = np.zeros((n, n))
    gl[0, 0] = gl[1, 1] = gam
    gr = np.zeros((n, n))
    gr[-1, -1] = gr[-2, -2] = gam
    band = 1.0 / (1.0 + (E / (0.7 * emax)) ** 6)
    SigL = -0.5j * band[:, None, None] * gl[None]
    SigR = -0.5j * band[:, None, None] * gr[None]
    m = rng.normal(size=(nm, n, n))
    M = np.array([(mi + mi.T) / 2 * 0.1 for mi in m]).astype(complex)
    hw = np.sort(rng.random(nm) * 0.3 + 0.05)
    return H, S, E, SigL, SigR, M, hw


SHAPES = [(6, 4, 64), (8, 5, 128), (10, 6, 256)]


@pytest.fixture(scope="module", params=SHAPES,
                ids=[f"n{n}-nm{nm}-ne{ne}" for n, nm, ne in SHAPES])
def pair(request):
    n, nm, ne = request.param
    args = model(np.random.default_rng(7 + n), n=n, nm=nm, ne=ne)
    umodes = np.random.default_rng(3).normal(size=(nm, nm + 2))
    jp = JL.LambdaPipeline(*args, Umodes=umodes, T=25.0)
    tp = TL.LambdaPipeline(*args, Umodes=umodes, T=25.0, device=CPU,
                           mode_chunk=3)
    return jp, tp, args


def test_grids():
    for ne in (8, 9, 64):
        np.testing.assert_array_equal(TL.fft_order_grid(2.0, ne),
                                      JL.fft_order_grid(2.0, ne))
    E = TL.fft_order_grid(2.0, 8)
    np.testing.assert_array_equal(TL.reord(E), JL.reord(E))
    for n in (6, 7):
        a = np.arange(float(n)) + 1j
        np.testing.assert_array_equal(TL.trev(torch.as_tensor(a)).numpy(),
                                      JL.trev(a))
        np.testing.assert_array_equal(TL.trev(a), JL.trev(a))


@pytest.mark.parametrize("ne", [15, 16])
def test_padding_odd_and_even(rng, ne):
    a = rng.normal(size=(2, ne, 3)) + 1j * rng.normal(size=(2, ne, 3))
    for npad in (0, 4, 6):
        p = TL._pad_middle(torch.as_tensor(a), npad, 1)
        np.testing.assert_array_equal(p.numpy(),
                                      JL._pad_middle(a, npad, 1, np))
        np.testing.assert_array_equal(TL._unpad_middle(p, npad, 1).numpy(),
                                      a)


def test_cut_helpers(rng):
    a = rng.normal(size=(6, 6))
    psd = a @ a.T
    np.testing.assert_array_equal(TL.cutA(psd, 1e-2), JL.cutA(psd, 1e-2))
    for x, y in zip(TL.cutM(a + a.T, 0.3), JL.cutM(a + a.T, 0.3)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ne", [15, 16])
def test_energy_correlation(rng, ne):
    u = rng.normal(size=(2, ne, 3)) + 1j * rng.normal(size=(2, ne, 3))
    v = rng.normal(size=(3, ne, 3)) + 1j * rng.normal(size=(3, ne, 3))
    for npad in (None, 0):
        close(TL.energy_correlation(torch.as_tensor(u), torch.as_tensor(v),
                                    npad=npad),
              JL.energy_correlation(u, v, npad=npad))
    # the circular form against the naive sum
    want = np.zeros((2, 3, ne), complex)
    for w in range(ne):
        for e in range(ne):
            want[:, :, w] += np.einsum("kd,ld->kl", u[:, (e + w) % ne],
                                       v[:, e])
    close(TL.energy_correlation(torch.as_tensor(u), torch.as_tensor(v),
                                npad=0), want)


def test_spectral_functions(pair):
    jp, tp, (H, S, E, SigL, SigR, M, hw) = pair
    want = JL.spectral_functions(H, S, E, SigL, SigR)
    got = TL.spectral_functions(H, S, E, SigL, SigR, device=CPU)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    for k in tp.sp:
        close(tp.sp[k], jp.sp[k])


def test_spectral_functions_do_not_depend_on_batch_size(rng):
    H, S, E, SigL, SigR, _, _ = model(rng, ne=100)
    ref = TL.spectral_functions(H, S, E, SigL, SigR, batch_size=1,
                                device=CPU)
    for bs in (7, 33, 100):
        got = TL.spectral_functions(H, S, E, SigL, SigR, batch_size=bs,
                                    device=CPU)
        for k in ref:
            close(got[k], ref[k], 1e-12)


def test_pair_mask_and_mama(pair, rng):
    jp, tp, _ = pair
    for hwcut in (0.0, 0.05, 10.0):
        np.testing.assert_array_equal(TL._pair_mask(tp.hw, hwcut),
                                      JL._pair_mask(jp.hw, hwcut))
    for a, b in (("L", "R"), ("A", "A"), ("R", "L")):
        for mode in ("tril", "sym", None):
            close(tp.mama(0.1, -0.2, a, b, 0.1, herm_mode=mode),
                  jp.mama(0.1, -0.2, a, b, 0.1, herm_mode=mode))
    Aa = rng.normal(size=(tp.n, tp.n)) + 0j
    mask = TL._pair_mask(tp.hw, 0.2)
    close(TL.mama_single(tp.M, Aa, Aa.T, mask),
          JL.mama_single(np.asarray(jp.M), Aa, Aa.T, mask))


def test_mode_fields_and_chunked_correlation(pair):
    jp, tp, _ = pair
    A, AL = jp.sp["A"], jp.sp["AL"]
    f = JL.fermi(jp.E, 0.1, jp.T, xp=np)
    Mn = np.asarray(jp.M)
    close(TL._mode_fields(tp.M, tp.sp["A"], f),
          JL._mode_fields(Mn, A, weight=f))
    close(TL._mode_fields_T(tp.M, tp.sp["AL"], None),
          JL._mode_fields_T(Mn, AL))
    close(TL.chunked_correlation(tp.M, tp.sp["A"], tp.sp["AL"], f, None, 2),
          JL.chunked_correlation(Mn, A, AL, f, None, 2))
    close(TL.chunked_correlation(tp.M, tp.sp["A"], tp.sp["AL"], f, None, 4,
                                 swapped=True),
          jp._corr_swapped(A, AL, f, None))


def test_lambda_functions(pair):
    jp, tp, _ = pair
    for a, b, mua, mub in (("L", "R", 0.3, -0.3), ("R", "R", -0.3, -0.3),
                           ("R", "L", -0.3, 0.3)):
        close(tp.lambda_fft(a, b, mua, mub, 0.1),
              jp.lambda_fft(a, b, mua, mub, 0.1))
    close(tp.equ_lambda_fft(0.1, 0.05), jp.equ_lambda_fft(0.1, 0.05))
    for got, want in zip(tp.nonequ_lambda_fft(0.1, 0.3, -0.3),
                         jp.nonequ_lambda_fft(0.1, 0.3, -0.3)):
        close(got, want)
    w = tp.E[5]
    close(tp.lambda_direct(w, "L", "R", 0.3, -0.3, tp.de, 3.0, 10.0),
          jp.lambda_direct(w, "L", "R", 0.3, -0.3, jp.de, 3.0, 10.0))


def test_wideband_and_full_lambda(pair):
    jp, tp, _ = pair
    wt, wj = tp.wideband(0.1), jp.wideband(0.1)
    assert set(wt) == set(wj)
    for k in wj:
        close(wt[k], wj[k])
    ft, fj = tp.full_lambda(0.1, 0.3, -0.3), jp.full_lambda(0.1, 0.3, -0.3)
    assert set(ft) == set(fj)
    for k in fj:
        close(ft[k], fj[k])


def test_write_bundle(pair, tmp_path):
    jp, tp, _ = pair
    ft, wt = tp.write(str(tmp_path / "t.npz"), 0.1, 0.3, -0.3)
    jp.write(str(tmp_path / "j.npz"), 0.1, 0.3, -0.3)
    dt, dj = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(dt.files) == sorted(dj.files)
    for k in dj.files:
        close(dt[k], dj[k])


def test_results_do_not_depend_on_mode_chunk(rng):
    args = model(rng, n=6, nm=5, ne=64)
    ref = TL.LambdaPipeline(*args, T=10.0, device=CPU, mode_chunk=5)
    want = ref.full_lambda(0.2, 0.3, -0.3)
    for ch in (1, 2, 4):
        got = TL.LambdaPipeline(*args, T=10.0, device=CPU, mode_chunk=ch,
                                batch_size=3).full_lambda(0.2, 0.3, -0.3)
        for k in want:
            close(got[k], want[k], 1e-12)


def test_host_helpers(rng):
    E = TL.fft_order_grid(3.0, 32)
    lams = [rng.normal(size=(32, 3, 3)) + 1j * rng.normal(size=(32, 3, 3))
            for _ in range(4)]
    for got, want in zip(TL.domapping(E, 0.4, -0.4, *lams),
                         JL.domapping(E, 0.4, -0.4, *lams)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TL.pir_from_pira(E, lams[0]),
                                  JL.pir_from_pira(E, lams[0]))
    hw = np.array([0.05, 0.1, 0.2])
    a = rng.normal(size=(3, 3))
    eta = a @ a.T * 0.01 + np.eye(3) * 0.01
    xim = (a - a.T) * 0.001
    z1 = (a + a.T) * 1e-4
    z2 = (a - a.T) * 1e-4
    for got, want in zip(TL.eigenanalysis(0.5, 4, hw, eta, xim, z1, z2),
                         JL.eigenanalysis(0.5, 4, hw, eta, xim, z1, z2)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            TL.joule_heating(0.5, 4, hw, eta, xim, eta, z1, z2, T=50.0),
            JL.joule_heating(0.5, 4, hw, eta, xim, eta, z1, z2, T=50.0)):
        np.testing.assert_array_equal(got, want)
    Mraw = rng.normal(size=(3, 4, 4)) + 1j * rng.normal(size=(3, 4, 4))
    np.testing.assert_array_equal(
        TL.prepare_eph_matrices(Mraw, [0.1, -0.1, 0.2]),
        JL.prepare_eph_matrices(Mraw, [0.1, -0.1, 0.2]))


def test_fft_matches_direct_integration(rng):
    """LambdaFFT == direct zero-T integration within the grid's O(dE)
    (the bar tests/test_lambda.py holds the JAX package to)."""
    pl = TL.LambdaPipeline(*model(rng, n=6, nm=3, ne=512), device=CPU)
    muL, muR = 0.4, -0.4
    lam = pl.lambda_fft("L", "R", muL, muR, hwcut=10.0)
    for w in [1.0, 1.5, 2.2]:
        wi = int(round(w / pl.de))
        want = pl.lambda_direct(pl.E[wi], "L", "R", muL, muR,
                                dw=pl.de / 4, maxw=3.5, hwcut=10.0,
                                herm_mode="sym")
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(lam[wi], want, atol=0.04 * scale)


def test_wideband_grid_edge_raises(rng):
    H, S, E, SigL, SigR, M, hw = model(rng, ne=64)
    pl = TL.LambdaPipeline(H, S, E, SigL, SigR, M, hw, device=CPU)
    with pytest.raises(ValueError, match="grid edge"):
        pl.wideband(0.1, mu0=float(E.max()) + 1.0)
    jpl = JL.LambdaPipeline(H, S, E, SigL, SigR, M, hw)
    with pytest.raises(ValueError, match="grid edge"):
        jpl.wideband(0.1, mu0=float(E.max()) + 1.0)


def test_tracer_sections_and_flop_counts(rng):
    from sclmd_tpu_torch.utils.profiling import Tracer
    tr = Tracer()
    pl = TL.LambdaPipeline(*model(rng, n=6, nm=4, ne=64), device=CPU,
                           tracer=tr, mode_chunk=3)
    pl.wideband(0.1)
    pl.full_lambda(0.1, 0.3, -0.3)
    names = {k: v[0] for k, v in tr.stats.items()}
    assert names["spectral_functions"] == 1 and names["wideband"] == 1
    for c in TL.CORRELATIONS:
        assert names[c] == 1, c
    f = pl.flops()
    assert f["correlations"] == len(TL.CORRELATIONS)
    assert f["spectral_functions"] == 64 * 40.0 * 6 ** 3
    # every mode's two fields once at each of the 128 padded times
    N = 128
    fft = 5.0 * N * np.log2(N)
    want = 2 * 4 * N * 8.0 * 216 + 16 * 8.0 * N * 36 + (2 * 36 + 16) * fft
    assert f["correlation"] == pytest.approx(want)
