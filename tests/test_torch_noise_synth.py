"""Noise synthesis of the port on the CPU: the Philox twin of kernels K3
and K3b (``ops.philox``, ``kernels.noise_synth``), the half-spectrum C2R
synthesis, and the samplers of ``ops.noise`` against the JAX package's on
the same draws (CPU float64). The kernels themselves are held against
these twins on the card (``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from sclmd_tpu import units as JU
from sclmd_tpu.ops import noise as JN

from sclmd_tpu_torch.kernels import noise_synth as K3
from sclmd_tpu_torch.ops import noise as TN
from sclmd_tpu_torch.ops.functions import fourier_w2t
from sclmd_tpu_torch.ops import philox as P
from test_functions import equ_ref

torch.set_num_threads(2)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    got = P.philox4x32(*ctr, *key)
    assert tuple(int(w) for w in got) == want


def test_philox_batched_words_match_scalar():
    """A batch of counters gives each counter's words."""
    c0 = torch.tensor([0, 1, 7, 0xfffffffe])
    c2 = torch.tensor([5, 5, 9, 0xffffffff])
    words = P.philox4x32(c0, 0, c2, 0, 0x1234, 0xabcdef01)
    for i in range(4):
        one = P.philox4x32(int(c0[i]), 0, int(c2[i]), 0, 0x1234, 0xabcdef01)
        assert [int(w[i]) for w in words] == [int(w) for w in one]


def test_draws_depend_on_the_trajectory_only():
    """Windows [0, 5) and [3, 5) draw bitwise the same numbers; streams
    and seeds give other numbers."""
    n = 37
    for fn in (P.normals, P.uniforms):
        full, win = fn(9, 1, 0, 5, n), fn(9, 1, 3, 5, n)
        assert torch.equal(full[3:], win)
        assert not torch.equal(fn(9, 2, 0, 5, n), full)
        assert not torch.equal(fn(10, 1, 0, 5, n), full)
    # a longer row keeps the first elements of a shorter one
    assert torch.equal(P.normals(9, 1, 0, 5, 64)[:, :n], P.normals(9, 1, 0, 5,
                                                                   n))


def test_uniforms_exact_and_in_range():
    """((x >> 8) | 1) 2^-24: odd multiples of 2^-24 in [2^-24, 1), equal
    in float32 and float64."""
    u32 = P.uniforms(3, 4, 0, 64, 999)
    u64 = P.uniforms(3, 4, 0, 64, 999, dtype=torch.float64)
    assert torch.equal(u32.double(), u64)
    assert float(u64.min()) >= 2.0 ** -24 and float(u64.max()) < 1.0
    k = u64 * 2.0 ** 24
    assert torch.equal(k, k.round()) and bool((k.long() % 2 == 1).all())
    assert abs(float(u64.mean()) - 0.5) < 0.01


def test_normals_are_box_muller_of_the_words():
    words = P._blocks(4, 0, 2, 3, 8, "cpu")[0]
    u = P.uniform_of(words, torch.float64)
    r01 = np.sqrt(-2 * np.log(float(u[0])))
    r23 = np.sqrt(-2 * np.log(float(u[2])))
    want = [r01 * np.cos(2 * np.pi * float(u[1])),
            r01 * np.sin(2 * np.pi * float(u[1])),
            r23 * np.cos(2 * np.pi * float(u[3])),
            r23 * np.sin(2 * np.pi * float(u[3]))]
    np.testing.assert_allclose(P.normals(4, 0, 2, 3, 4)[0].numpy(), want,
                               rtol=1e-14)
    z = P.normals(1, 0, 0, 200, 4000)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.var()) - 1) < 0.01


def _factors(kind, nc, nmd, seed=0):
    """(evecs, std) in the port's form: one matrix for ``prop`` (nc >= 8,
    where ``noise_factors`` detects a proportional spectrum), else the
    batch."""
    rng = np.random.default_rng(seed)
    h = nmd // 2 + 1
    if kind == "prop":
        m = rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc))
        s0 = m @ m.conj().T + nc * np.eye(nc)
        psd = (np.abs(rng.normal(size=h)) + 0.1)[:, None, None] * s0[None]
    else:
        psd = np.stack([(lambda m: m @ m.conj().T + nc * np.eye(nc))(
            rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc)))
            for _ in range(h)])
    ev, std = TN.noise_factors(psd)
    assert (ev.strides[0] == 0) == (kind == "prop")
    return TN.factor_matrix(ev), std


@pytest.mark.parametrize("nc,ntraj,h,batch,cw,smem_u", [
    (150, 1024, 513, False, 19, True),   # the flagship's electron baths
    (150, 128, 513, False, 19, True),
    (90, 256, 1025, False, 12, True),    # the primary junction's baths
    (90, 1, 1025, False, 12, True),      # md.Run's one-trajectory window
    (48, 128, 513, False, 6, True),      # the periodic sheet
    (37, 100, 129, False, 5, True),      # padded to 40
    (90, 37, 1025, True, 12, True),      # a per-frequency batch, ragged
    (200, 512, 33, False, 20, False),    # U read from global memory
])
def test_k3_launch_plan(nc, ntraj, h, batch, cw, smem_u):
    """K3's launch plan at the main path's shapes: a consumer warp per
    m-tile of U (up to 20), producers in the rest of the 24 warps, U
    staged where it fits beside two draw tiles, a persistent CTA per SM
    (one per frequency for a batch)."""
    plan = K3.launch_plan(nc, ntraj, h, batch, 132)
    assert (plan["cw"], plan["a_smem"]) == (cw, smem_u)
    ncp = K3.padded_width(nc)
    assert plan["ncp"] == ncp and plan["lda"] == K3.row_stride(ncp)
    assert plan["pw"] + plan["cw"] == K3.WARPS == 24
    assert plan["threads"] == K3.MAX_THREADS
    assert plan["smem_bytes"] <= K3.SMEM_LIMIT
    assert plan["smem_bytes"] == 4 * 2 * ncp * K3.LDX + (
        4 * 2 * ncp * plan["lda"] if smem_u else 0)
    assert plan["tiles"] == -(-(ntraj if batch else h * ntraj) // K3.BN)
    assert plan["grid"] == (h if batch else min(plan["tiles"], 132))
    assert K3.launch_plan(nc, ntraj, h, batch, 132, cw=1)["cw"] == 1


@settings(max_examples=200, deadline=None)
@given(nc=st.integers(1, 400), ntraj=st.integers(1, 4096),
       h=st.integers(2, 2049), batch=st.booleans(),
       nsm=st.integers(1, 132), cw=st.one_of(st.none(), st.integers(1, 30)))
def test_k3_launch_plan_limits(nc, ntraj, h, batch, nsm, cw):
    """Any plan fits the kernel: 24 warps, at least four producers,
    consumer warps no more than U's m-tiles, shared memory within the
    card's limit, U's rows with a conflict-free stride (= 8 or 24 mod 32,
    even for 8-byte loads), a tile for every column, and no more CTAs
    than tiles (the proportional path) or one per frequency (the batch
    path)."""
    p = K3.launch_plan(nc, ntraj, h, batch, nsm, cw=cw)
    assert p["ncp"] % 8 == 0 and nc <= p["ncp"] < nc + 8
    assert p["lda"] % 32 in (8, 24) and p["ncp"] <= p["lda"] <= p["ncp"] + 8
    assert 1 <= p["cw"] <= min(p["ncp"] // 8, K3.MAX_CONSUMER_WARPS)
    assert p["pw"] >= 4 and p["pw"] + p["cw"] == K3.WARPS
    assert p["threads"] == K3.MAX_THREADS
    assert p["smem_bytes"] <= K3.SMEM_LIMIT
    cols = ntraj if batch else h * ntraj
    assert (p["tiles"] - 1) * K3.BN < cols <= p["tiles"] * K3.BN
    assert p["grid"] == (h if batch else min(p["tiles"], nsm))
    if cw is not None:
        assert p["cw"] <= cw


@pytest.mark.parametrize("nc,kind", [(37, "prop"), (48, "batch"),
                                     (90, "prop"), (5, "batch")])
def test_pack_factor_layout(nc, kind):
    """K3's packed operand: nc zero-padded to a multiple of 8, each 8
    channels as 16 rows (real parts, then imaginary parts), column k at
    (k & ~7) + 2 (k & 3) + ((k >> 2) & 1) (k and k + 4 side by side),
    every padded row, column and row tail zero; made once per bath by
    ``Factors``, on the card only."""
    ev, std = _factors(kind, nc, 16)
    ev = torch.as_tensor(ev).to(torch.complex64)
    a = K3.pack_factor(ev)
    ncp = K3.padded_width(nc)
    lda = K3.row_stride(ncp)
    nu = 1 if ev.ndim == 2 else ev.shape[0]
    assert a.shape == (nu, 2 * ncp, lda) and a.dtype == torch.float32
    u = ev if ev.ndim == 3 else ev[None]
    col = [(k & ~7) + 2 * (k & 3) + ((k >> 2) & 1) for k in range(nc)]
    assert sorted(col + [(k & ~7) + 2 * (k & 3) + ((k >> 2) & 1)
                         for k in range(nc, ncp)]) == list(range(ncp))
    for i in range(ncp):
        m, r = divmod(i, 8)
        re, im = a[:, 16 * m + r], a[:, 16 * m + 8 + r]
        if i < nc:
            assert torch.equal(re[:, col], u[:, i].real)
            assert torch.equal(im[:, col], u[:, i].imag)
            rest = [c for c in range(lda) if c not in col]
            assert not re[:, rest].any() and not im[:, rest].any()
        else:
            assert not re.any() and not im.any()
    f = K3.Factors(ev, torch.as_tensor(std))
    ev2, std2 = f
    assert ev2 is ev and f.packed is None       # packed only on the card


@pytest.mark.parametrize("kind", ["prop", "batch"])
def test_twin_series_matches_jax_samplers(kind):
    """The twin's series (draw x std, U product, C2R) equals the JAX
    package's sample_noise_prop / sample_noise_parts on the same draw."""
    nc, nmd, dt = 9, 64, 0.4
    ev, std = _factors(kind, nc, nmd)
    key = jax.random.PRNGKey(4)
    r = np.array(jax.random.normal(key, std.shape, dtype=jnp.float64))
    sampler = JN.sample_noise_prop if kind == "prop" else \
        JN.sample_noise_parts
    want = np.asarray(sampler(key, np.ascontiguousarray(ev.real),
                              np.ascontiguousarray(ev.imag), std, dt, nmd))
    got = TN.sample_noise_from_r(torch.as_tensor(r), torch.as_tensor(ev),
                                 torch.as_tensor(std), dt, nmd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["prop", "batch"])
def test_folded_twin_series_matches_jax_samplers(kind, monkeypatch):
    """K3's twin with its conventions (conj, 1 / (nmd dt), frequency
    last) and the C2R stage after it give the series of the JAX
    package's sample_noise_prop / sample_noise_parts on the same draw
    (injected in place of the schedule's), to 1e-10 of its largest
    value (float64, two FFT orders)."""
    nc, nmd, dt = 9, 64, 0.4
    ev, std = _factors(kind, nc, nmd)
    key = jax.random.PRNGKey(7)
    r = np.array(jax.random.normal(key, std.shape, dtype=jnp.float64))
    monkeypatch.setattr(K3, "draw_plain", lambda sd, *a: torch.as_tensor(
        r)[None] * sd)
    sampler = JN.sample_noise_prop if kind == "prop" else \
        JN.sample_noise_parts
    want = np.asarray(sampler(key, np.ascontiguousarray(ev.real),
                              np.ascontiguousarray(ev.imag), std, dt, nmd))
    y = K3.noise_halfspectrum(torch.as_tensor(ev), torch.as_tensor(std), 0,
                              0, 0, 1, 1.0 / (nmd * dt))
    assert y.shape == (1, nc, nmd // 2 + 1)
    assert not y[..., 0].imag.any() and not y[..., -1].imag.any()
    got = TN.series_from_halfspectrum(y, nmd)
    assert got.shape == (1, nmd, nc) and got.is_contiguous()
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["prop", "batch"])
def test_twin_halfspectrum_is_the_schedules_draw(kind):
    """K3's twin: the schedule's normals x std through the U product,
    folded as K3 writes it (conj x scale, frequency last, edge rows real),
    and chunk windows bitwise equal to the whole."""
    nc, nmd, scale = 8, 32, 0.37
    ev, std = _factors(kind, nc, nmd)
    ev, std = torch.as_tensor(ev), torch.as_tensor(std)
    xi = K3.noise_halfspectrum(ev, std, 21, 1, 0, 6, scale)
    assert xi.shape == (6, nc, nmd // 2 + 1) and xi.is_contiguous()
    z = P.normals(21, 1, 0, 6, std.numel()).reshape((6,) + std.shape)
    want = np.einsum("...ij,t...j->t...i", ev.numpy(), z.numpy() * std.numpy())
    want[:, [0, -1]] = want[:, [0, -1]].real      # DC and Nyquist rows
    want = np.conj(want).transpose(0, 2, 1) * scale
    np.testing.assert_allclose(xi.numpy(), want, rtol=1e-12, atol=1e-13)
    for lo, hi in ((0, 1), (2, 5), (5, 6)):
        assert torch.equal(K3.noise_halfspectrum(ev, std, 21, 1, lo, hi,
                                                 scale), xi[lo:hi])
    assert torch.equal(K3.draw_plain(std, 21, 1, 0, 6), z * std)


def test_hfft_equals_mirrored_fft():
    """The C2R transform of the folded half spectrum is the real part of
    the forward FFT of the mirrored spectrum, imaginary parts of rows 0
    and nmd/2 included; and it is hfft / (nmd dt), the form before the
    fold."""
    nmd, dt = 64, 0.3
    rng = np.random.default_rng(3)
    xi = rng.normal(size=(3, nmd // 2 + 1, 4)) + \
        1j * rng.normal(size=(3, nmd // 2 + 1, 4))
    x = torch.as_tensor(xi)
    want = torch.real(fourier_w2t(TN.mirror_halfspectrum(x, nmd), dt,
                                  dim=-2))
    y = TN.fold_halfspectrum(x, 1.0 / (nmd * dt))
    assert y.shape == (3, 4, nmd // 2 + 1) and y.is_contiguous()
    got = TN.series_from_halfspectrum(y, nmd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-14 * float(want.abs().max()))
    assert got.is_contiguous() and got.shape == (3, nmd, 4)
    np.testing.assert_allclose(
        got.numpy(), (torch.fft.hfft(x, n=nmd, dim=-2) / (nmd * dt)).numpy(),
        rtol=0, atol=1e-14 * float(want.abs().max()))
    # the real series does not keep the edge rows' imaginary parts
    dropped = TN.drop_edge_imag_(x.clone())
    assert not dropped[:, [0, -1]].imag.any()
    assert torch.equal(dropped[:, 1:-1], x[:, 1:-1])
    np.testing.assert_allclose(
        TN.synthesize_series(dropped, dt, nmd).numpy(), want.numpy(),
        rtol=0, atol=1e-14 * float(want.abs().max()))


@pytest.mark.parametrize("nmd,ntraj,nc", [(256, 64, 37), (1024, 64, 150),
                                          (2048, 1, 90), (16384, 2, 37)])
def test_c2r_batches(nmd, ntraj, nc):
    """The C2R stage's fixed batch per nmd (~32 MB of output, whatever the
    chunk), and K3's output buffer running on to whole batches."""
    b0 = K3.c2r_batch(nmd)
    assert b0 == max(1, 2 ** 23 // nmd) and b0 * nmd <= 2 ** 23
    y = K3.spectrum_buffer((ntraj, nc, nmd // 2 + 1), "cpu")
    assert y.shape == (ntraj, nc, nmd // 2 + 1) and y.is_contiguous()
    nb = ntraj * nc
    assert y.untyped_storage().nbytes() == \
        8 * (nmd // 2 + 1) * -(-nb // b0) * b0


def test_transpose_twin():
    """The series' layout step: (..., r, c) -> (..., c, r) contiguous,
    any leading dims (the card's kernel is held to this twin)."""
    x = torch.arange(2 * 3 * 5 * 7, dtype=torch.float32).reshape(2, 3, 5, 7)
    got = K3.transpose(x)
    assert got.shape == (2, 3, 7, 5) and got.is_contiguous()
    assert torch.equal(got, x.transpose(-1, -2))
    assert torch.equal(K3.transpose_plain(x), got)


def test_schedule_noise_windows_and_stream(tmp_path):
    nc, nmd, dt = 5, 32, 0.4
    ev, std = (torch.as_tensor(a) for a in _factors("batch", nc, nmd))
    full = TN.schedule_noise(ev, std, 2, 0, 0, 4, dt, nmd)
    assert full.shape == (4, nmd, nc) and full.dtype == torch.float64
    assert torch.equal(TN.schedule_noise(ev, std, 2, 0, 1, 3, dt, nmd),
                       full[1:3])
    z = P.normals(2, 0, 0, 4, std.numel()).reshape((4,) + std.shape)
    assert torch.equal(full, TN.sample_noise_from_r(z, ev, std, dt, nmd))


# --- the samplers of ops.noise against the JAX package ---------------------
def test_halfspectrum_freqs():
    got = TN.halfspectrum_freqs(0.4, 32, dtype=torch.float64)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JN.halfspectrum_freqs(0.4, 32, jnp.float64)),
        rtol=1e-15)
    with pytest.raises(ValueError, match="even"):
        TN.halfspectrum_freqs(0.4, 31)


@pytest.mark.parametrize("kind", ["prop", "batch"])
def test_sample_noise_matches_jax(kind):
    nc, nmd, dt = 9, 32, 0.3
    ev, std = _factors(kind, nc, nmd)
    full_ev = np.broadcast_to(ev, (nmd // 2 + 1, nc, nc)) \
        if kind == "prop" else ev
    key = jax.random.PRNGKey(8)
    r = torch.as_tensor(np.array(jax.random.normal(key, std.shape,
                                                     dtype=jnp.float64)))
    want = np.asarray(JN.sample_noise(key, full_ev, std, dt, nmd))
    got = TN.sample_noise(r, ev, std, dt, nmd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    # the schedule's draw: trajectory 3 of the window [0, 4)
    sched = TN.sample_noise((5, 1, 3), torch.as_tensor(ev),
                            torch.as_tensor(std), dt, nmd)
    np.testing.assert_array_equal(
        sched.numpy(), TN.schedule_noise(torch.as_tensor(ev),
                                         torch.as_tensor(std), 5, 1, 0, 4,
                                         dt, nmd)[3].numpy())


def test_sample_noise_np_is_the_jax_hosts():
    nc, nmd, dt = 4, 32, 0.3
    ev, std = _factors("batch", nc, nmd)
    got = TN.sample_noise_np(np.random.default_rng(2), ev, std, dt, nmd)
    want = JN.sample_noise_np(np.random.default_rng(2), ev, std, dt, nmd)
    np.testing.assert_array_equal(got, want)


def _psd(nc, nw, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([(lambda m: m @ m.conj().T + 0.5 * np.eye(nc))(
        rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc)))
        for _ in range(nw)])


def test_sample_from_psd_and_synthesize_match_jax():
    nc, nmd, dt = 4, 32, 0.3
    psd = _psd(nc, nmd // 2 + 1)
    key = jax.random.PRNGKey(3)
    r = torch.as_tensor(np.array(jax.random.normal(
        key, (nmd // 2 + 1, nc), dtype=jnp.float64)))
    want = np.asarray(JN.sample_from_psd(key, jnp.asarray(psd)))
    got = TN.sample_from_psd(r, psd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    want_s = np.asarray(JN.synthesize(key, jnp.asarray(psd), dt, nmd))
    got_s = TN.synthesize(r, psd, dt, nmd)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                               atol=1e-10 * np.abs(want_s).max())


def test_enoise_phnoise_match_jax():
    nc, nmd, dt = 3, 64, 0.5
    rng = np.random.default_rng(6)
    a = rng.normal(size=(nc, nc))
    efric = a @ a.T * 0.1 + 0.2 * np.eye(nc)
    b = rng.normal(size=(nc, nc))
    exim = 0.02 * (b - b.T)
    exip = 0.01 * (b + b.T)
    key = jax.random.PRNGKey(1)
    r = torch.as_tensor(np.array(jax.random.normal(
        key, (nmd // 2 + 1, nc), dtype=jnp.float64)))
    want = np.asarray(JN.enoise(key, jnp.asarray(efric), jnp.asarray(exim),
                                jnp.asarray(exip), 0.3, 300.0, 1.0, dt, nmd))
    got = TN.enoise(r, efric, exim, exip, 0.3, 300.0, 1.0, dt, nmd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-9 * np.abs(want).max())
    gwl = np.linspace(0.0, 2.0, 9)
    gamma = np.stack([efric * np.exp(-w) for w in gwl])
    want = np.asarray(JN.phnoise(key, jnp.asarray(gamma), jnp.asarray(gwl),
                                 250.0, 1.5, dt, nmd))
    got = TN.phnoise(r, gamma, gwl, 250.0, 1.5, dt, nmd)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


def test_enoisew_phnoisew_mf_match_jax():
    nc = 3
    rng = np.random.default_rng(2)
    efric = np.eye(nc) * 0.1
    b = rng.normal(size=(nc, nc))
    wl = np.linspace(-1.0, 1.0, 11)
    want = np.asarray(JN.enoisew(jnp.asarray(wl), jnp.asarray(efric),
                                 jnp.asarray(0.01 * (b - b.T)),
                                 jnp.asarray(0.01 * (b + b.T)), 0.2, 300.0,
                                 1.5))
    got = TN.enoisew(wl, efric, 0.01 * (b - b.T), 0.01 * (b + b.T), 0.2,
                     300.0, 1.5)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    gam = np.abs(rng.normal(size=11))
    np.testing.assert_allclose(
        TN.phnoisew(gam, wl, 300.0, 1.5),
        np.asarray(JN.phnoisew(jnp.asarray(gam), jnp.asarray(wl), 300.0,
                               1.5)), rtol=1e-12)
    out = TN.mf(torch.tensor([1.0, 2.0]), [3, 1], 5)
    np.testing.assert_array_equal(out.numpy(), [0, 2, 0, 1, 0])
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(JN.mf(jnp.array([1.0, 2.0]),
                                      jnp.array([3, 1]), 5)))


@pytest.mark.parametrize("kind", ["prop", "batch"])
@pytest.mark.parametrize("t0,seg,fchunk", [(0, 16, 2048), (37, 20, 5),
                                            (120, 8, 7)])
def test_sample_noise_window_matches_full_series(kind, t0, seg, fchunk):
    """Rows [t0, t0+seg) of the full series from the same draw (a window
    may wrap past nmd), and the JAX package's window on that draw."""
    nc, nmd, dt = 8, 128, 0.4
    ev, std = _factors(kind, nc, nmd)
    tev, tstd = torch.as_tensor(ev), torch.as_tensor(std)
    draw = (13, 0, 2)
    full = TN.sample_noise(draw, tev, tstd, dt, nmd)
    got = TN.sample_noise_window(draw, tev, tstd, dt, nmd, t0, seg, fchunk)
    rows = [(t0 + k) % nmd for k in range(seg)]
    np.testing.assert_allclose(got.numpy(), full[rows].numpy(), rtol=0,
                               atol=1e-11 * float(full.abs().max()))
    key = jax.random.PRNGKey(6)
    r = np.array(jax.random.normal(key, std.shape, dtype=jnp.float64))
    want = np.asarray(JN.sample_noise_window(
        key, np.ascontiguousarray(ev.real), np.ascontiguousarray(ev.imag),
        std, dt, nmd, t0, seg, fchunk))
    got = TN.sample_noise_window(torch.as_tensor(r), tev, tstd, dt, nmd, t0,
                                 seg, fchunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-11 * np.abs(want).max())


def test_sample_noise_window_needs_power_of_two():
    ev, std = (torch.as_tensor(a) for a in _factors("batch", 3, 24))
    with pytest.raises(ValueError, match="power-of-two"):
        TN.sample_noise_window((1, 0, 0), ev, std, 0.4, 24, 0, 4)


# --- TestSynthesis of tests/test_noise.py on the port's sampler --------------
def test_shapes_and_realness():
    nc, nmd, dt = 3, 128, 0.5
    z = np.zeros((nc, nc))
    out = TN.enoise((0, 0, 0), np.eye(nc) * 0.2, z, z, 0.0, 300.0, 1.0, dt,
                    nmd)
    assert out.shape == (nmd, nc) and out.dtype == torch.float64


def test_variance_sum_rule_classical():
    """Sample variance ~ (1/2pi) * integral of S(w) dw over both signs."""
    nc, nmd, dt = 2, 4096, 0.25
    gam, T, cut = 0.3, 400.0, 2.0
    gamma, gwl = np.array([np.eye(nc) * gam]), np.array([0.0])
    series = torch.stack([TN.phnoise((7, 0, j), gamma, gwl, T, cut, dt, nmd,
                                     classical=True) for j in range(16)])
    expect = 2 * gam * JU.KB * T * (2 * cut) / (2 * np.pi)
    assert abs(float(series.var()) - expect) / expect < 0.05


def test_quantum_vs_classical_zero_point():
    nc, nmd, dt = 1, 2048, 0.25
    gamma, gwl = np.array([np.eye(nc) * 0.2]), np.array([0.0])
    sq = TN.phnoise((1, 0, 0), gamma, gwl, 0.0, 1.0, dt, nmd,
                    classical=False, zpmotion=True)
    scl = TN.phnoise((1, 0, 0), gamma, gwl, 0.0, 1.0, dt, nmd,
                     classical=True)
    assert float(sq.var()) > 10 * float(scl.var() + 1e-30)


def test_autocorrelation_matches_target_spectrum():
    """The time-averaged autocorrelation of the schedule's noise is the
    inverse transform of the target PSD (first eight lags)."""
    nc, nmd, dt = 1, 4096, 0.5
    gam, T, cut = 0.4, 300.0, 1.5
    gamma, gwl = np.array([np.eye(nc) * gam]), np.array([0.0])
    series = torch.stack([TN.phnoise((3, 0, j), gamma, gwl, T, cut, dt, nmd)
                          for j in range(64)]).numpy()[:, :, 0]
    fw = np.fft.fft(series, axis=1)
    emp = np.real(np.fft.ifft(np.abs(fw) ** 2, axis=1)).mean(axis=0) / nmd
    wl = TN.halfspectrum_freqs(dt, nmd, dtype=torch.float64).numpy()
    s_half = np.array([equ_ref(w, cut, T) * gam for w in wl])
    s_full = np.concatenate([s_half[:-1], s_half[1:][::-1]])
    target = np.real(np.fft.fft(s_full)) / (nmd * dt)
    np.testing.assert_allclose(emp[:8], target[:8], rtol=0.1,
                               atol=0.02 * abs(target[0]))
