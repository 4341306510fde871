"""Physics the port's runners must show, at CPU sizes in float64 (the
card holds the same at the workloads' full sizes in
``test_torch_card_gates.py``):

- heat flows from the hot lead to the cold one, on every kind of system
  the runners take: the same draws at swapped lead temperatures, half
  the difference (it keeps the current the temperature difference
  drives and cancels the fluctuations the two runs share), beyond
  several standard errors;
- ``calHF``/``calTC`` read ``RunEnsemble``'s own kappa files back to its
  means, to the files' printed precision;
- the colored noise's sample variance and lag-1 covariance lie within 5
  standard errors of the values its factors give.

The helpers the card gates (``test_torch_card_gates.py``) share with
these tests live here, so that the CPU tests import nothing of the card
suite. No JAX.
"""

import numpy as np
import pytest
import torch

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch.md import md
from sclmd_tpu_torch.models.harmonic import chain_dynmat
from sclmd_tpu_torch.tools import sheet as S
from sclmd_tpu_torch.tools import slab as SL

T, DELTA, DT = 300.0, 0.5, 0.4
F64 = dict(dtype=torch.float64, device="cpu")
# the half difference beyond this many standard errors
MARGIN = 3.0


@pytest.fixture(autouse=True)
def _two_threads():
    """Two CPU threads a test, as in the other CPU files; set around each
    test rather than at import, since the card gates import this file's
    helpers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- helpers the card gates share at the workloads' full sizes -------------
def lag_covariance(ev, std, dt, nmd, lag):
    """The time-averaged covariance <x_c(t) x_c(t+lag)> of the series,
    averaged over channels, from the factors (host float64): the
    frequencies are independent, and a paired frequency m contributes
    2 E|xi_m|^2 cos(2 pi m lag / nmd) (the pseudo-covariance of a real
    draw oscillates in t and averages out over the period)."""
    U = ev.detach().cpu().to(torch.complex128).numpy()
    s2 = std.detach().double().cpu().numpy() ** 2            # (h+1, nc)
    h = nmd // 2
    if U.ndim == 2:
        p = s2 @ (np.abs(U) ** 2).T                           # (h+1, nc)
        r0, rh = (U.real ** 2) @ s2[0], (U.real ** 2) @ s2[h]
    else:
        p = np.einsum("wck,wk->wc", np.abs(U) ** 2, s2)
        r0, rh = (U[0].real ** 2) @ s2[0], (U[h].real ** 2) @ s2[h]
    m = np.arange(1, h)
    c = r0 + (-1) ** lag * rh + 2 * (np.cos(2 * np.pi * m * lag / nmd)
                                     @ p[1:h])
    return float(c.mean()) / (nmd * dt) ** 2


def noise_z_scores(fac, dt, nmd, ntraj, seed):
    """The sample variance and lag-1 covariance of ``ntraj`` trajectories
    of the schedule's stream 0, each in standard errors from its value
    by ``lag_covariance``."""
    from sclmd_tpu_torch.ops.noise import schedule_noise
    ev, std = fac
    x = schedule_noise(ev, std, seed, 0, 0, ntraj, dt, nmd,
                       packed=fac.packed).double()
    z = {}
    for key, lag in (("var", 0), ("lag1", 1)):
        s = (x * torch.roll(x, -lag, dims=1)).mean(dim=(1, 2))
        z[key] = (float(s.mean()) - lag_covariance(ev, std, dt, nmd, lag)) \
            / float(s.std() / ntraj ** 0.5)
    return z


def batch_factors(nc, nmd, device, seed=3):
    """Per-frequency factors of a random Hermitian PSD that is not
    proportional across frequencies, complex64 and float32."""
    from sclmd_tpu_torch.kernels.noise_synth import Factors
    from sclmd_tpu_torch.ops.noise import factor_matrix, noise_factors
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc))
    w = np.linspace(0.0, 1.0, nmd // 2 + 1)[:, None, None]
    m = base[None] * np.exp(-w) + 1j * w * base.T[None]
    psd = m @ np.conj(np.swapaxes(m, 1, 2)) + nc * np.eye(nc)[None]
    ev, std = noise_factors(psd, dtype=np.float32)
    ev = factor_matrix(ev)
    assert ev.ndim == 3, "the spectrum must not be proportional"
    return Factors(torch.as_tensor(ev, device=device),
                   torch.as_tensor(std, device=device))


def lead_block_chain(dtype, device, outdir, temps, nmd=2 ** 11, ml=128,
                     nph=8, k=0.04):
    """An ``nph``-atom chain between two lead-block phonon baths
    (``phbath(K00=, K01=, V01=)``: semi-infinite chain leads, mode "K") at
    lead temperatures ``temps``, T 300 K, dt 0.25 fs."""
    K00, K01, V01 = np.array([[2 * k]]), np.array([[-k]]), np.array([[-k]])
    dt = 0.25 / 0.658
    r = md(dt, nmd, 300.0, dyn=chain_dynmat(nph, k).numpy(), dtype=dtype,
           seed=5, outdir=outdir, device=device)
    for cid, tt in zip(([0], [nph - 1]), temps):
        r.AddBath(TB.phbath(tt, cid, np.sqrt(k), 400, dt, nmd, ml=ml,
                            K00=K00, K01=K01, V01=V01, mcof=2.2,
                            dtype=dtype, device=device))
    assert all(b.UseK() and b.mode == "K" for b in r.baths)
    return r


def assert_kappa_files_read_back(workdir, means, temp):
    """``calHF`` and ``calTC(0.1)`` over the kappa files in ``workdir``
    against the call's ``means`` (two or three baths; in nW, the first
    trajectory dropped): each bath's last running mean, the conductance
    and the flux between the baths, within the files' %f rounding (5e-7
    a file)."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.utils.tools import calHF, calTC
    nb = means.shape[1]
    hf = calHF(bathnum=nb, workdir=workdir)
    tc = calTC(0.1, bathnum=nb, workdir=workdir)
    j = means[1:] * units.CURCOF
    w = np.array([1.0, -1.0]) / 2 if nb == 2 \
        else np.array([1.0, 1.0, -1.0]) / 4
    net = j @ w
    tol = 5e-7 * np.abs(w).sum()
    assert np.abs(hf[:, -1] - j.mean(axis=0)).max() <= 5e-7
    assert abs(tc["conductance"][0] - (net / (0.1 * temp)).mean()) <= \
        tol / (0.1 * temp)
    assert abs(tc["flux"][0] - (net if nb == 2 else -net).mean()) <= tol


def proportional_factors(nc, nmd, device, seed=4):
    """One (nc, nc) complex64 matrix of a random proportional spectrum
    and its float32 std, as ``kernels.noise_synth.Factors``."""
    from sclmd_tpu_torch.kernels.noise_synth import Factors
    from sclmd_tpu_torch.ops.noise import factor_matrix, noise_factors
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(nc, nc)) + 1j * rng.normal(size=(nc, nc))
    psd = (np.abs(rng.normal(size=nmd // 2 + 1)) + 0.1)[:, None, None] * \
        (m @ m.conj().T + nc * np.eye(nc))[None]
    ev, std = noise_factors(psd, dtype=np.float32)
    ev = factor_matrix(ev)
    assert ev.ndim == 2, "the spectrum must be proportional"
    return Factors(torch.as_tensor(ev, device=device),
                   torch.as_tensor(std, device=device))


# --- the physics at CPU sizes -----------------------------------------------
def _chain(outdir, temps, kind, nmd=256, nat=6, nc=3):
    """A harmonic chain of ``nat`` atoms with a bath of ``kind`` on the
    ``nc`` DOFs at each end: memory-kernel phonon baths (ml 24) or
    electron baths."""
    nph = 3 * nat
    r = md(DT, nmd, T, axyz=[["C", 1.4 * i, 0.0, 0.0] for i in range(nat)],
           dyn=chain_dynmat(nph, 0.05).numpy(), seed=5, outdir=outdir, **F64)
    gwl = np.linspace(0.0, 0.6, 16)
    gam = np.array([np.eye(nc) * 0.02 * np.exp(-(w / 0.3) ** 2)
                    for w in gwl])
    for cats, tt in ((range(nc), temps[0]), (range(nph - nc, nph), temps[1])):
        if kind == "electron":
            r.AddBath(TB.ebath(cats, tt, r.dt, nmd, wmax=1.0, nw=200,
                               efric=np.eye(nc) * 0.02, **F64))
        else:
            r.AddBath(TB.phbath(tt, cats, 0.3, 32, r.dt, nmd, ml=24,
                                gamma=gam, gwl=gwl, **F64))
    return r


def _ch_ribbon(outdir, temps):
    """A C/H ribbon (``CHDriver``, 26 atoms, at rest) with electron baths
    on six DOFs at each end."""
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver, terminate_with_h
    from sclmd_tpu_torch.models.tersoff import graphene_ribbon
    axyz = terminate_with_h([["C", *row] for row in graphene_ribbon(4, 1)])
    r = md(DT, 128, T, axyz=axyz, seed=5, outdir=outdir, **F64)
    r.AddPotential(CHDriver(axyz, **F64))
    for cats, tt in ((range(6), temps[0]),
                     (range(r.nph - 6, r.nph), temps[1])):
        r.AddBath(TB.ebath(cats, tt, r.dt, r.nmd, wmax=1.0, nw=200,
                           efric=np.eye(6) * 0.02, **F64))
    return r


def _sheet(outdir, temps):
    """The periodic graphene sheet of ``tools.sheet`` cut to 4 x 2
    (``TersoffDriver``)."""
    return S.sheet_runner(torch.float64, "cpu", outdir, nx=4, ny=2, nmd=128,
                          temps=temps)


def _slab(kind):
    """A slab of ``tools.slab`` cut to 3 x 2 x 2 cells: silicon
    (``SWDriver``) or gold (``EAMDriver``)."""
    def build(outdir, temps):
        return SL.slab_runner(kind, torch.float64, "cpu", outdir,
                              cells=(3, 2, 2), nmd=64, temps=temps)
    return build


# name: (runner of (outdir, temps), trajectories, RunEnsemble options)
SYSTEMS = {
    "chain_blocked": (lambda d, t: _chain(d, t, "phonon"), 128,
                      dict(block=16)),
    "chain_plain": (lambda d, t: _chain(d, t, "phonon"), 128,
                    dict(block=None)),
    "electron": (lambda d, t: _chain(d, t, "electron"), 128, {}),
    "lead_blocks": (lambda d, t: lead_block_chain(
        torch.float64, "cpu", d, t, nmd=256, ml=32), 128, dict(block=64)),
    "ch_ribbon": (_ch_ribbon, 16, {}),
    "tersoff_sheet": (_sheet, 16, {}),
    "sw_slab": (_slab("sw"), 8, {}),
    "eam_slab": (_slab("eam"), 8, {}),
}


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_heat_flows_hot_to_cold(tmp_path, name):
    """``RunEnsemble`` on the same draws with the leads at (hot, cold) and
    at (cold, hot), delta 0.5: in half the difference the left lead gives
    heat and the right takes it, each beyond ``MARGIN`` standard
    errors."""
    build, ntraj, kw = SYSTEMS[name]
    hot, cold = T * (1 + DELTA / 2), T * (1 - DELTA / 2)
    runs = []
    for temps in ((hot, cold), (cold, hot)):
        d = tmp_path / str(len(runs))
        d.mkdir()
        runs.append(build(str(d), temps).RunEnsemble(ntraj, **kw))
    j = (runs[0] - runs[1]) / 2
    assert np.isfinite(j).all()
    z = j.mean(axis=0) / (j.std(axis=0) / np.sqrt(ntraj))
    assert z[0] > MARGIN and z[1] < -MARGIN, z


@pytest.mark.parametrize("bathnum", [2, 3])
def test_kappa_files_read_back_to_the_means(tmp_path, bathnum):
    """``calHF`` and ``calTC(0.1)`` over the kappa files of
    ``RunEnsemble`` (two electron baths at T (1 +- 5 %), and a third at T
    in the middle) read back to the call's means."""
    nph = 18
    r = md(0.5, 64, T, axyz=[["C", 1.4 * i, 0.0, 0.0] for i in range(6)],
           dyn=chain_dynmat(nph, 0.04).numpy(), seed=5,
           outdir=str(tmp_path), **F64)
    for cats, tt in (((0, 1, 2), T * 1.05), ((15, 16, 17), T * 0.95),
                     ((6, 7, 8), T))[:bathnum]:
        r.AddBath(TB.ebath(cats, tt, r.dt, r.nmd, wmax=1.0, nw=200,
                           efric=np.eye(3) * 0.01, **F64))
    means = r.RunEnsemble(6)
    assert len(list(tmp_path.glob("kappa.*"))) == 6 * bathnum
    assert_kappa_files_read_back(str(tmp_path), means, T)


@pytest.mark.parametrize("kind", ["proportional", "batch"])
def test_noise_statistics(kind):
    """The CPU twin's series of 512 trajectories (one (9, 9) matrix, or
    per-frequency factors of width 5; nmd 128): variance and lag-1
    covariance within 5 standard errors of the factors' values."""
    fac = proportional_factors(9, 128, "cpu") if kind == "proportional" \
        else batch_factors(5, 128, "cpu")
    z = noise_z_scores(fac, 0.4, 128, 512, 2026)
    assert all(abs(v) <= 5.0 for v in z.values()), z
