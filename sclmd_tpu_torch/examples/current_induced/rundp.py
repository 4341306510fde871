"""Current-induced-force MD: biased center bath with wind forces.

The biased junction carries three baths: two equilibrium leads plus a
biased electron bath on the center whose eta/xim/xip matrices come from
the Lambda pipeline, which runs first on a model electronic structure
(on the card) and writes the wbLambda bundle that the MD stage reads.

Run:  python -m sclmd_tpu_torch.examples.current_induced.rundp
      [--quick] [--device cpu]
"""

import numpy as np
import torch

from sclmd_tpu_torch import baths as B
from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch.examples import parse_args
from sclmd_tpu_torch.md import md
from sclmd_tpu_torch.models.harmonic import chain_dynmat
from sclmd_tpu_torch.postprocess.lambda_pipeline import (LambdaPipeline,
                                                         fft_order_grid)
from sclmd_tpu_torch.utils.io import ReadwbLambda, WritewbLambda
from sclmd_tpu_torch.utils.tools import calHF

HWCUT = 0.05


def model(n_el=10, nm=12, ne=256, emax=4.0, seed=42):
    """The model device electronic structure (H, S, E, SigL, SigR, M, hw):
    ``n_el`` orbitals of a random Hamiltonian, wideband leads on the first
    and last two orbitals with a smooth band edge, ``nm`` random symmetric
    e-ph couplings and mode energies, on ``fft_order_grid(emax, ne)``."""
    rng = np.random.default_rng(seed)
    E = fft_order_grid(emax, ne)
    h = rng.normal(size=(n_el, n_el))
    H = 0.4 * (h + h.T) / 2 + 0j
    S = np.eye(n_el, dtype=complex)
    gl = np.zeros((n_el, n_el))
    gl[:2, :2] = np.eye(2) * 0.8
    gr = np.zeros((n_el, n_el))
    gr[-2:, -2:] = np.eye(2) * 0.8
    band = 1.0 / (1.0 + (E / 2.8) ** 6)
    SigL = -0.5j * band[:, None, None] * gl[None]
    SigR = -0.5j * band[:, None, None] * gr[None]
    m = rng.normal(size=(nm, n_el, n_el)) * 0.08
    M = np.array([(mi + mi.T) / 2 for mi in m], dtype=complex)
    hw = np.sort(rng.random(nm) * 0.15 + 0.02)
    return H, S, E, SigL, SigR, M, hw


def shifted_friction(eta):
    """eta made positive definite and strong enough to damp the bias wind
    forces (current-induced instabilities are physical — runaway modes
    at high bias; the example stays in the stable regime)."""
    return eta + np.eye(len(eta)) * (abs(np.linalg.eigvalsh(eta)).max()
                                     + 2e-3)


def main(argv=None):
    args = parse_args(argv, __doc__)
    device = resolve_device(args.device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32

    # --- stage 1: Lambda pipeline on a model device electronic structure
    ncenter = 4                       # center atoms coupled to electrons
    nm = 3 * ncenter                  # phonon DOFs on the center
    pl = LambdaPipeline(*model(n_el=10, nm=nm, ne=256), device=device)
    wb = pl.wideband(hwcut=HWCUT, mu0=0.0)
    WritewbLambda("wbLambda.npz", wb["eta"], wb["xim"], wb["xip"],
                  wb["zeta1"], wb["zeta2"])
    _, eta_c, xim_c, xip_c, z1_c, z2_c = ReadwbLambda("wbLambda.npz")
    print("wideband matrices: |eta|max %.3e |xim|max %.3e"
          % (np.abs(eta_c).max(), np.abs(xim_c).max()))

    # --- stage 2: GLE MD with the biased center bath ----------------------
    na = 24
    nph = 3 * na
    dyn = np.asarray(chain_dynmat(nph, 0.04))
    axyz = [["C", 1.4 * i, 0.0, 0.0] for i in range(na)]
    T, bias = 300.0, 0.5
    dt, nmd = 0.5 / 0.658, 2 ** (9 if args.quick else 11)

    runner = md(dt, nmd, T, axyz=axyz, dyn=dyn,
                nstop=1 if args.quick else 2, dtype=dtype, device=device)
    damp = 100 / 0.658211814201041
    nlead = 18
    etal = (1.0 / damp) * np.identity(nlead)
    for cats in (range(nlead), range(nph - nlead, nph)):
        runner.AddBath(B.ebath(cats, T, dt, nmd, wmax=2.0, nw=1000,
                               efric=etal, zpmotion=False, dtype=dtype,
                               device=device))
    # biased center bath with current-induced wind forces
    center = list(range(nph // 2 - nm // 2, nph // 2 + nm - nm // 2))
    runner.AddBath(B.ebath(center, T, dt, nmd, wmax=2.0, nw=1000,
                           bias=bias, efric=shifted_friction(eta_c),
                           exim=xim_c, exip=xip_c, zpmotion=False,
                           dtype=dtype, device=device))
    runner.noranvel()
    runner.Run()

    balance = calHF(dlist=0 if args.quick else 1, bathnum=3)
    print("heat flux per bath written; bias wind force active on",
          len(center), "center DOFs")
    return {"wideband": wb, "heatflux": balance}


if __name__ == "__main__":
    main()
