"""GLE MD thermal conductance of a copper nanowire junction (EAM).

An fcc Cu rod driven by the analytic Sutton-Chen EAM potential (K10 on
the card in float32), two quantum Debye phonon baths at T(1 +- delta/2),
thermal conductance from the averaged bath heat currents, cross-checked
against the NEGF Landauer answer on the same junction.

Run:  python -m sclmd_tpu_torch.examples.runeam [--quick] [--device cpu]
"""

import time

import numpy as np
import torch

from sclmd_tpu_torch import baths as B
from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.examples import parse_args
from sclmd_tpu_torch.md import md
from sclmd_tpu_torch.models.eam import EAMDriver, SUTTON_CHEN_PARAMS, fcc_cell
from sclmd_tpu_torch.models.relax import fire_relax
from sclmd_tpu_torch.negf import bpt
from sclmd_tpu_torch.utils.tools import calHF, calTC


def main(argv=None):
    args = parse_args(argv, __doc__)
    device = resolve_device(args.device)

    # --- geometry: finite fcc Cu rod (leads at the +-z ends) -------------
    a0 = SUTTON_CHEN_PARAMS["Cu"]["a"]
    nz = 4 if args.quick else 8
    pos, _ = fcc_cell(2, 2, nz, a0)
    axyz = [["Cu"] + list(p) for p in pos]

    # relax the free rod first (FIRE on the same energy, float64 on the
    # CPU)
    pre = EAMDriver(axyz, rcut=0.9 * a0, cutoff_skin=0.6, device="cpu")
    pos, fmax, nit = fire_relax(pre.energy_fn, pos, tol=2e-4)
    print(f"relaxed: fmax={fmax:.1e} eV/Ang in {nit} FIRE steps")
    axyz = [["Cu"] + list(p) for p in pos]
    drv = EAMDriver(axyz, rcut=0.9 * a0, dtype=torch.float32,
                    device=device)   # first-shell cutoff: finite rod
    na = drv.number
    print(f"junction: {na} atoms, Sutton-Chen Cu")

    # --- MD setup ----------------------------------------------------------
    T = 100.0
    delta = 0.2
    nstart, nstop = 0, 2 if args.quick else 3
    dt = 0.5 / 0.658                 # 0.5 fs in natural time units
    nmd = 2 ** (10 if args.quick else 12)

    z = pos[:, 2]
    zl, zr = np.quantile(z, 0.25), np.quantile(z, 0.75)
    atl = np.nonzero(z < zl)[0]
    atr = np.nonzero(z > zr)[0]
    catsl = sorted(int(d) for i in atl for d in range(3 * i, 3 * i + 3))
    catsr = sorted(int(d) for i in atr for d in range(3 * i, 3 * i + 3))

    runner = md(dt, nmd, T, axyz=axyz, dyn=np.asarray(drv.dynmat()),
                nstart=nstart, nstop=nstop, dtype=torch.float32,
                device=device)
    runner.AddPotential(drv)

    debye = 0.030                    # Cu Debye energy ~ k_B * 343 K (eV)
    ml = 64
    for tt, cats in ((T * (1 + delta / 2), catsl),
                     (T * (1 - delta / 2), catsr)):
        runner.AddBath(B.phbath(tt, cats, debye, 200, runner.dt,
                                runner.nmd, ml=ml, device=device))

    t0 = time.time()
    runner.Run()
    print("MD wall time: %.1f s (%.0f steps/s)"
          % (time.time() - t0, (nstop - nstart) * nmd / (time.time() - t0)))

    calHF()
    result = calTC(delta=delta, dlist=0)
    print(open(f"thermalconductance.{int(T)}.dat").read())

    # --- NEGF cross-check on the same junction ----------------------------
    # matched lead model: the Markovian Debye friction gamma = w_D pi/6
    # (eV) corresponds to a wideband Sigma^r = -i w gamma, i.e. damping
    # time damp = hbar / gamma in ps (bpt's damp parameter).
    damp = U.RPC / (debye * np.pi / 6.0)
    b = bpt(drv, 0.05, damp, [catsl, catsr], num=60 if args.quick else 200,
            device=device)
    b.gettm()
    kappa = b.thermalconductance(T, delta)
    print(f"NEGF Landauer conductance at T={T}: {kappa:.4e}")
    result["negf"] = kappa
    return result


if __name__ == "__main__":
    main()
