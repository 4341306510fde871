"""GLE MD thermal conductance of a carbon junction (quantum baths).

A C junction driven by a Tersoff bond-order potential (K8 on the card in
float32), two quantum electron-style wideband baths at T(1 +- delta/2),
thermal conductance from the averaged bath heat currents (``calHF``,
``calTC`` over the kappa files of the run).

Run:  python -m sclmd_tpu_torch.examples.runmd [--quick] [--device cpu]
      [--data structure.data] [--ensemble N]
"""

import time

import numpy as np
import torch

from sclmd_tpu_torch import baths as B
from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch.examples import parse_args
from sclmd_tpu_torch.md import md
from sclmd_tpu_torch.models.tersoff import TersoffDriver, graphene_ribbon
from sclmd_tpu_torch.utils.junction import partition_by_axis, relax_for_model
from sclmd_tpu_torch.utils.tools import calHF, calTC


def main(argv=None):
    args = parse_args(argv, __doc__, data=True, ensemble=True)
    device = resolve_device(args.device)

    # --- geometry: armchair graphene ribbon junction, or any LAMMPS data
    # file (e.g. the reference's structure.data) via --data PATH
    if args.data:
        from sclmd_tpu_torch.utils.io import read_lammps_data
        axyz = read_lammps_data(args.data)["axyz"]
        print(f"loaded {len(axyz)} atoms from {args.data}")
    else:
        x = graphene_ribbon(6 if args.quick else 10, 3)
        axyz = [["C", *row] for row in x]
    na = len(axyz)

    # partition along the transport (x) axis with the reference's
    # proportions (20 fixed / 50 lead / 61 device / 50 lead / 20 fixed on
    # the 201-atom structure.data)
    part = partition_by_axis(axyz)
    fixdofs, ecatsl, ecatsr = part["fixdofs"], part["ecatsl"], part["ecatsr"]

    def make_driver(a, dev=device):
        if any(row[0] == "H" for row in a):
            # hydrogen-terminated input: Tersoff backbone + spectroscopic
            # C-H terminators
            from sclmd_tpu_torch.models.hydrocarbon import CHDriver
            return CHDriver(a, dtype=torch.float32, device=dev)
        return TersoffDriver(a, dtype=torch.float32, device=dev)

    if args.data:
        # external structures are minimized for the ORIGINAL potential
        # (structure.data: LAMMPS REBO); relax them for this model first,
        # holding the fixed ends (float64 on the CPU)
        axyz, fmax, nit = relax_for_model(
            axyz, lambda a: make_driver(a, "cpu"), part["fixed_atoms"])
        print(f"relaxed for this potential: fmax={fmax:.2e} eV/Ang "
              f"({nit} relaxation steps)")

    drv = make_driver(axyz)
    print(f"junction: {na} atoms ({sorted(set(a[0] for a in axyz))})")

    # --- MD setup --------------------------------------------------------
    T = 300.0
    delta = 0.1
    nstart, nstop = 0, 2 if args.quick else 3
    dt = 0.25 / 0.658               # 0.25 fs in natural time units
    nmd = 2 ** (10 if args.quick else 12)

    runner = md(dt, nmd, T, axyz=axyz, dyn=np.asarray(drv.dynmat()),
                nstart=nstart, nstop=nstop, dtype=torch.float32,
                device=device)
    runner.AddPotential(drv)

    damp = 100 / 0.658211814201041
    for cats, tt in ((ecatsl, T * (1 + delta / 2)),
                     (ecatsr, T * (1 - delta / 2))):
        eta = (1.0 / damp) * np.identity(len(cats))
        runner.AddBath(B.ebath(cats, tt, runner.dt, runner.nmd, wmax=1.0,
                               nw=500, bias=0.0, efric=eta,
                               device=device))
    runner.AddConstr([fixdofs])

    t0 = time.time()
    if args.ensemble:
        # N independent trajectories, chunked on the card
        runner.RunEnsemble(args.ensemble)
        nsteps_total = args.ensemble * nmd
    else:
        runner.Run()
        nsteps_total = (nstop - nstart) * nmd
    wall = time.time() - t0
    print("MD wall time: %.1f s (%.0f traj-steps/s)"
          % (wall, nsteps_total / wall))

    calHF()
    result = calTC(delta=delta, dlist=0)
    print(open(f"thermalconductance.{int(T)}.dat").read())
    return result


if __name__ == "__main__":
    main()
