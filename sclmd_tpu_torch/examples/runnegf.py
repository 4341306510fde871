"""NEGF ballistic phonon transmission + Landauer thermal conductance.

The junction's dynamical matrix (the Hessian of the Tersoff potential,
float64 on the CPU), the batched Caroli transmission (complex128 on the
card), thermal conductance over a temperature sweep. Cross-validates
``examples.runmd``.

Run:  python -m sclmd_tpu_torch.examples.runnegf [--device cpu]
      [--data structure.data]
"""

import time

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.examples import parse_args
from sclmd_tpu_torch.models.tersoff import TersoffDriver, graphene_ribbon
from sclmd_tpu_torch.negf import bpt


def main(argv=None):
    args = parse_args(argv, __doc__, data=True)
    device = resolve_device(args.device)
    t0 = time.time()
    if args.data:
        # any LAMMPS data file, e.g. the reference's structure.data
        from sclmd_tpu_torch.utils.io import read_lammps_data
        from sclmd_tpu_torch.utils.junction import (partition_by_axis,
                                                    relax_for_model)

        axyz = read_lammps_data(args.data)["axyz"]
        part = partition_by_axis(axyz)

        def make_driver(a):
            if any(row[0] == "H" for row in a):
                from sclmd_tpu_torch.models.hydrocarbon import CHDriver
                return CHDriver(a, device="cpu")
            return TersoffDriver(a, dtype=torch.float64, device="cpu")

        axyz, fmax, _ = relax_for_model(axyz, make_driver,
                                        part["fixed_atoms"])
        print(f"relaxed for this potential: fmax={fmax:.2e} eV/Ang")
        drv = make_driver(axyz)
        fix = part["fixdofs"]
        atomfixed = [fix[:len(fix) // 2], fix[len(fix) // 2:]]
        atomofbath = [part["ecatsl"], part["ecatsr"]]
    else:
        x = graphene_ribbon(6, 3)
        axyz = [["C", *row] for row in x]
        drv = TersoffDriver(axyz, dtype=torch.float64, device="cpu")
        na3 = 3 * len(axyz)
        atomfixed = [list(range(0, 6)), list(range(na3 - 6, na3))]
        nlead = 3 * (len(axyz) // 4)
        atomofbath = [list(range(6, 6 + nlead)),
                      list(range(na3 - 6 - nlead, na3 - 6))]
    na = drv.number
    dynmat_ev2 = np.asarray(drv.dynmat())       # eV^2 (natural units)
    dynmat_ps2 = dynmat_ev2 / U.RPC ** 2        # eskm ps^-2 convention
    print("dynamical matrix (%d DOF) in %.1f s" % (3 * na, time.time() - t0))

    mybpt = bpt(dynmat_ps2, 0.25, 0.1, atomofbath, atomfixed, num=500,
                write_files=True, device=device)
    t0 = time.time()
    mybpt.gettm()
    print("transmission sweep (%d points) in %.2f s"
          % (mybpt.intnum + 1, time.time() - t0))

    delta = 0.1
    kappas = {}
    for temp in (100, 300, 500, 700, 1000):
        kappas[temp] = mybpt.thermalconductance(temp, delta)
        print("T=%4d K  conductance %.4e nW/K" % (temp, kappas[temp]))

    ps = mybpt.getps(300.0, 0.25, 200)
    print("power spectrum: %d points, max %.3e" % (len(ps), ps[:, 1].max()))
    return {"dynmat_ps2": dynmat_ps2, "atomofbath": atomofbath,
            "atomfixed": atomfixed, "tm": mybpt.tmnumber, "kappa": kappas,
            "ps": ps}


if __name__ == "__main__":
    main()
