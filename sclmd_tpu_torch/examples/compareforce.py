"""Force-consistency harness: anharmonic minus harmonic force statistics.

Records driver.force(q) + D q each MD step (the deviation of the real
potential from its harmonic expansion), dumps deltaforce.runJ.npy, and
analyses the running mean/deviation with ``avdf``.

Run:  python -m sclmd_tpu_torch.examples.compareforce [--device cpu]
"""

import numpy as np
import torch

from sclmd_tpu_torch import baths as B
from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch.examples import parse_args
from sclmd_tpu_torch.md import md
from sclmd_tpu_torch.models.tersoff import TersoffDriver, graphene_ribbon
from sclmd_tpu_torch.utils.tools import avdf


def main(argv=None):
    args = parse_args(argv, __doc__)
    device = resolve_device(args.device)
    x = graphene_ribbon(4, 2)
    axyz = [["C", *row] for row in x]
    drv = TersoffDriver(axyz, dtype=torch.float32, device=device)
    na = drv.number

    dt, nmd, T = 0.25 / 0.658, 2 ** 10, 300.0
    runner = md(dt, nmd, T, axyz=axyz, dyn=np.asarray(drv.dynmat()),
                nstop=2, dtype=torch.float32, device=device)
    runner.AddPotential(drv)

    nlead = 3 * (na // 3)
    eta = np.eye(nlead) * (0.658 / 100)
    runner.AddBath(B.ebath(range(nlead), T, dt, nmd, wmax=1.0, efric=eta,
                           device=device))
    runner.CompareForce(drv)
    runner.Run()

    avdf(["deltaforce.run0.npy", "deltaforce.run1.npy"])
    dev = np.loadtxt("deltaforce-deviation1.dat")
    print("anharmonic force deviation: mean %.3e max %.3e" %
          (dev.mean(), dev.max()))
    return {"deviation": dev}


if __name__ == "__main__":
    main()
