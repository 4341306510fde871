"""Lead self-energy by decimation surface Green's functions.

Extract principal-layer blocks from a lead's dynamical matrix (float64 on
the CPU), run the batched decimation sweep (complex128 on the card),
write DOS and transmission.

Run:  python -m sclmd_tpu_torch.examples.runsig [--device cpu]
"""

import time

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.examples import parse_args
from sclmd_tpu_torch.models.tersoff import TersoffDriver, graphene_ribbon
from sclmd_tpu_torch.selfenergy import sig


def main(argv=None):
    args = parse_args(argv, __doc__)
    device = resolve_device(args.device)
    t0 = time.time()
    # periodic-ish carbon strip as the lead material
    x = graphene_ribbon(8, 2)
    axyz = [["C", *row] for row in x]
    drv = TersoffDriver(axyz, dtype=torch.float64, device="cpu")
    na = drv.number
    d_ps2 = np.asarray(drv.dynmat()) / U.RPC ** 2

    # two successive principal layers in the middle of the strip
    lay = 3 * (na // 4)
    g0 = list(range(lay, lay + 3 * 4))
    g1 = list(range(lay + 3 * 4, lay + 3 * 8))

    mode = sig(d_ps2, 0.12, g0, g1, num=400, eta=0.164e-3,
               write_files=True, device=device)
    mode.getse("L")
    mode.getse("R")
    mode.gettm()
    print("self-energy + transmission sweeps in %.1f s" % (time.time() - t0))
    print("DOS peak: %.3e at %.4f eV"
          % (mode.dos[:, 1].max(),
             mode.dos[np.argmax(mode.dos[:, 1]), 0] * U.RPC))
    return {"dynmat_ps2": d_ps2, "g0": g0, "g1": g1, "dos": mode.dos,
            "tm": mode.tmnumber}


if __name__ == "__main__":
    main()
