"""Biased NEGF: phonon heating under current (bias self-energy).

Ballistic transport with an extra bias self-energy block on the center
atoms (chi+- matrices), comparing equilibrium and biased power spectra.

Run:  python -m sclmd_tpu_torch.examples.current_induced.runnegf
      [--device cpu]
"""

import numpy as np

from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.examples import parse_args
from sclmd_tpu_torch.models.harmonic import chain_dynmat
from sclmd_tpu_torch.negf import bpt


def main(argv=None):
    args = parse_args(argv, __doc__)
    n = 30
    d_ev2 = np.asarray(chain_dynmat(n, 0.04))
    d_ps2 = d_ev2 / U.RPC ** 2

    bathL, bathR = list(range(0, 6)), list(range(n - 6, n))
    center = list(range(12, 18))

    b = bpt(d_ps2, 0.5, 0.1, [bathL, bathR], num=400, write_files=True,
            device=args.device)
    b.gettm()
    kappa = b.thermalconductance(300.0, 0.1)
    print("ballistic conductance at 300 K: %.4e nW/K" % kappa)

    ps_eq = b.getps(300.0, 0.5, 200)

    nb = len(center)
    b.setbias(0.6, bdamp=np.eye(nb) * 0.05,
              chiplus=np.eye(nb) * 0.02, chiminus=np.zeros((nb, nb)),
              dofatomofbias=center)
    ps_bias = b.getps(300.0, 0.5, 200, atomlist=center,
                      filename="biascenter")
    print("power spectrum integral: equilibrium %.3e, biased-center %.3e"
          % (np.trapezoid(ps_eq[:, 1], ps_eq[:, 0]),
             np.trapezoid(ps_bias[:, 1], ps_bias[:, 0])))
    return {"kappa": kappa, "ps_eq": ps_eq, "ps_bias": ps_bias}


if __name__ == "__main__":
    main()
