"""Growth rates of the flagship's linear GLE with a biased centre bath.

The deterministic part of the harmonic flagship's equation of motion on
its free DOFs, with the leads' friction I/(100 fs) and the centre bath's
friction eta, wind and renormalisation bias (xim - zeta1) and Berry
bias zeta2, is the companion system d/dt (q, v) = [[0, I], [K, -G]];
the largest real part of its eigenvalues (natural units, 1/time) says
whether a run grows without bound. Printed for the flagship without the
centre bath, with rundp's matrices as the pipeline gives them (rundp's
shift applied), and with the scaled matrices that
``flagship.biased_flagship_runner`` runs, beside eta's largest
eigenvalue times the step. Host numpy float64 on the CPU (the pipeline
at 96 orbitals and three 966-wide eigenvalue problems): a few CPU
minutes.

Run:  python -m sclmd_tpu_torch.tools.bias_stability
"""

import json

import numpy as np


def growth_rate(dyn, part, centre=None, bias: float = 0.0):
    """Largest real part of the companion matrix's eigenvalues on the
    free DOFs; ``centre`` the centre bath's matrices (eta, xim, zeta1,
    zeta2) on ``tools.flagship.centre_dofs(part)`` or None."""
    from sclmd_tpu_torch.tools import flagship as F

    n = len(dyn)
    K, G = -np.array(dyn, float), np.zeros((n, n))
    for cats in (part["ecatsl"], part["ecatsr"]):
        G[np.ix_(cats, cats)] += np.eye(len(cats)) / F.DAMP
    if centre is not None:
        ix = np.ix_(*[F.centre_dofs(part)] * 2)
        eta, xim, z1, z2 = centre
        G[ix] += (eta + eta.T) / 2 + bias * (z2 - z2.T) / 2
        K[ix] += bias * ((xim - xim.T) / 2 - (z1 + z1.T) / 2)
    free = np.setdiff1d(np.arange(n), part["fixdofs"])
    m = len(free)
    A = np.zeros((2 * m, 2 * m))
    A[:m, m:] = np.eye(m)
    A[m:, :m] = K[np.ix_(free, free)]
    A[m:, m:] = -G[np.ix_(free, free)]
    return float(np.linalg.eigvals(A).real.max())


def main():
    from sclmd_tpu_torch.examples.current_induced.rundp import (
        shifted_friction)
    from sclmd_tpu_torch.tools import flagship as F

    _, part, dyn = F.flagship_junction()
    nm = len(F.centre_dofs(part))
    wb = F.centre_bath_raw("cpu", nm)
    raw = float(np.abs(np.linalg.eigvalsh(wb["eta"])).max())
    scale = (1.0 / F.DAMP) / raw
    out = {"eta_raw_max": raw, "scale": scale, "dt": F.DT}
    for name, s in (("raw", 1.0), ("scaled", scale)):
        eta = shifted_friction(s * wb["eta"])
        out[name] = {
            "eta_max_dt": float(np.linalg.eigvalsh(eta).max() * F.DT),
            "growth": growth_rate(dyn, part, (eta, s * wb["xim"],
                                              s * wb["zeta1"],
                                              s * wb["zeta2"]), F.BIAS)}
    out["bare"] = {"growth": growth_rate(dyn, part)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
