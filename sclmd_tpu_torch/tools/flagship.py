"""The flagship junction of the JAX package's bench.py: the 201-atom
C/H junction of the committed ``scripts/flagship_negf.npz`` (the relaxed
geometry ``els``/``pos`` and its 603 x 603 dynamical matrix ``dyn_ev2``),
two electron baths on the 150 lead DOFs of each side with friction
I / (100 fs) at T (1 +- delta/2), T 300 K, delta 0.1, wmax 1.0, nw 500,
the 120 DOFs of the outer atoms fixed, dt 0.25/0.658, nmd 1024.

Two forms: the harmonic one (``_flagship_build``, bench.py:441-461),
whose force is ``-dyn q`` from ``dyn_ev2``; and the many-body one
(``flagship``, bench.py:370-431; ``many_body=True``), whose force is the
C/H driver's (``CHDriver`` on the npz geometry, which the bench reaches
by relaxing ``structure.data``; kernel K5 on the card), with ``dyn_ev2``
kept for the thermal start.

The current-induced form (``biased_flagship_runner``) adds
examples/current_induced/rundp.py's biased electron bath on the centre:
the 183 DOFs neither fixed nor in a lead, at T 300 K and bias 0.5 eV,
with the wideband matrices ``write_centre_bath`` writes, read back from
the wbLambda file.
"""

import os

import numpy as np

NMD, T, DELTA = 1024, 300.0, 0.1
# the NEGF sweep of scripts/exp_crosscheck_flagship.py that made the npz:
# up to 0.45 eV (above the C-H stretch band), wideband leads of 0.1 ps,
# 4,000 intervals
MAXOMEGA_EV, DAMP_PS, NUM = 0.45, 0.1, 4000
DT = 0.25 / 0.658
DAMP = 100 / 0.658211814201041          # 100 fs in natural time units
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scripts", "flagship_negf.npz")


def flagship_junction():
    """(axyz, partition, dyn) of the flagship junction (host numpy)."""
    from sclmd_tpu_torch.utils.junction import partition_by_axis

    negf = np.load(NPZ)
    axyz = [[str(e)] + list(map(float, p))
            for e, p in zip(negf["els"], negf["pos"])]
    return axyz, partition_by_axis(axyz), np.asarray(negf["dyn_ev2"])


def flagship_runner(dtype, device, outdir, nmd: int = NMD, seed: int = 11,
                    temps=(T * (1 + DELTA / 2), T * (1 - DELTA / 2)),
                    many_body: bool = False):
    """An ``md.md`` runner of the flagship junction writing to ``outdir``,
    with its left and right leads at ``temps``; ``many_body`` attaches
    the C/H force driver."""
    from sclmd_tpu_torch import baths as B
    from sclmd_tpu_torch.md import md

    axyz, part, dyn = flagship_junction()
    r = md(DT, nmd, T, axyz=axyz, dyn=dyn, dtype=dtype, seed=seed,
           outdir=outdir, device=device)
    if many_body:
        from sclmd_tpu_torch.models.hydrocarbon import CHDriver
        r.AddPotential(CHDriver(axyz, dtype=dtype, device=device))
    for cats, tt in zip((part["ecatsl"], part["ecatsr"]), temps):
        eta = (1.0 / DAMP) * np.identity(len(cats))
        r.AddBath(B.ebath(cats, tt, r.dt, r.nmd, wmax=1.0, nw=500,
                          efric=eta, dtype=dtype, device=device))
    r.AddConstr([part["fixdofs"]])
    return r


BIAS, BIAS_T = 0.5, 300.0
LAMBDA_NE, LAMBDA_EMAX, LAMBDA_NEL = 2048, 4.0, 96


def centre_dofs(part) -> list:
    """The DOFs of the device atoms of ``partition_by_axis``: neither
    fixed nor in a lead (183 on the flagship: 603 - 120 - 2 x 150)."""
    return sorted(int(d) for i in part["device"]
                  for d in range(3 * i, 3 * i + 3))


def centre_bath_raw(device, nm: int, n_el: int = LAMBDA_NEL,
                    ne: int = LAMBDA_NE) -> dict:
    """The centre bath's wideband matrices as the pipeline gives them:
    ``LambdaPipeline.wideband`` (rundp's hwcut, mu0 0) of rundp's model
    electronic structure with ``n_el`` orbitals and ``nm`` modes, the
    DOFs themselves, on ``fft_order_grid(4.0, ne)``, run on ``device``."""
    from sclmd_tpu_torch.examples.current_induced.rundp import HWCUT, model
    from sclmd_tpu_torch.postprocess.lambda_pipeline import LambdaPipeline

    pl = LambdaPipeline(*model(n_el=n_el, nm=nm, ne=ne, emax=LAMBDA_EMAX),
                        device=device)
    return pl.wideband(hwcut=HWCUT, mu0=0.0)


def write_centre_bath(path, device, nm: int, n_el: int = LAMBDA_NEL,
                      ne: int = LAMBDA_NE) -> dict:
    """``centre_bath_raw`` scaled and shifted, written as a wbLambda
    bundle at ``path`` (``WritewbLambda``) and returned.

    rundp's coupling amplitude was set for 10 orbitals and 12 modes; at
    96 and 183 the friction's largest eigenvalue is ~550 eV (eta dt ~ 200
    at the flagship's step, where the explicit step needs well under 2),
    and with zeta1 at bias 0.5 the flagship gains a growing mode
    (``tools.bias_stability``). So all five matrices are scaled by one
    factor (the coupling by its square root) that puts eta's largest
    eigenvalue at the leads' friction 1/(100 fs); then eta is shifted as
    rundp shifts it. Returns the five matrices (``eta`` shifted),
    ``scale`` and ``eta_raw_max``."""
    from sclmd_tpu_torch.examples.current_induced.rundp import (
        shifted_friction)
    from sclmd_tpu_torch.utils.io import WritewbLambda

    wb = centre_bath_raw(device, nm, n_el=n_el, ne=ne)
    raw = float(np.abs(np.linalg.eigvalsh(wb["eta"])).max())
    scale = (1.0 / DAMP) / raw
    out = {k: scale * wb[k] for k in ("eta", "xim", "xip", "zeta1", "zeta2")}
    out["eta"] = shifted_friction(out["eta"])
    WritewbLambda(path, out["eta"], out["xim"], out["xip"], out["zeta1"],
                  out["zeta2"])
    out.update(scale=scale, eta_raw_max=raw)
    return out


def biased_flagship_runner(dtype, device, outdir, wb_file, nmd: int = NMD,
                           seed: int = 11,
                           temps=(T * (1 + DELTA / 2), T * (1 - DELTA / 2))):
    """``flagship_runner`` with a third electron bath on the centre DOFs:
    T 300 K, bias 0.5, its efric, exim, exip, zeta1 and zeta2 read from
    the wbLambda file ``wb_file`` (``ReadwbLambda``). The bias makes its
    spectrum non-proportional, so its noise factors are per frequency
    (K3's per-frequency route) and K7 applies the wind, renormalisation
    and Berry terms."""
    from sclmd_tpu_torch import baths as B
    from sclmd_tpu_torch.utils.io import ReadwbLambda

    r = flagship_runner(dtype, device, outdir, nmd=nmd, seed=seed,
                        temps=temps)
    _, part, _ = flagship_junction()
    _, eta, xim, xip, z1, z2 = ReadwbLambda(wb_file)
    r.AddBath(B.ebath(centre_dofs(part), BIAS_T, r.dt, r.nmd, wmax=1.0,
                      nw=500, bias=BIAS, efric=eta, exim=xim, exip=xip,
                      zeta1=z1, zeta2=z2, dtype=dtype, device=device))
    return r


def flagship_bpt(device):
    """``negf.bpt`` of the flagship junction on ``device``, as the JAX
    package's script made the committed sweep: ``dyn_ev2`` in ps^-2, the
    120 fixed DOFs split in two halves, the lead DOFs of each side as the
    two wideband baths (nd 483, 150 DOFs a lead, 4,001 points)."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.negf import bpt

    _, part, dyn = flagship_junction()
    fix = part["fixdofs"]
    return bpt(dyn / units.RPC ** 2, MAXOMEGA_EV, DAMP_PS,
               [part["ecatsl"], part["ecatsr"]],
               [fix[:len(fix) // 2], fix[len(fix) // 2:]], num=NUM,
               device=device)
