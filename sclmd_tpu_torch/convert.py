"""Build the port's objects from the JAX package's pytrees and drivers.

Reads a ``sclmd_tpu`` bath, ``GLESystem`` or force driver through
``np.asarray`` on its attributes (a driver's parameters through the
closure of its energy function), so this module needs no jax import; the
tests use it to make both packages compute the same thing.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch.baths import EBath, PhBath, _contig_start
from sclmd_tpu_torch.md import GLESystem


def _tensor(x, device, dtype=None):
    return None if x is None else torch.as_tensor(
        np.array(np.asarray(x)), dtype=dtype, device=device)


def _factor(x):
    return None if x is None else np.asarray(x)


def from_jax_bath(b, device=None):
    """A ``sclmd_tpu.baths`` ``EBath`` or ``PhBath`` as the port's (the
    hot-loop matrices and the noise keep their dtype and shape; setup
    data become host numpy), on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    kind = type(b).__name__
    if kind not in ("EBath", "PhBath"):
        raise TypeError(f"from_jax_bath: unknown bath type {kind}")
    cids = np.asarray(b.cids).astype(np.int64)
    if kind == "EBath":
        return EBath(
            cids=cids, cs=_contig_start(cids),
            **{k: _tensor(getattr(b, k), device)
               for k in ("efric", "exim", "exip", "zeta1", "zeta2")},
            T=float(np.asarray(b.T)), bias=float(np.asarray(b.bias)),
            noise=_tensor(b.noise, device), dt=float(b.dt), nmd=int(b.nmd),
            wmax=None if b.wmax is None else float(b.wmax),
            nw=None if b.nw is None else int(b.nw),
            classical=bool(b.classical), zpmotion=bool(b.zpmotion),
            bias_terms=bool(b.bias_terms),
            nevecs=_factor(b.nevecs), nstd=_factor(b.nstd))
    return PhBath(
        cids=cids, cs=_contig_start(cids), T=float(np.asarray(b.T)),
        gamma=np.asarray(b.gamma, np.float64),
        gwl=np.asarray(b.gwl, np.float64),
        kernel=_tensor(b.kernel, device),
        noise=_tensor(b.noise, device),
        dt=float(b.dt), nmd=int(b.nmd), ml=int(b.ml), nw=int(b.nw),
        wmax=float(b.wmax), local=bool(b.local), eta_ad=float(b.eta_ad),
        classical=bool(b.classical), zpmotion=bool(b.zpmotion),
        nevecs=_factor(b.nevecs), nstd=_factor(b.nstd),
        mode=str(b.mode))


def from_jax_system(system, device=None, driver=None,
                    cf_driver=None) -> GLESystem:
    """A ``sclmd_tpu.md.GLESystem`` (electron, local and memory-kernel
    phonon baths) as the port's ``GLESystem`` on ``device`` (default: the
    CUDA card). A JAX ``force_fn`` or ``cf_fn`` is a traced function and
    cannot be read: pass the port's driver for it (``from_jax_driver``) as
    ``driver`` / ``cf_driver``."""
    device = resolve_device(device)
    if (system.force_fn is not None and driver is None) or \
            (system.cf_fn is not None and cf_driver is None):
        raise ValueError(
            "from_jax_system: the system has a force driver; pass the "
            "port's counterpart as driver= / cf_driver=")
    if getattr(system, "force_params", None) is not None:
        raise NotImplementedError(
            "from_jax_system: traced force_params are not ported "
            "(ROADMAP queue 1 item 6)")
    return GLESystem(
        force_fn=None if driver is None else driver.force_torch,
        cf_fn=None if cf_driver is None else cf_driver.force_torch,
        dyn=_tensor(system.dyn, device),
        baths=tuple(from_jax_bath(b, device) for b in system.baths),
        mask=_tensor(system.mask, device),
        dt=float(system.dt), nph=int(system.nph), ml=int(system.ml),
        nmd=int(system.nmd), unconstrained=bool(system.unconstrained),
        savep=bool(system.savep), saveq=bool(system.saveq),
        savef=bool(system.savef))


def _closure(fn) -> dict:
    return dict(inspect.getclosurevars(fn).nonlocals)


def _cell_of(c: dict):
    return None if c.get("cell_j") is None else np.array(c["cell_j"], float)


def from_jax_driver(drv, device=None, dtype=None, **overrides):
    """A ``sclmd_tpu`` force driver (``HarmonicDriver``, ``PairDriver``,
    ``TersoffDriver``, ``CHDriver``, ``SWDriver``, ``EAMDriver``) as the
    port's, on ``device`` (default: the CUDA card), in the JAX driver's
    dtype unless ``dtype`` is given.

    The JAX drivers keep their parameters only inside their energy
    function, so they are read from its closure: the cell, the width of
    the neighbour table, the parameter sets; an EAM driver's setfl table
    is its ``table``. What the closure does not hold (the table's skin, a
    multi-element parameter table) takes the constructor's default unless
    passed in ``overrides``; the rebuilt neighbour table or pair list is
    held against the JAX driver's, and a mismatch raises."""
    from sclmd_tpu_torch.models.eam import EAMDriver
    from sclmd_tpu_torch.models.harmonic import HarmonicDriver
    from sclmd_tpu_torch.models.hydrocarbon import CHDriver
    from sclmd_tpu_torch.models.pair import PairDriver
    from sclmd_tpu_torch.models.sw import SWDriver
    from sclmd_tpu_torch.models.tersoff import TersoffDriver

    device = resolve_device(device)
    kind = type(drv).__name__
    if kind not in ("HarmonicDriver", "PairDriver", "TersoffDriver",
                    "CHDriver", "SWDriver", "EAMDriver"):
        raise TypeError(f"from_jax_driver: unknown driver type {kind}")
    jdt = drv.dyn.dtype if kind == "HarmonicDriver" else drv._drv.dtype
    dtype = dtype or getattr(torch, np.dtype(jdt).name)
    axyz = None if drv.axyz is None else \
        [[a[0]] + [float(v) for v in a[1:]] for a in drv.axyz]
    if kind == "HarmonicDriver":
        return HarmonicDriver(np.asarray(drv.dyn, np.float64), axyz=axyz,
                              md2ang=drv.md2ang, dtype=dtype, device=device)

    def same_table(ours, theirs, what):
        if any(np.shape(a) != np.shape(b) or
               not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(ours, theirs)):
            raise ValueError(
                f"from_jax_driver: the rebuilt {what} differs from the JAX "
                "driver's; pass the skin it was built with")

    c = _closure(drv.energy_fn)
    if kind == "CHDriver":
        ec = _closure(c["e_c"])
        kw = dict(cell=_cell_of(ec), max_nnei=int(np.shape(ec["nbr"])[1]),
                  tersoff_params={"C": dict(ec["p"])})
        if c["e_ch"] is not None:
            m = _closure(c["e_ch"])
            kw["morse"] = dict(D=float(m["D"]), alpha=float(m["alpha"]),
                               r0=float(m["r0"]),
                               cutoff=float(m["cutoff"]) - 1.0)
        if c["e_bend"] is not None:
            kw["k_bend"] = float(_closure(c["e_bend"])["k"])
        if c["e_oop"] is not None:
            kw["k_oop"] = float(_closure(c["e_oop"])["k_oop"])
        kw.update(overrides)
        out = CHDriver(axyz, dtype=dtype, device=device, **kw)
        t = out.energy_fn.terms
        same_table((t["nbr_c"], t["mask_c"], out.ch_bonds),
                   (ec["nbr"], ec["mask"], drv.ch_bonds), "neighbour table")
        return out
    if kind == "TersoffDriver":
        single = "p" in c
        nbr, mask = (c["nbr"], c["mask"]) if single else \
            (c["nbr_j"], c["mask_j"])
        kw = dict(cell=_cell_of(c), max_nnei=int(np.shape(nbr)[1]))
        if single:
            kw["params"] = {drv.els[0]: dict(c["p"])}
        kw.update(overrides)
        out = TersoffDriver(axyz, dtype=dtype, device=device, **kw)
        if single:
            t = out.energy_fn.terms
            same_table((t["nbr"], t["mask"]), (nbr, mask),
                       "neighbour table")
        return out
    if kind == "SWDriver":
        kw = dict(cell=_cell_of(c), max_nnei=int(np.shape(c["nbr"])[1]),
                  element=drv.els[0], params=dict(c["p"]))
        kw.update(overrides)
        out = SWDriver(axyz, dtype=dtype, device=device, **kw)
        t = out.energy_fn.terms
        same_table((t["nbr"], t["mask"]), (c["nbr"], c["mask"]),
                   "neighbour table")
        return out
    if kind == "EAMDriver":
        kw = dict(cell=_cell_of(c), max_nnei=int(np.shape(c["nbr"])[1]))
        if drv.table is not None:
            kw["setfl"] = {k: (np.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in drv.table.items()}
        else:
            if not np.isclose(float(c["rc"]) - float(c["r_on"]), 0.5):
                raise ValueError("from_jax_driver: EAMDriver's switch width "
                                 "is fixed at 0.5 angstrom")
            kw.update(rcut=float(c["rc"]), params=dict(
                eps=float(c["eps"]), a=float(c["a"]), c=float(c["c"]),
                n=float(c["n"]), m=float(c["m"])))
        kw.update(overrides)
        out = EAMDriver(axyz, dtype=dtype, device=device, **kw)
        t = out.energy_fn.terms
        same_table((t["nbr"], t["mask"]), (c["nbr"], c["mask"]),
                   "neighbour table")
        if drv.table is not None and not np.array_equal(
                t["types"], np.asarray(c["ti_flat"])):
            raise ValueError("from_jax_driver: the atoms' element rows "
                             "differ from the JAX driver's")
        return out
    lj = "lennard_jones" in drv.energy_fn.__qualname__
    params = dict(epsilon=float(c["eps"]), sigma=float(c["sig"])) if lj \
        else dict(D=float(c["D"]), alpha=float(c["alpha"]),
                  r0=float(c["r0"]))
    kw = dict(kind="lj" if lj else "morse", params=params,
              cutoff=float(c["cutoff"]), cell=_cell_of(c))
    kw.update(overrides)
    out = PairDriver(axyz, dtype=dtype, device=device, **kw)
    same_table(out.pairs, drv.pairs, "pair list")
    return out
