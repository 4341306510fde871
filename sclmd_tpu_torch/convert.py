"""Build the port's objects from the JAX package's pytrees.

Reads a ``sclmd_tpu`` bath or ``GLESystem`` through ``np.asarray`` on
its attributes, so this module needs no jax import; the tests use it to
make both packages compute the same thing.
"""

from __future__ import annotations

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


def from_jax_system(system, device=None) -> GLESystem:
    """A ``sclmd_tpu.md.GLESystem`` (harmonic ``dyn``; electron, local
    and memory-kernel phonon baths) as the port's ``GLESystem`` on
    ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    if system.force_fn is not None or system.cf_fn is not None:
        raise NotImplementedError(
            "from_jax_system: force drivers are not ported yet "
            "(ROADMAP queue 1 item 7)")
    return GLESystem(
        dyn=_tensor(system.dyn, device),
        baths=tuple(from_jax_bath(b, device) for b in system.baths),
        mask=_tensor(system.mask, device),
        dt=float(system.dt), nph=int(system.nph), ml=int(system.ml),
        nmd=int(system.nmd), unconstrained=bool(system.unconstrained),
        savep=bool(system.savep), saveq=bool(system.saveq),
        savef=bool(system.savef))
