"""Typed configuration layer (counterpart of ``sclmd_tpu.utils.config``).

A run is a validated dataclass tree that can be loaded from / saved to
JSON, and assembled into a ready-to-run ``md.md`` runner of this package
on ``device`` (default: the CUDA card). The classes and the JSON format
are the JAX package's, so one file configures either package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


@dataclass
class BathConfig:
    """One bath attachment. kind: 'electron' | 'phonon'."""
    kind: str
    cats: Sequence[int]
    T: float
    # electron-bath params
    wmax: Optional[float] = None
    nw: Optional[int] = None
    bias: float = 0.0
    efric_scale: Optional[float] = None    # scalar friction eta*I
    matrices_file: Optional[str] = None    # wbLambda bundle for eta/xim/...
    # phonon-bath params
    debye: Optional[float] = None
    ml: Optional[int] = None
    mcof: float = 2.0
    gamma_file: Optional[str] = None
    classical: bool = False
    zpmotion: bool = True

    def validate(self):
        _check(self.kind in ("electron", "phonon"),
               f"bath kind must be electron|phonon, got {self.kind}")
        _check(len(self.cats) > 0, "bath needs at least one DOF")
        _check(self.T >= 0, "temperature must be >= 0")
        if self.kind == "electron":
            _check(self.efric_scale is not None
                   or self.matrices_file is not None,
                   "electron bath needs efric_scale or matrices_file")
        else:
            _check(self.debye is not None or self.gamma_file is not None,
                   "phonon bath needs debye frequency or gamma_file")
        return self


@dataclass
class MDConfig:
    """Top-level GLE MD run configuration."""
    dt: float
    nmd: int
    T: float
    nstart: int = 0
    nstop: int = 1
    npie: int = 1
    seed: int = 1234
    dtype: str = "float32"
    driver: str = "harmonic"
    # ^ harmonic|tersoff|ch|sw|eam|pair|native, or nnp (accepted for
    #   saved configs; build needs driver_obj= for it)
    driver_kwargs: dict = field(default_factory=dict)
    constraints: Sequence[Sequence[int]] = field(default_factory=list)
    baths: Sequence[BathConfig] = field(default_factory=list)
    save_power: bool = False
    save_traj: Optional[int] = None
    outdir: str = "."
    block: Optional[int] = None      # blocked-convolution fast path

    def validate(self):
        _check(self.dt > 0, "dt must be positive")
        _check(self.nmd > 0 and self.nmd % self.npie == 0,
               "nmd must be positive and divisible by npie")
        _check(self.nstop > self.nstart, "nstop must exceed nstart")
        _check(self.dtype in ("float32", "float64"),
               f"unsupported dtype {self.dtype}")
        _check(self.driver in ("harmonic", "tersoff", "ch", "sw",
                               "eam", "pair", "native", "nnp"),
               f"unknown driver kind {self.driver}")
        for b in self.baths:
            b.validate()
        return self

    # --- (de)serialisation -------------------------------------------------
    def to_json(self, path=None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2, default=list)
        if path:
            with open(path, "w") as fh:
                fh.write(s)
        return s

    @classmethod
    def from_json(cls, src: str) -> "MDConfig":
        if src.strip().startswith("{"):
            d = json.loads(src)
        else:
            with open(src) as fh:
                d = json.load(fh)
        baths = [BathConfig(**b) for b in d.pop("baths", [])]
        return cls(baths=baths, **d).validate()

    # --- assembly ----------------------------------------------------------
    def _build_driver(self, axyz, dtype, device):
        """Construct the configured force driver from its name."""
        kw = dict(self.driver_kwargs)
        if self.driver == "tersoff":
            from sclmd_tpu_torch.models.tersoff import TersoffDriver as D
        elif self.driver == "ch":
            from sclmd_tpu_torch.models.hydrocarbon import CHDriver as D
        elif self.driver == "sw":
            from sclmd_tpu_torch.models.sw import SWDriver as D
        elif self.driver == "eam":
            from sclmd_tpu_torch.models.eam import EAMDriver as D
        elif self.driver == "pair":
            from sclmd_tpu_torch.models.pair import PairDriver as D
        elif self.driver == "native":
            raise NotImplementedError(
                "config: the native (C++) driver is not ported (ROADMAP "
                "queue 1 item 5); pass driver_obj=")
        else:
            # "nnp" needs trained parameters — construct it yourself
            raise ValueError(f"config cannot build driver "
                             f"{self.driver!r}; pass driver_obj=")
        return D(axyz, dtype=dtype, device=device, **kw)

    def build(self, axyz=None, dyn=None, driver_obj=None, device=None):
        """Assemble a ready md runner (+ attached baths/driver) on
        ``device`` (default: the CUDA card).

        When ``driver`` names a model family ("tersoff", "ch", "sw",
        "eam", "pair") and no ``driver_obj`` is passed, the driver is
        built from ``axyz`` + ``driver_kwargs``; a missing ``dyn`` is
        then derived from the driver's dynamical matrix.
        """
        import numpy as np
        import torch

        from sclmd_tpu_torch import baths as B
        from sclmd_tpu_torch import resolve_device
        from sclmd_tpu_torch.md import md
        from sclmd_tpu_torch.utils.io import ReadwbLambda

        self.validate()
        device = resolve_device(device)
        dtype = torch.float64 if self.dtype == "float64" else torch.float32
        if driver_obj is None and self.driver != "harmonic":
            if axyz is None:
                raise ValueError("config driver needs axyz")
            driver_obj = self._build_driver(axyz, dtype, device)
            # derive dyn ONLY for config-built drivers: an explicitly
            # passed driver_obj with dyn=None may mean a deliberate
            # zero-velocity anharmonic start, and a surprise full
            # Hessian is expensive
            if dyn is None:
                dyn = np.asarray(driver_obj.dynmat())
        runner = md(self.dt, self.nmd, self.T, axyz=axyz, dyn=dyn,
                    nstart=self.nstart, nstop=self.nstop, npie=self.npie,
                    dtype=dtype, seed=self.seed, outdir=self.outdir,
                    block=self.block, device=device)
        if driver_obj is not None:
            runner.AddPotential(driver_obj)
        for bc in self.baths:
            nc = len(bc.cats)
            if bc.kind == "electron":
                if bc.matrices_file:
                    _, eta, xim, xip, z1, z2 = ReadwbLambda(
                        bc.matrices_file)
                    kw = dict(efric=eta, exim=xim, exip=xip,
                              zeta1=z1, zeta2=z2)
                else:
                    kw = dict(efric=np.eye(nc) * bc.efric_scale)
                bath = B.ebath(bc.cats, bc.T, self.dt, self.nmd,
                               wmax=bc.wmax, nw=bc.nw, bias=bc.bias,
                               classical=bc.classical,
                               zpmotion=bc.zpmotion, dtype=dtype,
                               device=device, **kw)
            else:
                kw = {}
                if bc.gamma_file:
                    data = np.load(bc.gamma_file)
                    kw = dict(gamma=data["gamma"], gwl=data["gwl"])
                bath = B.phbath(bc.T, bc.cats, bc.debye or 0.1,
                                bc.nw or 100, self.dt, self.nmd,
                                ml=bc.ml, mcof=bc.mcof,
                                classical=bc.classical,
                                zpmotion=bc.zpmotion, dtype=dtype,
                                device=device, **kw)
            runner.AddBath(bath)
        if self.constraints:
            runner.AddConstr([list(c) for c in self.constraints])
        if self.save_power:
            runner.CalPowerSpec()
        if self.save_traj:
            runner.SaveTraj(self.save_traj)
        return runner
