"""Force-driver protocol (counterpart of ``sclmd_tpu.models.driver``).

A driver turns a differentiable energy function of the cartesian
positions into the integrator's force, in the mass-weighted displacement
coordinates of the reference: x = xyz + conv * q with conv_i = md2ang /
sqrt(m_atom(i)), and F(q) = conv * f(x) - f0 with f0 the force at q = 0.

Energy functions of the port take positions ``(..., na, 3)`` and return
energies ``(...)``: the leading axes are the trajectory batch. Their
constants (index tables, per-pair parameters) are kept as host numpy in a
``Consts`` and moved to the device and dtype of the positions at first
use there, so one function serves the float32 run on the card and the
float64 Hessian and relaxation on the CPU.

Protocol (the JAX package's, with ``force_jax``/``energy_jax`` named
``force_torch``/``energy_torch`` and batched): ``axyz``, ``conv``,
``xyz``, ``els``, ``number``, ``f0``, ``force``, ``absforce``, ``newx``,
``initforce``, ``energy``, ``dynmat``, ``quit``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch import units as U


class Consts:
    """Named host constants of an energy function, as tensors on the
    device of the function's argument: floating arrays in the argument's
    dtype, integer and boolean arrays as they are."""

    def __init__(self, **arrays):
        self._np = {k: np.asarray(v) for k, v in arrays.items()}
        self._cache = {}

    def on(self, x: torch.Tensor) -> dict:
        key = (x.device, x.dtype)
        if key not in self._cache:
            # made outside any torch.func transform the call runs under
            # (a Hessian): tensors made inside one carry its level, and
            # cached they break the next transform's call
            with torch._C._DisableFuncTorch():
                self._cache[key] = self._tensors(x)
        return self._cache[key]

    def _tensors(self, x: torch.Tensor) -> dict:
        return {k: torch.as_tensor(
                    v, device=x.device,
                    dtype=x.dtype if v.dtype.kind == "f" else None)
                for k, v in self._np.items()}


class TorchDriver:
    """Force driver built from a differentiable energy function.

    ``energy_fn``: positions (..., na, 3) angstrom -> energy (...) eV;
    ``axyz``: list of [element, x, y, z] rows, the relaxed structure;
    ``device`` defaults to the CUDA card. The force is ``-grad`` of the
    energy by ``torch.autograd``, for the whole batch in one backward
    pass (the trajectories' energies are independent, so the gradient of
    their sum is each one's gradient).
    """

    def __init__(self, energy_fn: Callable, axyz, md2ang=U.MD2ANG,
                 dtype=torch.float32, device=None):
        self.energy_fn = energy_fn
        self.md2ang = md2ang
        self.dtype = dtype
        self.device = resolve_device(device)
        self.els = [a[0] for a in axyz]
        self.axyz = axyz
        self.number = len(axyz)
        self.xyz = np.array([a[1:] for a in axyz], dtype=float).flatten()
        mass = np.array([U.AtomicMassTable[e] for e in self.els])
        self.conv = self.md2ang * np.repeat(1.0 / np.sqrt(mass), 3)
        self._xyz_t = torch.as_tensor(self.xyz, dtype=dtype,
                                      device=self.device)
        self._conv_t = torch.as_tensor(self.conv, dtype=dtype,
                                       device=self.device)
        self.f0 = None
        self.initforce()

    def _tensor(self, q) -> torch.Tensor:
        return torch.as_tensor(q, dtype=self.dtype, device=self.device)

    def _positions(self, q: torch.Tensor) -> torch.Tensor:
        x = self._xyz_t + self._conv_t * q
        return x.reshape(q.shape[:-1] + (self.number, 3))

    def _abs_force(self, q: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            x = self._positions(q.detach()).requires_grad_(True)
            g, = torch.autograd.grad(self.energy_fn(x).sum(), x)
        return -self._conv_t * g.reshape(q.shape)

    # --- the reference's driver protocol ---
    def initforce(self):
        self.f0 = self._abs_force(self._tensor(np.zeros(3 * self.number)))

    def newx(self, q):
        if torch.is_tensor(q):
            q = q.detach().cpu().numpy()
        return self.xyz + self.conv * np.asarray(q)

    def absforce(self, q):
        return self._abs_force(self._tensor(q))

    def force(self, q):
        return self._abs_force(self._tensor(q)) - self.f0

    def force_torch(self, q: torch.Tensor) -> torch.Tensor:
        """The integrator's path: q (traj, nph) or (nph,) on the driver's
        device -> conv * f(xyz + conv q) - f0, same shape."""
        return self._abs_force(q) - self.f0

    def energy_torch(self, q: torch.Tensor) -> torch.Tensor:
        """Total energy (eV) at the relative displacement q, per
        trajectory."""
        return self.energy_fn(self._positions(q))

    def energy(self, q=None) -> float:
        if q is None:
            q = np.zeros(3 * self.number)
        return float(self.energy_torch(self._tensor(q)))

    def dynmat(self, q=None, dtype=torch.float64, chunk=None):
        """Dynamical matrix in eV^2: the Hessian of the energy in q-space
        at the (displaced) structure, as a CPU tensor.

        Always on the CPU and by default in float64, whatever the
        driver's device and dtype: float32 second derivatives of a stiff
        many-body potential cancel badly (on the 201-atom C/H junction
        the JAX package measured a float32 Hessian with its top band at
        0.29 eV^2 against the true 0.81, and spurious unstable modes).

        ``chunk``: build the Hessian in row blocks of batched
        Hessian-vector products instead of one ``torch.func.hessian``
        call. ``None`` selects the full Hessian below 512 DOFs and
        256-row blocks above. The result is the same either way.
        """
        nph, na = 3 * self.number, self.number
        xyz = torch.as_tensor(self.xyz, dtype=dtype)
        conv = torch.as_tensor(self.conv, dtype=dtype)
        q0 = torch.zeros(nph, dtype=dtype) if q is None else \
            torch.as_tensor(np.asarray(q), dtype=dtype)

        def e_of_q(qq):
            return self.energy_fn((xyz + conv * qq).reshape(na, 3))

        if chunk is None and nph > 512:
            chunk = 256
        if chunk:
            grad_fn = torch.func.grad(e_of_q)
            hvp_block = torch.func.vmap(
                lambda v: torch.func.jvp(grad_fn, (q0,), (v,))[1])
            eye = torch.eye(nph, dtype=dtype)
            h = torch.cat([hvp_block(eye[i:i + chunk])
                           for i in range(0, nph, chunk)], dim=0)
        else:
            h = torch.func.hessian(e_of_q)(q0)
        return 0.5 * (h + h.T)

    def quit(self):
        pass


class DriverShell:
    """Delegation base of the specialised drivers (pair, Tersoff, C/H):
    a subclass builds its energy function and calls ``_attach``; the
    protocol then forwards to the wrapped ``TorchDriver``. A subclass
    with a force kernel (``kernels.ch_force.CHForce``) hands it to
    ``_use_kernel``: the forces then go through it."""

    kernel = None

    def _attach(self, energy_fn, axyz, dtype, device=None,
                md2ang=U.MD2ANG):
        self._drv = TorchDriver(energy_fn, axyz, md2ang=md2ang, dtype=dtype,
                                device=device)
        self.energy_fn = energy_fn
        for attr in ("axyz", "conv", "xyz", "els", "number", "f0", "dtype",
                     "device"):
            setattr(self, attr, getattr(self._drv, attr))

    def _use_kernel(self, kernel):
        """Route the forces through ``kernel``, whose f0 (the kernel's own
        force at q = 0, where it is built) becomes the driver's."""
        self.kernel = kernel
        if kernel.cuda is not None:
            self.f0 = kernel.cuda.f0

    def force(self, q):
        if self.kernel is None:
            return self._drv.force(q)
        return self.force_torch(self._drv._tensor(q))

    def newx(self, q):
        return self._drv.newx(q)

    def force_torch(self, q):
        if self.kernel is None:
            return self._drv.force_torch(q)
        return self.kernel(q)

    def energy_torch(self, q):
        return self._drv.energy_torch(q)

    def energy_force_torch(self, q):
        """(energy per trajectory, force) in one evaluation."""
        if self.kernel is None:
            return (self._drv.energy_torch(q).detach(),
                    self._drv.force_torch(q))
        return self.kernel(q, energy=True)

    def absforce(self, q):
        if self.kernel is None:
            return self._drv.absforce(q)
        return self.force(q) + self.f0

    def initforce(self):
        self._drv.initforce()
        self.f0 = self._drv.f0

    def energy(self, q=None):
        return self._drv.energy(q)

    def dynmat(self, q=None, **kw):
        return self._drv.dynmat(q, **kw)

    def quit(self):
        pass


class HostDriver:
    """Adapter for a host-side force engine (an external process, a
    library behind ctypes): one host round trip per trajectory and
    evaluation, as the reference pays. Off the fast path by design.

    ``host`` implements ``.force(q) -> (nph,)`` on numpy arrays, with
    ``conv``/``f0``/``axyz``/``els``/``xyz`` passed through when it has
    them."""

    def __init__(self, host, nph: int, dtype=torch.float32):
        self.host = host
        self.nph = nph
        self.dtype = dtype
        for attr in ("conv", "f0", "axyz", "els", "xyz"):
            if hasattr(host, attr):
                setattr(self, attr, getattr(host, attr))

    def force_torch(self, q: torch.Tensor) -> torch.Tensor:
        rows = q.detach().cpu().numpy().reshape(-1, self.nph)
        f = np.stack([np.asarray(self.host.force(r)) for r in rows])
        return torch.as_tensor(f.reshape(tuple(q.shape)), dtype=q.dtype,
                               device=q.device)

    def force(self, q):
        if torch.is_tensor(q):
            q = q.detach().cpu().numpy()
        return np.asarray(self.host.force(np.asarray(q)))

    def dynmat(self, q=None):
        return self.host.dynmat(q) if hasattr(self.host, "dynmat") else None

    def energy(self, *a, **kw):
        return self.host.energy(*a, **kw) \
            if hasattr(self.host, "energy") else None

    def quit(self):
        if hasattr(self.host, "quit"):
            self.host.quit()
