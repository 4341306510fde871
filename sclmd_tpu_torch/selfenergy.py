"""Lead self-energies via decimation surface Green's functions
(counterpart of ``sclmd_tpu.selfenergy``).

The Lopez-Sancho-style decimation runs over a batch of frequencies at
once in complex128 on the card: every iteration is a batched inverse and
a few batched products (``torch.linalg``), and a frequency that has
converged keeps its ``s, e, alpha`` (``torch.where`` on a per-frequency
mask) while the others iterate on, as the JAX package's ``while_loop``
under ``vmap`` does. The loop reads one flag back per iteration to stop
when every frequency has converged.

Conventions follow the reference exactly: the recursion uses plain
transposes (not daggers), convergence is ||alpha||_F <= 1e-8 capped at
100 iterations, and Green's functions are built from ((w + i eta)^2 I - K).
"""

from __future__ import annotations

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch import units as U

# the energy grid's chunk (the JAX package's lax.map batch)
SIGMA_BATCH = 64

MESH_MESSAGE = ("a device mesh is not ported yet: multi-GPU energy-grid "
                "parallelism is ROADMAP.md queue 1 item 8 (multi-GPU)")


def host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _cdtype(x):
    """complex128 for float64 (or complex128) blocks, else complex64."""
    if torch.is_tensor(x):
        wide = x.dtype in (torch.float64, torch.complex128)
    else:
        wide = np.asarray(x).dtype in (np.float64, np.complex128)
    return torch.complex128 if wide else torch.complex64


def _on(x, device, dtype):
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def z_squared(w: torch.Tensor, eta: float, cdt=torch.complex128):
    """(w + i eta)^2 from real products, (w^2 - eta^2) + i (2 w eta): the
    same bits at every position of a batch (the CPU's vectorised
    complex product rounds otherwise than its scalar tail)."""
    return torch.complex(w * w - eta * eta, 2 * w * eta).to(cdt)


def surface_gf(omega, e, s, alpha, eta: float = 0.164e-3 / U.RPC,
               tol: float = 1e-8, max_iter: int = 100, device=None):
    """Surface Green's function by decimation, for a batch of omegas.

    omega : (nw,) frequencies (a scalar gives unbatched results)
    e     : (n, n) bulk principal-layer block (iterated)
    s     : (n, n) surface block (accumulated)
    alpha : (n, n) interlayer coupling

    Returns (g (nw, n, n), niter (nw,) int32, converged (nw,) bool) on
    ``device`` (default: the CUDA card). A frequency stops iterating
    (its carry frozen) once ||alpha||_F <= tol; ``niter`` counts its own
    iterations.
    """
    device = resolve_device(device)
    cdt = _cdtype(e)
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    w = _on(omega, device, rdt)
    scalar = w.ndim == 0
    w = w.reshape(-1)
    nw, n = w.shape[0], int(e.shape[-1])
    zi = torch.diag_embed(z_squared(w, eta, cdt)[:, None].expand(nw, n))
    s_, e_, a_ = (_on(x, device, cdt).expand(nw, n, n).clone()
                  for x in (s, e, alpha))
    it = torch.zeros(nw, dtype=torch.int32, device=device)
    for _ in range(max_iter):
        active = torch.linalg.matrix_norm(a_) > tol
        if not bool(active.any()):
            break
        g, _info = torch.linalg.inv_ex(zi - e_)
        b_ = a_.mT
        agb = a_ @ g @ b_
        keep = active[:, None, None]
        s_ = torch.where(keep, s_ + agb, s_)
        e_ = torch.where(keep, e_ + agb + b_ @ g @ a_, e_)
        a_ = torch.where(keep, a_ @ g @ a_, a_)
        it = it + active.to(torch.int32)
    g_surf, _info = torch.linalg.inv_ex(zi - s_)
    converged = torch.linalg.matrix_norm(a_) <= tol
    if scalar:
        return g_surf[0], it[0], converged[0]
    return g_surf, it, converged


def surface_gf_np(omega, e, s, alpha, eta: float = 0.164e-3 / U.RPC,
                  tol: float = 1e-8, max_iter: int = 100):
    """Host NumPy twin of ``surface_gf`` at one omega, for setup paths
    (the bath builders). Same default eta as ``surface_gf`` (the
    reference's 0.164e-3 eV / rpc)."""
    z2 = (omega + 1j * eta) ** 2
    eye = np.eye(len(e))
    s = np.asarray(s, complex).copy()
    e = np.asarray(e, complex).copy()
    a = np.asarray(alpha, complex).copy()
    for _ in range(max_iter):
        if np.linalg.norm(a) <= tol:
            break
        g = np.linalg.inv(z2 * eye - e)
        b = a.T
        agb = a @ g @ b
        s = s + agb
        e = e + agb + b @ g @ a
        a = a @ g @ a
    return np.linalg.inv(z2 * eye - s)


def lead_selfenergy_from_blocks_np(K00, K01, V01, wl, eta: float = 1e-5,
                                   max_iter: int = 100):
    """NumPy twin of ``lead_selfenergy_from_blocks`` (host-side setup)."""
    out = []
    for w in np.asarray(wl):
        g = surface_gf_np(w, K00, K00, K01, eta=eta, max_iter=max_iter)
        out.append(V01 @ g @ V01.T)
    return np.array(out)


def lead_selfenergy_from_blocks(K00, K01, V01, wl, eta: float = 1e-5,
                                max_iter: int = 100, device=None):
    """Sigma(w) on system DOFs from semi-infinite-lead blocks, on
    ``device`` (default: the card).

    The lead has onsite block ``K00`` and inter-layer coupling ``K01``;
    the system couples to the surface layer through ``V01`` (nsys x
    nlead). Then Sigma(w) = V01 . g_surf(w) . V01^T over the grid
    ``wl`` in one batch. All blocks in natural eV^2 units."""
    g, _, _ = surface_gf(wl, K00, K00, K01, eta=eta, max_iter=max_iter,
                         device=device)
    v = _on(V01, g.device, g.dtype)
    return v @ g @ v.mT


class sig:
    """Reference-compatible lead self-energy object.

    sig(dynmat, maxomega, atomgroup0, atomgroup1, ...)

    ``dynmat`` may be a square array in ps^-2 (the LAMMPS ``eskm``
    convention), a text file path of flattened rows, or a driver object
    exposing ``.dynmat()`` in eV^2 (converted internally). The sweeps run
    on ``device`` (default: the CUDA card) in complex128; results come
    back as host numpy arrays, as the JAX package's do.
    """

    def __init__(self, dynmat, maxomega, atomgroup0, atomgroup1,
                 dofatomfixed=(list(), list()), dynmatfile=None, num=1000,
                 eta=0.164e-3, write_files=False, dtype=torch.float64,
                 device=None):
        self.rpc = U.RPC
        self.maxomega = maxomega / self.rpc
        self.intnum = num
        self.eta = eta / self.rpc
        self.dofatomK00 = np.asarray(list(atomgroup0), dtype=np.int64)
        self.dofatomK11 = np.asarray(list(atomgroup1), dtype=np.int64)
        self.dofatomfixed = [list(g) for g in dofatomfixed]
        self.write_files = write_files
        self.dtype = dtype
        self.device = resolve_device(device)
        self.niter = {}
        self.ep = np.linspace(0, self.maxomega, self.intnum + 1)
        self._load_dynmat(dynmat if dynmatfile is None else dynmatfile)
        self.getdk()

    # -- setup -------------------------------------------------------------
    def _load_dynmat(self, dynmat):
        if isinstance(dynmat, str):
            dat = np.loadtxt(dynmat)
            n = int(3 * np.sqrt(len(dat) / 3))
            dynmat = dat.reshape(n, n)
        elif hasattr(dynmat, "dynmat"):
            dynmat = host(dynmat.dynmat()) / U.RPC ** 2
        dynmat = np.asarray(host(dynmat), dtype=np.float64)
        self.dynmat = dynmat  # fixed DOFs are NOT removed before block
        # extraction, as in the reference
        dm = np.delete(dynmat, self.dofatomfixed[0], axis=0)
        dm = np.delete(dm, self.dofatomfixed[0], axis=1)
        shift = [d - len(self.dofatomfixed[0]) for d in self.dofatomfixed[1]]
        dm = np.delete(dm, shift, axis=0)
        dm = np.delete(dm, shift, axis=1)
        eigvals, eigvecs = np.linalg.eigh((dm + dm.T) / 2)
        self.omegas = np.where(eigvals > 0, np.sqrt(np.abs(eigvals)),
                               -np.sqrt(np.abs(eigvals))) * self.rpc
        ffi = np.nonzero(eigvals <= 0)[0]
        if self.write_files:
            np.savetxt("falsefrequencies.dat", ffi, fmt="%d")
            np.savetxt("omegas.dat", self.omegas)
            np.savetxt("eigvecs.dat", eigvecs)

    def getdk(self):
        """Extract the K00/K01/K10/K11 blocks and repair their symmetry."""
        d = self.dynmat
        self.K00 = d[np.ix_(self.dofatomK00, self.dofatomK00)]
        self.K11 = d[np.ix_(self.dofatomK11, self.dofatomK11)]
        self.K01 = d[np.ix_(self.dofatomK00, self.dofatomK11)]
        self.K10 = d[np.ix_(self.dofatomK11, self.dofatomK00)]
        mism = np.max(np.abs(self.K01 - self.K10.T)) / np.max(np.abs(self.K01))
        if mism > 1e-8:
            raise ValueError("K01 and K10 are not symmetric", mism)
        self.K01 = (self.K01 + self.K10.T) / 2
        self.K10 = self.K01.T

    def _dev(self, m):
        return torch.as_tensor(m, dtype=torch.complex128, device=self.device)

    # -- per-omega API (reference names) -----------------------------------
    def _blocks(self, direction):
        if direction == "R":
            return self.K00, self.K11, self.K01
        if direction == "L":
            return self.K11, self.K00, self.K10
        raise ValueError("Wrong direction, should only be R or L")

    def sgf(self, omega, direction):
        s, e, alpha = self._blocks(direction)
        g, _niter, conv = surface_gf(float(omega), e, s, alpha, eta=self.eta,
                                     device=self.device)
        if not bool(conv):
            raise ValueError(
                "Iteration number exceeded 100, please increase eta")
        return g

    def selfenergy(self, omega, direction):
        if direction == "R":
            return self._dev(self.K01) @ self.sgf(omega, direction) @ \
                self._dev(self.K10)
        if direction == "L":
            return self._dev(self.K10) @ self.sgf(omega, direction) @ \
                self._dev(self.K01)
        raise ValueError("Wrong direction, should only be R or L")

    def gamma(self, Pi):
        return -1j * (Pi - Pi.conj().mT)

    # -- batched sweeps ----------------------------------------------------
    def _sigma_batch(self, wl, direction, mesh=None, shard_axis=None):
        """Sigma(w) (nw, n, n) on the card over ``wl`` in chunks of 64;
        each frequency's decimation count goes to
        ``self.niter[direction]`` (host int32)."""
        if mesh is not None:
            raise NotImplementedError(MESH_MESSAGE)
        s, e, alpha = (torch.as_tensor(m, dtype=torch.float64,
                                       device=self.device)
                       for m in self._blocks(direction))
        post_l, post_r = ((self.K01, self.K10) if direction == "R"
                          else (self.K10, self.K01))
        post_l, post_r = self._dev(post_l), self._dev(post_r)
        ws = torch.as_tensor(np.asarray(wl, np.float64), device=self.device)
        se, its, convs = [], [], []
        for i in range(0, ws.shape[0], SIGMA_BATCH):
            g, it, conv = surface_gf(ws[i:i + SIGMA_BATCH], e, s, alpha,
                                     eta=self.eta, device=self.device)
            se.append(post_l @ g @ post_r)
            its.append(it)
            convs.append(conv)
        self.niter[direction] = host(torch.cat(its))
        if not bool(torch.cat(convs).all()):
            raise ValueError(
                "Iteration number exceeded 100, please increase eta")
        return torch.cat(se)

    def getse(self, direction, mesh=None, shard_axis=None):
        """Sigma(w) sweep and the lead DOS (host numpy (nw, n, n))."""
        se = self._sigma_batch(self.ep, direction, mesh=mesh,
                               shard_axis=shard_axis)
        ep = torch.as_tensor(self.ep, device=se.device)
        dosx = -torch.einsum("wii->w", se.imag) * ep / np.pi
        self.dos = np.column_stack((self.ep, host(dosx)))
        if self.write_files:
            np.savetxt(f"densityofstates_{direction}.dat",
                       np.column_stack((self.dos[:, 0] * self.rpc,
                                        self.dos[:, 1])))
        return host(se)

    def retargf(self, omega):
        """Device retarded GF with both lead self-energies."""
        n = len(self.K00)
        z2 = (omega + 1e-8j) ** 2
        return torch.linalg.inv_ex(
            z2 * torch.eye(n, dtype=torch.complex128, device=self.device)
            - self._dev(self.K00) - self.selfenergy(omega, "L")
            - self.selfenergy(omega, "R"))[0]

    def tm(self, omega):
        gr = self.retargf(omega)
        gl = self.gamma(self.selfenergy(omega, "L"))
        gr2 = self.gamma(self.selfenergy(omega, "R"))
        return float(torch.trace(gr @ gl @ gr.conj().mT @ gr2).real)

    def gettm(self):
        """Caroli transmission over the full grid, in chunks of 64."""
        seL = self._sigma_batch(self.ep, "L")
        seR = self._sigma_batch(self.ep, "R")
        k00 = self._dev(self.K00)
        eye = torch.eye(len(self.K00), dtype=torch.complex128,
                        device=self.device)
        ws = torch.as_tensor(self.ep, device=self.device)
        tm = []
        for i in range(0, ws.shape[0], SIGMA_BATCH):
            w, sl, sr = (x[i:i + SIGMA_BATCH] for x in (ws, seL, seR))
            gr = torch.linalg.inv_ex(z_squared(w, 1e-8)[:, None, None] * eye
                                     - k00 - sl - sr)[0]
            gl = -1j * (sl - sl.conj().mT)
            g2 = -1j * (sr - sr.conj().mT)
            tm.append(torch.einsum(
                "wii->w", gr @ gl @ gr.conj().mT @ g2).real)
        self.tmnumber = np.column_stack((self.ep, host(torch.cat(tm))))
        if self.write_files:
            np.savetxt("transmission.dat",
                       np.column_stack((self.tmnumber[:, 0] * self.rpc,
                                        self.tmnumber[:, 1])))
        return self.tmnumber

    def plotresult(self, lines=180):
        from matplotlib import pyplot as plt
        plt.figure(0)
        plt.hist(self.omegas, bins=lines)
        plt.xlabel("Frequence(eV)")
        plt.ylabel("Number")
        plt.savefig("omegas.png")
        plt.figure(1)
        plt.plot(self.dos[:, 0] * self.rpc, self.dos[:, 1])
        plt.xlabel("Frequence(eV)")
        plt.ylabel("DOS")
        plt.savefig("densityofstates.png")
        plt.figure(2)
        plt.plot(self.tmnumber[:, 0] * self.rpc, self.tmnumber[:, 1])
        plt.xlabel("Frequence(eV)")
        plt.ylabel("Transmission")
        plt.savefig("transmission.png")
