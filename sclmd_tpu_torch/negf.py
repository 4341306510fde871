"""Ballistic phonon NEGF transport, batched over the energy grid
(counterpart of ``sclmd_tpu.negf``).

Every sweep runs on ``device`` (default: the CUDA card) in complex128:
the matrices of ``batch_size`` frequencies are built at once, and the
batched ``torch.linalg`` solves always take groups of ``SOLVE_GROUP``
frequencies, the last group padded with copies of the last frequency.
The card's batched LU picks its algorithm by the batch count (MAGMA's
bits differ between 32 and 33 matrices), so a fixed group keeps every
frequency's bits whatever the chunk.

The wideband lead broadenings are diagonal, so the Caroli trace
Tr[G Gamma_L G^dag Gamma_R] needs only the G columns on the left-bath
DOFs: an (nd, nL) solve, not a full inverse. At w = 0 a free
structure's matrix is singular; the solves do not raise
(``torch.linalg.solve_ex``/``inv_ex``) and the result there is masked to
0, as in the JAX package, with no read-back per chunk.

Unit conventions match the reference: frequencies internally in ps^-1,
inputs/outputs in eV via RPC; the dynamical matrix is in ps^-2 (LAMMPS
``dynamical_matrix eskm`` convention); heat currents in nW.
"""

from __future__ import annotations

import numpy as np
import torch

from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch import units as U
from sclmd_tpu_torch.selfenergy import MESH_MESSAGE, host, z_squared

C128 = torch.complex128
# frequencies per batched solve (the JAX package's default chunk)
SOLVE_GROUP = 32


class bpt:
    """Ballistic phonon transport, LAMMPS-free.

    Parameters
    ----------
    dynmat : square array in ps^-2, path to a dynmat.dat-style text file,
        or a driver exposing ``.dynmat()`` in eV^2 (converted).
    maxomega : energy cutoff in eV.
    damp : wideband lead damping time in ps; Sigma^r = -i w / damp.
    dofatomofbath : [left_dofs, right_dofs] DOF index lists.
    dofatomfixed : [first_block, second_block] fixed DOFs, deleted with
        the reference's two-stage shifted indexing.
    num : number of energy intervals (grid has num+1 points).
    batch_size : frequencies whose matrices are built at once (rounded
        up to a multiple of SOLVE_GROUP); the results do not depend on it.
    device : where the sweeps run (default: the CUDA card).
    """

    def __init__(self, dynmat, maxomega, damp, dofatomofbath,
                 dofatomfixed=(list(), list()), dynmatfile=None, num=1000,
                 vector=False, write_files=False,
                 els=None, xyz=None, boxlo=None, boxhi=None,
                 batch_size=32, device=None):
        self.rpc = U.RPC
        self.bc = U.BOLTZ_EV
        self.damp = damp
        self.maxomega = maxomega / self.rpc
        self.intnum = num
        self.dofatomfixed = [list(g) for g in dofatomfixed]
        self.dofatomofbath = [np.asarray(list(g), dtype=np.int64)
                              for g in dofatomofbath]
        self.isbias = False
        self.dofatomofbias = []
        self.write_files = write_files
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.els = None if els is None else np.asarray(els, dtype=float)
        self.xyz = None if xyz is None else np.asarray(xyz, dtype=float)
        self.boxlo, self.boxhi = boxlo, boxhi
        self._sels = {}
        self._setup(dynmat if dynmatfile is None else dynmatfile)
        self._D = torch.as_tensor(self.dynmat, device=self.device)

    # ------------------------------------------------------------------
    def _setup(self, dynmat):
        if isinstance(dynmat, str):
            dat = np.loadtxt(dynmat)
            n = int(3 * np.sqrt(len(dat) / 3))
            dynmat = dat.reshape(n, n)
        elif hasattr(dynmat, "dynmat"):
            driver = dynmat
            dynmat = host(driver.dynmat()) / U.RPC ** 2
            if self.els is None and hasattr(driver, "els"):
                els = np.asarray(driver.els)
                if els.dtype.kind in "US":   # element symbols -> masses
                    els = np.array(
                        [U.AtomicMassTable[e] for e in driver.els],
                        dtype=float)
                else:
                    els = els.astype(float)
                if 3 * len(els) == len(dynmat):
                    els = np.repeat(els, 3)   # per-atom -> per-DOF
                self.els = els
            if self.xyz is None and hasattr(driver, "xyz"):
                self.xyz = np.asarray(driver.xyz, dtype=float)
        dynmat = np.asarray(host(dynmat), dtype=np.float64)
        self.nd0 = len(dynmat)
        self.natoms = self.nd0 // 3
        dynmat = (dynmat + dynmat.T) / 2
        self.dynmat = self._cleanse(dynmat, axes=(0, 1))
        # element masses / coordinates trimmed the same way
        if self.els is not None and len(self.els) == self.nd0:
            self.els = self._cleanse(self.els, axes=(0,))
        if self.xyz is not None and len(self.xyz) == self.nd0:
            self.xyz = self._cleanse(self.xyz, axes=(0,))
        eigvals, self.eigvecs = np.linalg.eigh(self.dynmat)
        self.omegas = np.where(eigvals > 0, np.sqrt(np.abs(eigvals)),
                               -np.sqrt(np.abs(eigvals))) * self.rpc
        ffi = np.nonzero(eigvals <= 0)[0]
        print("%i false frequencies exist in %i frequencies"
              % (len(ffi), len(self.omegas)))
        if self.write_files:
            np.savetxt("falsefrequencies.dat", ffi, fmt="%d")
            np.savetxt("omegas.dat", self.omegas)
            np.savetxt("eigvecs.dat", self.eigvecs)
        # map original DOF ids -> post-deletion ids
        keep = np.ones(self.nd0, dtype=bool)
        keep[self.dofatomfixed[0]] = False
        keep[self.dofatomfixed[1]] = False
        self._newid = np.cumsum(keep) - 1
        self._keep = keep
        self.nd = int(keep.sum())
        assert self.nd == len(self.dynmat)

    def _cleanse(self, m, axes=(0, 1)):
        """Two-stage fixed-DOF deletion with a shifted second block."""
        shift = [d - len(self.dofatomfixed[0]) for d in self.dofatomfixed[1]]
        for ax in axes:
            m = np.delete(m, self.dofatomfixed[0], axis=ax)
            m = np.delete(m, shift, axis=ax)
        return m

    def _bathsel(self, dofatoms):
        """Post-deletion indices of a bath DOF group."""
        ids = np.asarray(list(dofatoms), dtype=np.int64)
        if not self._keep[ids].all():
            raise ValueError("bath DOFs overlap fixed DOFs")
        return self._newid[ids]

    def _sel(self, dofatoms, check=True):
        """``_bathsel`` (or the bare id map without ``check``) as an
        index tensor on the device, cached per DOF list."""
        ids = np.asarray(list(dofatoms), dtype=np.int64)
        key = (check, ids.tobytes())
        if key not in self._sels:
            sel = self._bathsel(ids) if check else self._newid[ids]
            self._sels[key] = torch.as_tensor(sel, device=self.device)
        return self._sels[key]

    def _omegas(self, omegas):
        return torch.as_tensor(host(omegas) if not torch.is_tensor(omegas)
                               else omegas, dtype=torch.float64) \
            .to(self.device).reshape(-1)

    # ------------------------------------------------------------------
    def setbias(self, bias, bdamp=None, chiplus=None, chiminus=None,
                dofatomofbias=()):
        """Attach a bias self-energy block; units eV, ps^-1."""
        self.isbias = True
        self.bias = bias / self.rpc
        self.biasgamma = np.asarray(bdamp)
        self.chiplus = np.asarray(chiplus)
        self.chiminus = np.asarray(chiminus)
        self.dofatomofbias = np.asarray(list(dofatomofbias), dtype=np.int64)
        if not (len(self.biasgamma) == len(self.chiminus)
                == len(self.chiplus) == len(self.dofatomofbias)):
            raise ValueError("Bias parameters not set correctly")

    # ------------------------------------------------------------------
    def bosedist(self, omega, T):
        """Bose factor with the reference's overflow guards, float64, on
        the device of ``omega`` (the CPU for host input)."""
        omega = torch.as_tensor(omega, dtype=torch.float64)
        big = float(np.iinfo(np.int32).max)
        if abs(T) < 1e-30:
            return 1.0 / (torch.exp(self.rpc * omega * big) - 1)
        ratio_small = torch.abs(omega / T) < 1e-30
        x = self.rpc * omega / (self.bc * T)
        x = torch.where(ratio_small, 1.0, x)
        return torch.where(ratio_small, big, 1.0 / torch.expm1(x))

    # -- wideband self-energies as diagonal vectors ---------------------
    def _sigma_diag(self, omegas, sel):
        """(nw, nd) diagonal of Sigma^r = -i w/damp on the selected DOFs."""
        out = torch.zeros((omegas.shape[0], self.nd), dtype=C128,
                          device=omegas.device)
        out[:, sel] = torch.complex(torch.zeros_like(omegas),
                                    -omegas / self.damp)[:, None]
        return out

    def _bias_block(self, omegas):
        """(nw, nb, nb) retarded bias self-energy block."""
        bg = torch.as_tensor(self.biasgamma, dtype=C128, device=omegas.device)
        chim = torch.as_tensor(self.chiminus, dtype=C128,
                               device=omegas.device)
        return (-1j * omegas[:, None, None] * bg[None]
                - self.bias * chim[None])

    def _amatrix(self, omegas):
        """(nw, nd, nd) of (w+i e)^2 I - D - Sigma_L - Sigma_R - Sigma_bias."""
        selL = self._sel(self.dofatomofbath[0])
        selR = self._sel(self.dofatomofbath[1])
        sdiag = self._sigma_diag(omegas, selL) + \
            self._sigma_diag(omegas, selR)
        a = (-self._D).to(C128).expand(omegas.shape[0], self.nd,
                                       self.nd).clone()
        diag = a.diagonal(dim1=-2, dim2=-1)
        diag += z_squared(omegas, 1e-9)[:, None]
        diag -= sdiag
        if self.isbias and len(self.dofatomofbias):
            selB = self._sel(self.dofatomofbias)
            a[:, selB[:, None], selB[None, :]] -= self._bias_block(omegas)
        return a

    def retargf(self, omega):
        """Dense retarded GF at one omega (ps^-1)."""
        return torch.linalg.inv_ex(self._amatrix(self._omegas([omega]))[0])[0]

    def advangf(self, omega):
        a = self._amatrix(self._omegas([omega]))[0]
        return torch.linalg.inv_ex(a.mT.conj())[0]

    def gamma(self, Pi):
        return -1j * (Pi - Pi.conj().mT)

    # -- reference-named self-energy surface. These return full
    # post-cleanse host matrices from ORIGINAL (pre-deletion) DOF ids,
    # exactly like the reference; the batched sweep internals
    # (_sigma_diag/_bias_block/_kbias_block) are the hot path.
    def cleanse(self, semat):
        """Fixed-DOF deletion of a full-space matrix."""
        out = self._cleanse(np.asarray(semat), axes=(0, 1))
        if len(out) != self.nd:
            raise ValueError("System DOF test failed, check again")
        return out

    def retarselfenergy(self, omega, dofatoms):
        """Wideband Sigma^r(w) on the given DOFs."""
        semat = np.zeros((self.nd0, self.nd0), complex)
        ids = np.asarray(list(dofatoms), np.int64)
        semat[ids, ids] = -1j * omega / self.damp
        return self.cleanse(semat)

    def advanselfenergy(self, omega, dofatoms):
        return self.retarselfenergy(omega, dofatoms).conjugate().T

    def retarbiasselfenergy(self, omega, dofatoms):
        """Bias block Sigma^r_bias; 0 when unbiased."""
        if not self.isbias:
            return 0
        semat = np.zeros((self.nd0, self.nd0), complex)
        ids = np.asarray(list(dofatoms), np.int64)
        semat[np.ix_(ids, ids)] = (-1j * omega * self.biasgamma
                                   - self.bias * self.chiminus)
        return self.cleanse(semat)

    def advanbiasselfenergy(self, omega, dofatoms):
        b = self.retarbiasselfenergy(omega, dofatoms)
        return 0 if np.isscalar(b) else b.conjugate().T

    def kselfenergy(self, omega, T, dofatoms):
        """Keldysh Sigma^K = -2 Im Sigma^r n_B."""
        return -2 * np.imag(self.retarselfenergy(omega, dofatoms)) \
            * float(self.bosedist(omega, T))

    def kbiasselfenergy(self, omega, T, dofatoms):
        """Bias Keldysh self-energy with the chi+- combination; 0 when
        unbiased."""
        if not self.isbias:
            return 0
        nB = lambda w: float(self.bosedist(w, T))  # noqa: E731
        semat = np.zeros((self.nd0, self.nd0), complex)
        ids = np.asarray(list(dofatoms), np.int64)
        blk = ((self.chiplus - 1j * self.chiminus) * (omega + self.bias)
               * (2 * nB(omega + self.bias) - 2 * nB(omega))
               + (self.chiplus + 1j * self.chiminus) * (omega - self.bias)
               * (2 * nB(omega - self.bias) - 2 * nB(omega))) / 2
        semat[np.ix_(ids, ids)] = blk
        return (1j * self.retarbiasselfenergy(omega, dofatoms)) \
            * 2 * nB(omega) + self.cleanse(semat)

    def totalkselfenergy(self, omega, T):
        """Sum of both leads' and the bias Keldysh self-energies."""
        out = self.kselfenergy(omega, T, self.dofatomofbath[0]) \
            + self.kselfenergy(omega, T, self.dofatomofbath[1])
        kb = self.kbiasselfenergy(omega, T, self.dofatomofbias)
        return out if np.isscalar(kb) else out + kb

    # ------------------------------------------------------------------
    def _chunks(self, omegas, fn):
        """``fn`` over ``omegas`` on the device in chunks of
        ``batch_size`` rounded up to a multiple of SOLVE_GROUP, the grid
        padded to whole groups with its last frequency; concatenated and
        trimmed (no read-back)."""
        ws = self._omegas(omegas)
        n = ws.shape[0]
        ws = torch.cat([ws, ws[-1:].expand((-n) % SOLVE_GROUP)])
        chunk = -(-max(int(self.batch_size), 1) // SOLVE_GROUP) * SOLVE_GROUP
        return torch.cat([fn(ws[i:i + chunk])
                          for i in range(0, ws.shape[0], chunk)])[:n]

    @staticmethod
    def _grouped(op, a, *rest):
        """``op`` (``solve_ex``/``inv_ex``) on groups of SOLVE_GROUP
        matrices of a, concatenated."""
        return torch.cat([op(a[i:i + SOLVE_GROUP],
                             *(r[i:i + SOLVE_GROUP] for r in rest))[0]
                          for i in range(0, a.shape[0], SOLVE_GROUP)])

    def _unit_columns(self, sel, nw):
        """(nw, nd, nsel) columns of the identity on ``sel``."""
        rhs = torch.zeros((self.nd, sel.shape[0]), dtype=C128,
                          device=self.device)
        rhs[sel, torch.arange(sel.shape[0], device=self.device)] = 1.0
        return rhs.expand(nw, self.nd, sel.shape[0])

    def tm(self, omega):
        """Caroli transmission at one omega (ps^-1)."""
        return float(self._tm_batch([omega])[0])

    def _tm_one(self, ws):
        """Caroli transmission on a chunk of omegas: solve only the G
        columns on the left-bath DOFs, (nw, nd, nL)."""
        selL = self._sel(self.dofatomofbath[0])
        selR = self._sel(self.dofatomofbath[1])
        a = self._amatrix(ws)
        gcols = self._grouped(torch.linalg.solve_ex, a, self._unit_columns(
            selL, ws.shape[0]))
        gl = 2.0 * ws / self.damp                    # Gamma diag value
        grows = gcols[:, selR, :]                    # (nw, nR, nL)
        val = torch.view_as_real(grows).square().sum((-3, -2, -1)) * gl * gl
        # Gamma(0) = 0 => T(0) = 0; also shields the w=0 singular solve
        return torch.where(ws == 0.0, 0.0, val)

    def _tm_batch(self, omegas):
        return self._chunks(omegas, self._tm_one)

    def gettm(self, vector=False, mesh=None, shard_axis=None):
        """Transmission sweep (host (num+1, 2): omega in ps^-1, T)."""
        if mesh is not None:
            raise NotImplementedError(MESH_MESSAGE)
        x = np.linspace(0, self.maxomega, self.intnum + 1)
        tm = host(self._tm_batch(x))
        self.tmnumber = np.column_stack((x, tm))
        if self.write_files:
            np.savetxt("transmission.dat",
                       np.column_stack((x * self.rpc, tm)))
        return self.tmnumber

    # ------------------------------------------------------------------
    def thermalcurrent(self, T, delta):
        """Landauer integral over the stored transmission; nW."""
        x = self.tmnumber[:, 0]
        t = self.tmnumber[:, 1]
        nb = np.asarray(self.bosedist(x, T * (1 + 0.5 * delta)) -
                        self.bosedist(x, T * (1 - 0.5 * delta)))
        f = self.rpc * x / 2 / np.pi * t * nb
        n = len(x) - 1
        if n != self.intnum:
            raise ValueError("Error in number of omega")
        integral = (x[-1] - x[0]) / n / 2.0 * (2 * f.sum() - f[0] - f[-1])
        return integral * 1.60217662e2

    def thermalconductance(self, T, delta):
        return self.thermalcurrent(T, delta) / (T * delta)

    def thermalconductivity(self, T, delta, L, A):
        """L, A in angstrom / angstrom^2 -> W/m-K."""
        return self.thermalconductance(T, delta) * L / A * 10

    # ------------------------------------------------------------------
    def totalkselfenergy_diag_parts(self, omegas, T):
        """Keldysh self-energy: (diag part (nw, nd), bias block or None)."""
        omegas = self._omegas(omegas)
        selL = self._sel(self.dofatomofbath[0])
        selR = self._sel(self.dofatomofbath[1])
        nb = self.bosedist(omegas, T)
        # -2 Im(-i w/damp) * n_B = (2 w / damp) n_B on bath DOFs
        gl = (2.0 * omegas / self.damp) * nb
        base = torch.zeros(self.nd, dtype=torch.float64, device=self.device)
        for sel in (selL, selR):
            base.index_add_(0, sel, torch.ones_like(sel, dtype=base.dtype))
        diag = gl[:, None] * base[None, :]
        blk = None
        if self.isbias and len(self.dofatomofbias):
            blk = self._kbias_block(omegas, T)
        return diag.to(C128), blk

    def _kbias_block(self, omegas, T):
        """Bias Keldysh block."""
        chip = torch.as_tensor(self.chiplus, dtype=C128, device=omegas.device)
        chim = torch.as_tensor(self.chiminus, dtype=C128,
                               device=omegas.device)
        w = omegas[:, None, None]
        nbp = self.bosedist(omegas + self.bias, T)[:, None, None]
        nbm = self.bosedist(omegas - self.bias, T)[:, None, None]
        nb0 = self.bosedist(omegas, T)[:, None, None]
        semat = ((chip - 1j * chim) * (w + self.bias) * (2 * nbp - 2 * nb0)
                 + (chip + 1j * chim) * (w - self.bias)
                 * (2 * nbm - 2 * nb0)) / 2
        retar = self._bias_block(omegas)
        return 1j * retar * 2 * nb0 + semat

    def ps(self, omega, T, atomlist):
        return float(self._ps_batch([omega], T, atomlist)[0])

    def _ps_batch(self, omegas, T, atomlist):
        """Power spectrum: equilibrium branch -2 w^2 n_B Tr Im G^r; bias
        branch w^2 Tr Re[G Sig^K G^a]."""
        sel = self._sel(atomlist, check=False)
        nsel = sel.shape[0]
        cols = torch.arange(nsel, device=self.device)

        def one(w):
            a = self._amatrix(w)
            gcols = self._grouped(torch.linalg.solve_ex, a,
                                  self._unit_columns(sel, w.shape[0]))
            tr = gcols[:, sel, cols].imag.sum(-1)
            val = -2.0 * (w * w) * self.bosedist(w, T) * tr
            return torch.where(w == 0.0, 0.0, val)

        def one_bias(w):
            a = self._amatrix(w)
            # rows of G on sel: G[sel, :] = solve(a^T, I[:, sel])^T
            grows = self._grouped(torch.linalg.solve_ex, a.mT,
                                  self._unit_columns(sel, w.shape[0])).mT
            diag, blk = self.totalkselfenergy_diag_parts(w, T)
            m = grows * diag[:, None, :]                   # G . diag(SigK)
            if blk is not None:
                selB = self._sel(self.dofatomofbias)
                m[:, :, selB] += grows[:, :, selB] @ blk
            val = (m * grows.conj()).real.sum((-2, -1))
            return torch.where(w == 0.0, 0.0, (w * w) * val)

        return self._chunks(omegas, one_bias if self.isbias else one)

    def getps(self, T, maxomega, intnum, atomlist=None, filename=None,
              vector=False, omegalist=None, mesh=None, shard_axis=None):
        """Power-spectrum sweep (host (n, 2): omega in ps^-1, P)."""
        if mesh is not None:
            raise NotImplementedError(MESH_MESSAGE)
        if atomlist is None:
            atomlist = np.arange(self.nd0)[self._keep]
        if omegalist is not None:
            x2 = np.sort(np.asarray(omegalist)) / self.rpc
        else:
            x2 = np.linspace(0, maxomega / self.rpc, intnum + 1)
        ps = host(self._ps_batch(x2, T, atomlist))
        self.psnumber = np.column_stack((x2, ps))
        if self.write_files:
            name = f"powerspectrum.{filename}.{T}.dat" if filename \
                else f"powerspectrum.{T}.dat"
            np.savetxt(name, np.column_stack((x2 * self.rpc, ps)))
        return self.psnumber

    # ------------------------------------------------------------------
    # Lesser/greater Green's-function heat currents (the reference
    # carries these only as a commented-out draft): the Meir-Wingreen
    # lead current J_L = int dw/2pi hbar w Tr[Sig<_L G> - Sig>_L G<]
    # equals the Landauer integral for elastic transport.
    def _less_diag(self, omegas, Tl, sel):
        """Sig< = +i Gamma n_B on the selected POST-DELETION DOFs, as
        (nw, nd) diagonals."""
        gam = torch.zeros((omegas.shape[0], self.nd), dtype=C128,
                          device=omegas.device)
        gam[:, sel] = (2.0 * omegas / self.damp).to(C128)[:, None]
        return 1j * gam * self.bosedist(omegas, Tl)[:, None]

    def _great_diag(self, omegas, Tl, sel):
        """Sig> = -i Gamma (n_B + 1) on the selected POST-DELETION DOFs,
        as (nw, nd) diagonals."""
        gam = torch.zeros((omegas.shape[0], self.nd), dtype=C128,
                          device=omegas.device)
        gam[:, sel] = (2.0 * omegas / self.damp).to(C128)[:, None]
        return -1j * gam * (self.bosedist(omegas, Tl) + 1.0)[:, None]

    # -- reference-named lesser/greater surface (the reference's draft
    # slices G^r but not Sigma, which cannot contract — here the product
    # is formed in the full post-deletion space and THEN restricted to
    # the requested block). ``dofatoms`` are ORIGINAL (pre-deletion) DOF
    # ids, like the retar*selfenergy family.
    def lessselfenergy(self, omega, T, dofatoms):
        """Sig^< = 2i Im Sigma^r n_B."""
        return 2j * np.imag(self.retarselfenergy(omega, dofatoms)) \
            * float(self.bosedist(omega, T))

    def greatselfenergy(self, omega, T, dofatoms):
        """Sig^> = 2i Im Sigma^r (n_B + 1)."""
        return 2j * np.imag(self.retarselfenergy(omega, dofatoms)) \
            * (float(self.bosedist(omega, T)) + 1.0)

    def lessbiasselfenergy(self, omega, T, dofatoms):
        """Bias Sig^< = 2i Im Sigma^r_bias n_B; 0 when unbiased."""
        b = self.retarbiasselfenergy(omega, dofatoms)
        return 0 if np.isscalar(b) else \
            2j * np.imag(b) * float(self.bosedist(omega, T))

    def greatbiasselfenergy(self, omega, T, dofatoms):
        """Bias Sig^> = 2i Im Sigma^r_bias (n_B + 1); 0 when unbiased."""
        b = self.retarbiasselfenergy(omega, dofatoms)
        return 0 if np.isscalar(b) else \
            2j * np.imag(b) * (float(self.bosedist(omega, T)) + 1.0)

    def _gf_sandwich(self, omega, sig, dofatoms):
        """(G^r sig G^a) restricted to the dofatoms block (host)."""
        if np.isscalar(sig):
            n = len(list(dofatoms))
            return np.zeros((n, n), complex)
        g = host(self.retargf(omega))
        ga = host(self.advangf(omega))
        sub = np.asarray(self._bathsel(dofatoms))
        return (g @ np.asarray(sig) @ ga)[np.ix_(sub, sub)]

    def greatgf(self, omega, T, dofatoms):
        """Greater GF block: (G^r Sig^> G^a)[dofatoms]."""
        return self._gf_sandwich(
            omega, self.greatselfenergy(omega, T, dofatoms), dofatoms)

    def lessgf(self, omega, T, dofatoms):
        """Lesser GF block."""
        return self._gf_sandwich(
            omega, self.lessselfenergy(omega, T, dofatoms), dofatoms)

    def greatbiasgf(self, omega, T, dofatoms):
        """Greater GF block from the bias self-energy alone."""
        return self._gf_sandwich(
            omega, self.greatbiasselfenergy(omega, T, dofatoms), dofatoms)

    def lessbiasgf(self, omega, T, dofatoms):
        """Lesser GF block from the bias self-energy alone."""
        return self._gf_sandwich(
            omega, self.lessbiasselfenergy(omega, T, dofatoms), dofatoms)

    def biasthermalcurrent(self, T, dofatoms, num=None):
        """Heat current pumped into the bias region (nW), from the draft's
        integrand Tr[G^>_bias Sig^<_bias - G^< Sig^>_bias]. Zero when no
        bias self-energy is attached."""
        if not self.isbias:
            return 0.0
        num = num or self.intnum
        ws = np.linspace(0, self.maxomega, num + 1)[1:]
        sub = np.asarray(self._bathsel(dofatoms))

        def f(w):
            gg = self.greatbiasgf(w, T, dofatoms)
            sl = self.lessbiasselfenergy(w, T, dofatoms)
            gl = self.lessgf(w, T, dofatoms)
            sg = self.greatbiasselfenergy(w, T, dofatoms)
            val = np.trace(gg @ np.asarray(sl)[np.ix_(sub, sub)]
                           - gl @ np.asarray(sg)[np.ix_(sub, sub)])
            return self.rpc * w / (2 * np.pi) * np.real(val)

        integrand = np.array([f(w) for w in ws])
        return float(np.trapezoid(integrand, ws)) * 1.60217662e2

    def leadthermalcurrent(self, TL, TR, lead="L", num=None):
        """Heat current out of one lead via G lesser/greater (nW).

        Both leads may sit at different temperatures; for this elastic
        model the result equals ``thermalcurrent`` evaluated with the
        same temperatures. Only the diagonals of G^< and G^> are formed:
        diag(G diag(s) G^dag)_i = sum_k |G_ik|^2 s_k.
        """
        num = num or self.intnum
        ws = np.linspace(0, self.maxomega, num + 1)[1:]
        selL = self._sel(self.dofatomofbath[0])
        selR = self._sel(self.dofatomofbath[1])
        sel_lead = selL if lead == "L" else selR
        T_lead = TL if lead == "L" else TR

        def one(w):
            g = self._grouped(torch.linalg.inv_ex, self._amatrix(w))
            g2 = (g * g.conj()).real.to(C128)           # |G_ik|^2
            sl_less = self._less_diag(w, TL, selL) + \
                self._less_diag(w, TR, selR)
            sl_great = self._great_diag(w, TL, selL) + \
                self._great_diag(w, TR, selR)
            g_less = (g2 @ sl_less[:, :, None])[..., 0]
            g_great = (g2 @ sl_great[:, :, None])[..., 0]
            s_less = self._less_diag(w, T_lead, sel_lead)
            s_great = self._great_diag(w, T_lead, sel_lead)
            # Tr[diag(s<) G> - diag(s>) G<]
            val = (s_less * g_great).sum(-1) - (s_great * g_less).sum(-1)
            return val.real

        integrand = host(self._chunks(ws, one))
        f = self.rpc * ws / (2 * np.pi) * integrand
        return float(np.trapezoid(f, ws)) * 1.60217662e2

    def write_v_sim(self, filename="anime.ascii"):
        """v_sim 3.7 phonon-mode file: box, positions, and every eigenmode
        as a #metaData qpt block with mass-unweighted displacement
        vectors."""
        if self.els is None or self.xyz is None or self.boxhi is None:
            raise ValueError("write_v_sim needs els/xyz/box metadata")
        from sclmd_tpu_torch.units import get_atomname
        text = "# Generated file for v_sim 3.7\n"
        text += "%15.9f%15.9f%15.9f\n" % (self.boxhi[0], self.boxlo[2],
                                          self.boxhi[1])
        text += "%15.9f%15.9f%15.9f\n" % (self.boxlo[0], self.boxlo[1],
                                          self.boxhi[2])
        for i in range(len(self.els) // 3):
            text += "%15.9f%15.9f%15.9f %2s\n" % (
                self.xyz[3 * i], self.xyz[3 * i + 1], self.xyz[3 * i + 2],
                get_atomname(self.els[3 * i]))
        for i, a in enumerate(self.omegas):
            text += "#metaData: qpt=[%f;%f;%f;%f \\\n" % (0, 0, 0, a)
            for u in range(len(self.els) // 3):
                text += "#; %f; %f; %f; %f; %f; %f \\\n" % (
                    self.eigvecs[i, 3 * u] / self.els[3 * u] ** 0.5,
                    self.eigvecs[i, 3 * u + 1] / self.els[3 * u] ** 0.5,
                    self.eigvecs[i, 3 * u + 2] / self.els[3 * u] ** 0.5,
                    0, 0, 0)
            text += "# ]\n"
        with open(filename, "w") as fh:
            fh.write(text)

    def plotresult(self, lines=180):
        from matplotlib import pyplot as plt
        plt.figure(0)
        plt.hist(self.omegas, bins=lines)
        plt.xlabel("Frequence(eV)")
        plt.ylabel("Number")
        plt.savefig("omegas.png")
        plt.figure(1)
        plt.plot(self.tmnumber[:, 0] * self.rpc, self.tmnumber[:, 1])
        plt.xlabel("Frequence(eV)")
        plt.ylabel("Transmission")
        plt.savefig("transmission.png")


def landauer_current_natural(omegas, transmission, TL, TR):
    """Landauer heat current in natural units (eV frequencies, hbar=1):
    J = (1/2pi) int dw w T(w) (n_B(w,TL) - n_B(w,TR)), trapezoid rule,
    as a float64 0-d CPU tensor. Multiply by units.CURCOF for nW.
    Companion to the MD heat current for the MD-vs-NEGF cross-check.
    """
    from sclmd_tpu_torch.ops.functions import bose
    w = np.asarray(host(omegas), np.float64)
    tr = np.asarray(host(transmission), np.float64)
    occ = bose(w, TL) - bose(w, TR)
    f = w * tr * occ / (2 * np.pi)
    return torch.trapezoid(torch.as_tensor(f), torch.as_tensor(w))
