"""Post-processing and analysis utilities (counterpart of
``sclmd_tpu.utils.tools``; host numpy only).

Heat-flux aggregation (``calHF``) and thermal conductance (``calTC``)
over the kappa.T.bathI.runJ.dat files ``md.RunEnsemble``/``md.Run``
write, force-difference statistics (``avdf``), negative-eigenvalue
repair (``eff``), and trajectory analytics on the .ani frames of
``md.SaveTraj``. The outputs and files are the JAX package's.
"""

from __future__ import annotations

import fnmatch
import os
import re

import numpy as np

from sclmd_tpu_torch.units import get_atomname, get_atommass  # re-export

_KAPPA = re.compile(r"\.bath([0-9]+)\.run([0-9]+)\.dat$")


def _read_kappa_table(workdir=".", bathnum=2):
    """Collect kappa.T.bathN.runJ.dat files into (bathnum, nrun) array.

    One listing of ``workdir``; each (bath, run) takes the first name in
    the listing's order that the pattern ``kappa.{int(T)}*.bath{i}.run{j}
    .dat`` matches, as one glob per file would."""
    names = os.listdir(workdir)
    first = fnmatch.filter(names, "kappa.*.bath0.run0.dat")
    if not first:
        raise FileNotFoundError("no kappa.*.bath0.run0.dat found")
    with open(os.path.join(workdir, first[0])) as f:
        temperature = float(f.readline().split()[1])
    times = len(fnmatch.filter(names, "kappa.*.bath0.run*.dat"))
    prefix = f"kappa.{int(temperature)}"
    table = {}
    for name in names:
        m = _KAPPA.search(name)
        if m and name.startswith(prefix) and \
                len(name) - len(m.group(0)) >= len(prefix):
            table.setdefault(m.groups(), name)
    kb = np.empty((bathnum, times))
    for i in range(bathnum):
        for j in range(times):
            hit = table.get((str(i), str(j)))
            if hit is None:
                raise FileNotFoundError(os.path.join(
                    workdir, f"{prefix}*.bath{i}.run{j}.dat"))
            with open(os.path.join(workdir, hit)) as f:
                kb[i][j] = float(f.readline().split()[2])
    return temperature, kb


def calHF(dlist=1, bathnum=2, workdir="."):
    """Running-average heat flux per bath -> heatflux.T.dat
    (tools.py:132-163)."""
    temperature, kb = _read_kappa_table(workdir, bathnum)
    drop = list(range(dlist))
    kept = np.delete(kb, drop, axis=1)
    balance = np.empty_like(kept)
    for i in range(kept.shape[0]):
        for j in range(kept.shape[1]):
            balance[i][j] = np.mean(kept[i][: j + 1])
    out = os.path.join(workdir, f"heatflux.{int(temperature)}.dat")
    np.savetxt(out, balance.T)
    return balance


def calTC(delta, dlist=1, bathnum=2, L=None, A=None, workdir="."):
    """Thermal conductance from the kappa files (tools.py:166-215).

    2-bath: kappa = (J0 - J1) / (2 delta T); 3-bath adds the biased
    center bath: (J0 + J1 - J2) / (4 delta T). Writes
    thermalconductance.T.dat (+ conductivity when L, A given) and the
    zero-delta heat-flux-between-baths file.
    """
    temperature, kb = _read_kappa_table(workdir, bathnum)
    drop = list(range(dlist))
    result = {}
    if delta != 0:
        if bathnum == 2:
            kappa = (kb[0] - kb[1]) / 2 / (delta * temperature)
        elif bathnum == 3:
            kappa = (kb[0] + kb[1] - kb[2]) / 4 / (delta * temperature)
        else:
            raise ValueError("bathnum must be 2 or 3")
        kappa = np.delete(kappa, drop)
        np.savetxt(os.path.join(
            workdir, f"thermalconductance.{int(temperature)}.dat"),
            (np.mean(kappa), np.std(kappa)), header="Mean(nW/K) Std(nW/K)")
        result["conductance"] = (np.mean(kappa), np.std(kappa))
        if L is not None and A is not None:
            v = kappa * L / A * 10
            np.savetxt(os.path.join(
                workdir, f"thermalconductivity.{int(temperature)}.dat"),
                (np.mean(v), np.std(v)), header="Mean(W/m-K) Std(W/m-K)")
            result["conductivity"] = (np.mean(v), np.std(v))

    if bathnum == 2:
        flux = (kb[0] - kb[1]) / 2
    else:
        flux = -(kb[0] + kb[1] - kb[2]) / 4
    flux = np.delete(flux, drop)
    np.savetxt(os.path.join(
        workdir, f"heatflux-between-baths.{int(temperature)}.dat"),
        (np.mean(flux), np.std(flux)), header="Mean(nW) Std(nW)")
    result["flux"] = (np.mean(flux), np.std(flux))
    return result


def avdf(dffiles=("deltaforce.run0.npy",), outputname="deltaforce",
         use_abs=False, workdir="."):
    """Variance analysis of potential-minus-harmonic force records
    (tools.py:7-32)."""
    def f(x):
        return np.abs(x) if use_abs else x

    dflist = np.load(os.path.join(workdir, dffiles[0]))
    deltatime = len(dflist)
    for fn in dffiles[1:]:
        dflist = np.concatenate(
            (dflist, np.load(os.path.join(workdir, fn))), axis=0)
    for i in range(len(dffiles)):
        seg = f(dflist[: (i + 1) * deltatime])
        mean = np.mean(seg, axis=0)
        np.savetxt(os.path.join(workdir, f"{outputname}-mean{i}.dat"), mean)
        np.savetxt(os.path.join(workdir, f"{outputname}-deviation{i}.dat"),
                   np.sqrt(np.mean((seg - mean) ** 2, axis=0)))


def eff(dynmatfilename="dynmat.dat", workdir="."):
    """Eliminate false (negative) frequencies from a dynmat file
    (tools.py:240-259): iteratively zero negative eigenvalues and
    re-symmetrise until positive semidefinite."""
    path = os.path.join(workdir, dynmatfilename)
    dat = np.loadtxt(path)
    n = int(3 * np.sqrt(len(dat) / 3)) if dat.ndim == 1 else len(dat)
    dynmat = dat.reshape((n, n)) if dat.ndim == 1 else dat
    dynmat = (dynmat + dynmat.T) / 2
    eigvals, eigvecs = np.linalg.eigh(dynmat)
    while not (eigvals >= 0).all():
        eigvals = np.clip(eigvals, 0, None)
        dynmat = eigvecs @ np.diag(eigvals) @ np.linalg.inv(eigvecs)
        dynmat = (dynmat + dynmat.T) / 2
        eigvals, eigvecs = np.linalg.eigh(dynmat)
    np.savetxt(os.path.join(workdir, "mod" + os.path.basename(path)),
               dynmat)
    return dynmat


# ---------------------------------------------------------------------------
# Trajectory-file analytics (.ani frames written by md.SaveTraj)
# ---------------------------------------------------------------------------
def read_ani(trajfile, with_forces=True):
    """Parse an .ani trajectory into (elements, positions (nf, na, 3),
    forces (nf, na, 3) or None)."""
    frames, forces, els = [], [], None
    with open(trajfile) as fh:
        lines = fh.read().split("\n")
    i = 0
    while i < len(lines) and lines[i].strip():
        na = int(lines[i].split()[0])
        rows = [lines[i + 2 + k].split() for k in range(na)]
        if els is None:
            els = [r[0] for r in rows]
        xyz = np.array([[float(v) for v in r[1:4]] for r in rows])
        frames.append(xyz)
        if with_forces and len(rows[0]) >= 7:
            forces.append(np.array([[float(v) for v in r[4:7]]
                                    for r in rows]))
        i += 2 + na
    return els, np.array(frames), (np.array(forces) if forces else None)


def dumpavetraj(trajectoriesfiles, outputname="avestructure.dat",
                workdir="."):
    """Average atomic positions over trajectory files (tools.py:70-100),
    written as an xyz-style text file."""
    alltraj = []
    els = None
    for tf in trajectoriesfiles:
        els, pos, _ = read_ani(os.path.join(workdir, tf))
        alltraj.append(pos.mean(axis=0))
    ave = np.mean(alltraj, axis=0)
    out = os.path.join(workdir, outputname)
    with open(out, "w") as fh:
        fh.write(f"{len(els)}\naverage structure\n")
        for e, (x, y, z) in zip(els, ave):
            fh.write(f"{e}    {x}   {y}   {z}\n")
    return ave


def dumpdisp(refpositions, trajectoriesfiles, index=(1,),
             outputname="dispstructure", workdir="."):
    """Export the index-th largest-displacement frames (tools.py:35-67)."""
    ref = np.asarray(refpositions)
    frames = []
    els = None
    for tf in trajectoriesfiles:
        els, pos, _ = read_ani(os.path.join(workdir, tf))
        frames.extend(pos)
    frames = np.array(frames)
    disp = ((frames - ref[None]) ** 2).sum(axis=(1, 2))
    order = np.argsort(disp)
    out = []
    for i in index:
        sel = frames[order[-i]]
        path = os.path.join(workdir, f"{outputname}.{i}.dat")
        with open(path, "w") as fh:
            fh.write(f"{len(els)}\ndisplacement rank {i}\n")
            for e, (x, y, z) in zip(els, sel):
                fh.write(f"{e}    {x}   {y}   {z}\n")
        out.append(sel)
    return out


def visualtrain(infile, outfile="lcurve.png", workdir="."):
    """Plot training loss curves from a whitespace table with named
    columns (tools.py:278-295); matplotlib gated."""
    data = np.genfromtxt(os.path.join(workdir, infile), names=True)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as exc:  # pragma: no cover
        raise ImportError("visualtrain needs matplotlib") from exc
    for name in data.dtype.names[1:]:
        plt.plot(data[data.dtype.names[0]], data[name], label=name)
    plt.legend()
    plt.xlabel("Step")
    plt.ylabel("Loss")
    plt.xscale("symlog")
    plt.yscale("symlog")
    plt.grid()
    path = os.path.join(workdir, outfile)
    plt.savefig(path)
    plt.close()
    return path


def dumpke(timestep, trajectoriesfiles, atommass, workdir="."):
    """Kinetic-energy distribution from finite-difference velocities
    (tools.py:102-130). timestep in fs; positions in angstrom."""
    atommass = np.asarray(atommass) * 1.6606   # ~1e-27 kg scaled
    ke = []
    for tf in trajectoriesfiles:
        els, pos, _ = read_ani(os.path.join(workdir, tf))
        # element symbols -> per-atom masses by type table index
        mass = np.array([atommass[min(int(i), len(atommass) - 1)]
                         if str(i).isdigit()
                         else get_atommass(i) * 1.6606 for i in els])
        vel = (pos[1:] - pos[:-1]) / timestep
        ss = (vel ** 2).sum(axis=2).mean(axis=0)
        ke.append(0.5 * mass * ss)
    ke = np.array(ke) * 6.24150913e1
    np.savetxt(os.path.join(workdir, "kineticenergy.dat"), ke,
               header="Kinetic Energy(eV), MD Times")
    np.savetxt(os.path.join(workdir, "kineticenergyaverage.dat"),
               ke.mean(axis=0), header="Kinetic Energy(eV)")
    return ke


def predeepmd(infile, fmt, outfile="deepmd_data", size=5):
    """dpdata-based DeepMD training-data prep (tools.py:262-276): load a
    labelled trajectory, write deepmd npy train/validation splits.

    dpdata is optional and its import is gated. (The JAX package's
    native alternative, ``prepare_nnp_data``, comes to this package with
    queue 1 item 5, the NNP driver.)
    """
    try:
        import dpdata  # gated
    except ImportError as e:
        raise ImportError(
            "predeepmd needs dpdata, which is not installed") from e
    data = dpdata.LabeledSystem(infile, fmt=fmt)
    idx = np.random.choice(len(data), size=size, replace=False)
    val = data.sub_system(idx)
    trn = data.sub_system([i for i in range(len(data)) if i not in idx])
    trn.to_deepmd_npy(os.path.join(outfile, "training_data"))
    val.to_deepmd_npy(os.path.join(outfile, "validation_data"))
    return len(trn), len(val)
