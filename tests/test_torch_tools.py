"""The port's workload set-up (``sclmd_tpu_torch.tools``) on the CPU:
the primary junction and the flagship that the card tests build, the
chunks ``RunEnsemble`` runs, and the kernel's tap-major operand. No
JAX."""

import tempfile

import numpy as np
import pytest
import torch

from sclmd_tpu_torch.kernels import gle_block as K1
from sclmd_tpu_torch.tools import chunk_sizes
from sclmd_tpu_torch.tools import primary as P

torch.set_num_threads(2)


@pytest.mark.parametrize("nc,block", [(3, 4), (8, 2), (90, 3)])
def test_tap_major_layout(nc, block):
    kin = torch.randn((nc, (block + 1) * nc), dtype=torch.float64)
    kt = K1.tap_major(kin, block)
    ncs = -(-nc // 4) * 4
    assert kt.shape == (block + 1, ncs, nc)
    for k in range(block + 1):
        assert torch.equal(kt[k, :nc, :], kin[:, k * nc:(k + 1) * nc].T)
    assert not kt[:, nc:, :].any()


def test_primary_block_operands_cpu():
    """The primary junction at its full widths with two trajectories:
    the chunk shapes RunEnsemble runs at 256 and 1024 trajectories under
    the 40 GB budget, and one block of K1's plain twin on its operands."""
    r = P.primary_runner(torch.float32, "cpu", tempfile.mkdtemp())
    system = r._build_system()
    assert chunk_sizes(system, 256, P.NMD, P.BLOCK) == [256]
    assert chunk_sizes(system, 1024, P.NMD, P.BLOCK) == [512, 512]
    gen = torch.Generator().manual_seed(1)
    _, args, corr = P.block_operands(r, 2, 7, gen)
    khat, hhat = corr[0]
    assert khat.shape == (1025, P.NC, P.NC) and hhat.shape == (2, 1025, P.NC)
    out = K1.gle_block(*args)
    assert out.cur.shape == (2, P.BLOCK, 2) and out.etot.shape == (2, P.BLOCK)
    for x in (out.p, out.q, out.cur, out.etot):
        assert torch.isfinite(x).all()


def test_flagship_setup_cpu():
    """The harmonic flagship at its full widths: 603 DOFs, two electron
    baths of 150 DOFs at T (1 +- delta/2), 120 fixed DOFs, and the chunk
    shapes of the plain-path RunEnsemble at 128 and 1024 trajectories
    under the 40 GB budget."""
    from sclmd_tpu_torch.tools import flagship as F
    r = F.flagship_runner(torch.float32, "cpu", tempfile.mkdtemp())
    system = r._build_system()
    assert system.nph == 603 and system.ml == 1 and system.nmd == F.NMD
    assert [b.nc for b in r.baths] == [150, 150]
    assert [b.T for b in r.baths] == [315.0, 285.0]
    assert int((system.mask == 0).sum()) == 120
    assert chunk_sizes(system, 128, F.NMD) == [128]
    assert chunk_sizes(system, 1024, F.NMD) == [1024]
    sw = F.flagship_runner(torch.float32, "cpu", tempfile.mkdtemp(),
                           temps=(285.0, 315.0))
    assert [b.T for b in sw.baths] == [285.0, 315.0]


def test_flagship_bpt_setup_cpu():
    """The flagship's NEGF set-up that the card's check against the
    committed sweep runs: nd 483 after the 120 fixed DOFs, leads of 150
    DOFs, 4,001 points up to 0.45 eV."""
    from sclmd_tpu_torch import units
    from sclmd_tpu_torch.tools import flagship as F
    b = F.flagship_bpt("cpu")
    assert b.nd == 483 and b.intnum + 1 == 4001
    assert [len(g) for g in b.dofatomofbath] == [150, 150]
    assert b.maxomega * units.RPC == pytest.approx(0.45)
    assert b._D.device.type == "cpu" and b._D.shape == (483, 483)


def test_bias_stability_growth_rate():
    """``tools.bias_stability.growth_rate`` on a 4-atom chain split as the
    flagship is (fixed ends, one lead atom a side, one centre atom): a
    stable chain decays, a negative stiffness in the centre grows, and a
    centre friction damps faster."""
    from sclmd_tpu_torch.models.harmonic import chain_dynmat
    from sclmd_tpu_torch.tools.bias_stability import growth_rate
    dyn = np.asarray(chain_dynmat(15, 0.04))
    part = {"fixdofs": [0, 1, 2, 12, 13, 14], "ecatsl": [3, 4, 5],
            "ecatsr": [9, 10, 11], "device": np.array([2])}
    z = np.zeros((3, 3))
    bare = growth_rate(dyn, part)
    assert bare < 0.0
    # the force bias (xim - zeta1) q: a negative zeta1 softens
    soft = growth_rate(dyn, part, (z, z, -np.eye(3) * 0.2, z), bias=1.0)
    assert soft > 0.0
    damped = growth_rate(dyn, part, (np.eye(3) * 0.05, z, z, z))
    assert damped < bare
