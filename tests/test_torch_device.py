"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: without a card a default device raises, and ``device="cpu"``
builds on the CPU. The card is hidden with a monkeypatched
``torch.cuda.is_available``, so this runs the same with or without one.
"""

import numpy as np
import pytest
import torch

from sclmd_tpu_torch import baths as TB
from sclmd_tpu_torch import convert
from sclmd_tpu_torch import md as TMD
from sclmd_tpu_torch import resolve_device
from sclmd_tpu_torch.models.eam import EAMDriver
from sclmd_tpu_torch.models.harmonic import HarmonicDriver, chain_dynmat
from sclmd_tpu_torch.models.sw import SWDriver
from sclmd_tpu_torch.negf import bpt
from sclmd_tpu_torch.selfenergy import sig, surface_gf

DYN = chain_dynmat(6, 0.05).numpy()
GWL = np.linspace(0.0, 0.6, 8)
GAM = np.array([np.eye(2) * 0.02 * np.exp(-(w / 0.3) ** 2) for w in GWL])

ENTRY_POINTS = {
    "md": lambda **kw: TMD.md(0.4, 16, 300.0, dyn=DYN, **kw),
    "phbath": lambda **kw: TB.phbath(300.0, range(2), 0.3, 8, 0.4, 16, ml=4,
                                     gamma=GAM, gwl=GWL, **kw),
    "ebath": lambda **kw: TB.ebath(range(2), 300.0, 0.4, 16, wmax=1.0,
                                   efric=np.eye(2) / 60.0, **kw),
    "set_dyn": lambda **kw: TMD.set_dyn(DYN, **kw),
    "harmonic": lambda **kw: HarmonicDriver(DYN, **kw),
    "sw": lambda **kw: SWDriver([["Si", 0.0, 0.0, 0.0],
                                 ["Si", 2.35, 0.0, 0.0]], **kw),
    "eam": lambda **kw: EAMDriver([["Au", 0.0, 0.0, 0.0],
                                   ["Au", 2.88, 0.0, 0.0]], **kw),
    "bpt": lambda **kw: bpt(DYN, 0.5, 20.0, [[0], [5]], num=4, **kw),
    "sig": lambda **kw: sig(DYN + 2 * np.eye(6), 0.5, [2, 3], [4, 5], num=4,
                            eta=1e-2, **kw),
    "surface_gf": lambda **kw: surface_gf(
        [0.1, 0.2], np.eye(2) * 0.2, np.eye(2) * 0.2, -np.eye(2) * 0.1,
        **kw),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_on_request(no_card, name):
    built = ENTRY_POINTS[name](device="cpu")
    tensors = {
        "md": lambda r: [r.dyn],
        "phbath": lambda b: [b.kernel],
        "ebath": lambda b: [b.efric, b.zeta2],
        "set_dyn": lambda t: list(t),
        "harmonic": lambda h: [h.dyn, h.f0],
        "sw": lambda d: [d.f0],
        "eam": lambda d: [d.f0],
        "bpt": lambda b: [b._D, b.retargf(0.1)],
        "sig": lambda m: [m.sgf(0.1, "L")],
        "surface_gf": lambda out: list(out),
    }[name](built)
    assert all(t.device.type == "cpu" for t in tensors)
    if name == "md":
        assert built.device == torch.device("cpu")


@pytest.mark.parametrize("fn", [convert.from_jax_bath,
                                convert.from_jax_system])
def test_convert_default_device_raises_without_a_card(no_card, fn):
    with pytest.raises(RuntimeError, match="CUDA card"):
        fn(object())


def test_resolve_device(no_card, monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 0)
