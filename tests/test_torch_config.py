"""The port's configuration layer (``sclmd_tpu_torch.utils.config``) and
profiling tools (``sclmd_tpu_torch.utils.profiling``) against the JAX
package's: one JSON file builds both packages' runners with the same
dynamical matrix, bath matrices and noise factors (float64, within
1e-12 of the largest magnitude), the JSON round trip and the validation
errors are the same, and the tracer reports the same keys.
"""

import json

import numpy as np
import pytest
import torch

from sclmd_tpu.utils import config as JC
from sclmd_tpu.utils import profiling as JP

from sclmd_tpu_torch.utils import config as TC
from sclmd_tpu_torch.utils import profiling as TP

CPU = "cpu"


def close(got, want, tol=1e-12):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale


def _json(tmp_path, **kw):
    from sclmd_tpu_torch.utils.io import WritewbLambda
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 3))
    WritewbLambda(str(tmp_path / "wb.npz"), a @ a.T * 1e-3 + np.eye(3) * 1e-3,
                  *(rng.normal(size=(3, 3)) * 1e-4 for _ in range(4)))
    d = dict(dt=0.4, nmd=64, T=300.0, nstop=1, dtype="float64",
             outdir=str(tmp_path), constraints=[[9, 10, 11]],
             baths=[dict(kind="electron", cats=[0, 1, 2], T=310.0,
                         wmax=1.0, nw=100, efric_scale=0.01),
                    dict(kind="electron", cats=[3, 4, 5], T=300.0,
                         wmax=1.0, nw=100, bias=0.3,
                         matrices_file=str(tmp_path / "wb.npz")),
                    dict(kind="phonon", cats=[6, 7, 8], T=290.0,
                         debye=0.05, nw=50, ml=8)])
    d.update(kw)
    return json.dumps(d)


def test_one_json_builds_both_runners(tmp_path):
    from sclmd_tpu.models.harmonic import chain_dynmat
    src = _json(tmp_path)
    tcfg, jcfg = TC.MDConfig.from_json(src), JC.MDConfig.from_json(src)
    assert TC.MDConfig.to_json(tcfg) == JC.MDConfig.to_json(jcfg)
    axyz = [["C", 1.5 * i, 0.0, 0.0] for i in range(4)]
    dyn = np.asarray(chain_dynmat(12, 0.05))
    tr = tcfg.build(axyz=axyz, dyn=dyn, device=CPU)
    jr = jcfg.build(axyz=axyz, dyn=dyn)
    close(tr.dyn, jr.dyn)
    assert len(tr.baths) == len(jr.baths) == 3
    for tb, jb in zip(tr.baths, jr.baths):
        np.testing.assert_array_equal(tb.cids, np.asarray(jb.cids))
        assert float(tb.T) == float(jb.T)
        names = ("efric", "exim", "exip", "zeta1", "zeta2") \
            if hasattr(jb, "efric") else ("kernel",)
        for k in names:
            close(getattr(tb, k), getattr(jb, k))
        close(tb.nstd, jb.nstd, 1e-10)
    assert tr.baths[1].bias_terms and jr.baths[1].bias_terms
    assert tr.constraint is not None
    tr.Run()
    assert (tmp_path / "kappa.300.bath2.run0.dat").exists()
    assert np.allclose(tr.state.q[..., 9:12].numpy(), 0.0)


def test_named_driver_builds_the_same_dyn(tmp_path):
    kw = dict(driver="pair",
              driver_kwargs={"kind": "morse", "cutoff": 4.0,
                             "params": {"D": 2.0, "alpha": 1.8,
                                        "r0": 1.5}})
    src = _json(tmp_path, **kw)
    axyz = [["C", 1.5 * i, 0.1 * i, 0.0] for i in range(4)]
    tr = TC.MDConfig.from_json(src).build(axyz=axyz, device=CPU)
    jr = JC.MDConfig.from_json(src).build(axyz=axyz)
    assert tr.pforce is not None
    close(tr.dyn, jr.dyn, 1e-10)


def test_json_round_trip(tmp_path):
    cfg = TC.MDConfig.from_json(_json(tmp_path))
    p = str(tmp_path / "run.json")
    cfg.to_json(p)
    back = TC.MDConfig.from_json(p)
    assert back == cfg
    assert back.baths[1].matrices_file.endswith("wb.npz")
    assert JC.MDConfig.from_json(p).to_json() == cfg.to_json()


@pytest.mark.parametrize("bad", [
    dict(dt=-1.0), dict(nmd=65, npie=2), dict(nstart=2, nstop=1),
    dict(dtype="float16"), dict(driver="rebo"),
    dict(baths=[dict(kind="electron", cats=[0], T=300.0)]),
    dict(baths=[dict(kind="weird", cats=[0], T=300.0)]),
    dict(baths=[dict(kind="phonon", cats=[0], T=300.0)]),
    dict(baths=[dict(kind="electron", cats=[], T=300.0, efric_scale=1.0)]),
    dict(baths=[dict(kind="electron", cats=[0], T=-1.0, efric_scale=1.0)]),
])
def test_validation_errors(tmp_path, bad):
    src = _json(tmp_path, **bad)
    msgs = []
    for mod in (TC, JC):
        with pytest.raises(ValueError) as e:
            mod.MDConfig.from_json(src)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_native_and_nnp_raise(tmp_path):
    axyz = [["C", 1.5 * i, 0.0, 0.0] for i in range(2)]
    cfg = TC.MDConfig.from_json(_json(tmp_path, driver="native"))
    with pytest.raises(NotImplementedError, match="item 5"):
        cfg.build(axyz=axyz, device=CPU)
    cfg = TC.MDConfig.from_json(_json(tmp_path, driver="nnp"))
    with pytest.raises(ValueError, match="driver_obj"):
        cfg.build(axyz=axyz, device=CPU)
    with pytest.raises(ValueError, match="axyz"):
        TC.MDConfig.from_json(_json(tmp_path, driver="sw")).build(
            device=CPU)


def test_tracer_report_and_json(tmp_path):
    reports = []
    for mod in (TP, JP):
        tr = mod.Tracer()
        with tr.section("outer"):
            with tr.section("inner"):
                pass
            with tr.section("inner"):
                pass
        f = tr.wrap("wrapped", lambda x: x + 1, sync_result=False)
        assert f(1) == 2
        d = json.loads(tr.to_json(str(tmp_path / "t.json")))
        assert set(d) == {"outer", "outer/inner", "wrapped"}
        assert d["outer/inner"]["calls"] == 2
        assert set(d["outer"]) == {"calls", "seconds"}
        reports.append(tr.report(sort_by_time=False).splitlines())
        # sorted by time: each row's seconds at most the row above's
        secs = [float(line.split()[2])
                for line in tr.report().splitlines()[1:]]
        assert secs == sorted(secs, reverse=True)
    assert len(reports[0]) == len(reports[1]) == 4
    for a, b in zip(*reports):
        assert a.split()[:2] == b.split()[:2]
    assert TP.Tracer().wrap("x", lambda: torch.ones(2))().sum() == 2


def test_cost_tools():
    for args in ((300, 2, 90, 1000), (603, 3, 150, 1), (10, 1, 4, 3)):
        assert TP.flops_estimate_gle_step(*args) == \
            JP.flops_estimate_gle_step(*args)
    a, b = torch.ones(16, 32, dtype=torch.float64), \
        torch.ones(32, 8, dtype=torch.float64)
    cost = TP.compiled_cost(torch.matmul, a, b)
    assert cost == {"flops": 2 * 16 * 32 * 8, "bytes accessed": None}


def test_device_trace(tmp_path):
    with TP.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert len(prof.key_averages()) > 0
