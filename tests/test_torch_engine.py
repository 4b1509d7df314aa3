"""The port's synchronous round engines against the reference.

The reference JAX ``engine.run_dfl`` and the port's ``run_dfl`` and
``run_dfl_fused`` run on the CPU from the same seeds and the same JAX
initialisation (carried across by ``convert.params_from_jax``), at W = 8
for 8 rounds, for D-PSGD, LD-SGD and FedHP with and without churn, and
PENS without.

Host-side record fields (times, taus, links) must be exactly equal: the
host control plane is a numpy copy and FedHP/PENS close the loop through
device measurements, so any plan the port decided differently would show
here. Device metrics differ by float summation order across frameworks:
accuracy within one eval sample of one worker (1/512), loss within 1e-4
relative, consensus within 1e-4 relative (plus 1e-6 absolute — after a
full-graph mix the consensus distance is f32 noise around 0). Worst case
measured over these cases: accuracy 3.3e-4 absolute (one eval sample of
one of six alive workers, dpsgd with churn, reference engine), loss
3.0e-6 relative (same run), consensus 4.2e-6 relative (same run) and
3.5e-7 absolute where it is noise around 0 (fedhp, fused engine).

PENS through the fused engine replays the reference's plans: after the
reference's mix ``x <- W x`` two workers with equal rows of W hold
bit-identical models, so PENS's cross-loss rows carry exact ties that
its argsort breaks by position; the fused formula x + sum_j w_ij
(x_j - x_i) breaks those ties by rounding noise instead (the reference's
own fused engine has the same hazard). The port's own PENS strategy
runs through the reference engine, and its plans are held against the
reference's in tests/test_torch_host.py.
"""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import DATA_KW, port_config, run_port, run_reference
from repro_torch.core import engine
from repro_torch.core.experiment import run_algorithm, setup_experiment
from repro_torch.launch.mesh import make_worker_mesh

EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time")
ACC_ATOL = 1.0 / 512
REL_TOL = 1e-4
CONSENSUS_ATOL = 1e-6

CASES = [("dpsgd", False), ("dpsgd", True), ("ldsgd", False),
         ("ldsgd", True), ("fedhp", False), ("fedhp", True),
         ("pens", False)]
REPLAY = {("pens", "fused")}

_reference_runs: dict = {}


def _reference(algo, churn):
    if (algo, churn) not in _reference_runs:
        _reference_runs[(algo, churn)] = run_reference(algo, churn)
    return _reference_runs[(algo, churn)]


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
@pytest.mark.parametrize("algo,churn", CASES,
                         ids=[f"{a}-{'churn' if c else 'nochurn'}"
                              for a, c in CASES])
def test_port_matches_reference(algo, churn, engine_name):
    h_ref, recorded = _reference(algo, churn)
    replay = recorded if (algo, engine_name) in REPLAY else None
    h_port = run_port(algo, churn, engine_name, replay=replay)
    assert len(h_ref.records) == len(h_port.records)
    a, b = h_ref.as_arrays(), h_port.as_arrays()
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_ATOL)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=REL_TOL)
    np.testing.assert_allclose(a["consensus"], b["consensus"],
                               rtol=REL_TOL, atol=CONSENSUS_ATOL)
    final = h_port.final_params
    assert final["w1"].shape == (8, 32, 64)
    assert all(bool(torch.isfinite(v).all()) for v in final.values())


@pytest.mark.parametrize("fused", [False, True], ids=["reference", "fused"])
def test_run_algorithm_on_cpu_learns(fused):
    """The user's entry point, with the port's own init, on the CPU."""
    h = run_algorithm("dpsgd", port_config(), rounds=4, device="cpu",
                      fused=fused, **DATA_KW)
    arr = h.as_arrays()
    assert np.isfinite(arr["loss"]).all()
    assert arr["accuracy"][-1] > arr["accuracy"][0] > 0.2


def _remat_block_through_an_adapter(cfg):
    """A registry model built from a ModelConfig with an activation-
    checkpoint policy, handed to the engine as ``adapter=``."""
    from dataclasses import replace as dc_replace

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import modelspec
    from repro_torch.core.algorithms import make_strategy
    from repro_torch.core.topology import make_base_topology
    model = dc_replace(get_smoke_config("smollm-360m"), remat="block")
    # 4 workers, as the LM cases below: the measurement stack is W x W
    cfg = dc_replace(cfg, model="dense:d=16", num_workers=4)
    train, tx, ty, shards, cluster = setup_experiment(cfg, device="cpu")
    strategy = make_strategy(cfg, make_base_topology(
        cfg.num_workers, cfg.base_topology, cfg.seed))
    return engine.run_dfl(train, tx, ty, shards, cluster, cfg, strategy,
                          rounds=2,
                          adapter=modelspec.RegistryAdapter(model, 16, 8,
                                                            "remat"),
                          device="cpu")


# (algorithm, config fields, what the call does): the reference's
# ValueError (and its message) where the reference refuses too, None where
# it now runs (the per-leaf codec maps, the moe and hybrid families,
# remat="block" and sharded execution, ported since these cases were
# written)
@pytest.mark.parametrize("algo,fields,expect", [
    ("dpsgd", dict(compress="leafmap:default=int8"), None),
    ("dpsgd", dict(gossip="sparse", compress="leafmap:default=int8"), None),
    ("dpsgd", dict(gossip="sparse", sharded=True), None),
    ("dpsgd", dict(sharded=True), None),
    ("dpsgd", dict(model="moe:d=16", num_workers=4), None),
    ("dpsgd", dict(robust="median", model="hybrid:d=32", num_workers=4),
     None),
    ("dpsgd", None, None),
    ("adpsgd", dict(robust="screen:3", compress="leafmap:default=int8"),
     (ValueError, "synchronous-engine only")),
    ("dpsgd", dict(sharded=True, compress="leafmap:default=int8"),
     (ValueError, "leaf"))],
    ids=["compress-leafmap", "gossip-sparse-compress-leafmap",
         "gossip-sparse-sharded", "sharded-True", "model-moe",
         "robust-median-model-hybrid", "remat-block-adapter",
         "adpsgd-robust-screen-leafmap", "sharded-compress-leafmap"])
def test_unported_options_raise(algo, fields, expect):
    """``fields`` None: remat="block" through an adapter, which runs. A
    leafmap, a moe model and a hybrid one under the median run on both
    synchronous engines (the two LMs on 4 workers, whose measurement
    stack is a quarter of 8's; the hybrid at d 32: its Mamba2 heads are
    64 wide, and at d 16 the reference cannot reshape its 32 inner
    channels either), and so does ``cfg.sharded`` (one CPU shard, the
    default mesh with ``device="cpu"``); AD-PSGD refuses a leafmap and the
    sharded path a leafmap, with the reference's ValueErrors."""
    if expect is None and fields is None:
        h = _remat_block_through_an_adapter(port_config())
        assert len(h.records) == 2
        assert np.isfinite(h.as_arrays()["loss"]).all()
        return
    if expect is None:
        for fused in (False, True):
            h = run_algorithm(algo, port_config(**fields), rounds=2,
                              fused=fused, device="cpu")
            assert len(h.records) == 2
            assert np.isfinite(h.as_arrays()["loss"]).all()
        return
    exc, match = expect
    with pytest.raises(exc, match=match):
        run_algorithm(algo, port_config(**fields), rounds=2, device="cpu")


@pytest.mark.parametrize("kw", [dict(seeds=[0, 1]), dict(mesh=True)],
                         ids=["seeds", "mesh"])
def test_unported_arguments_raise(kw):
    """Both arguments are ported since these cases were written: ``seeds``
    returns one History per lane, a ``mesh`` (here one CPU shard) runs the
    sharded path."""
    if "seeds" in kw:
        hists = run_algorithm("dpsgd", port_config(), rounds=2, fused=True,
                              device="cpu", **kw)
        assert len(hists) == 2 and all(len(h.records) == 2 for h in hists)
        return
    h = run_algorithm("dpsgd", port_config(), rounds=2, fused=True,
                      device="cpu", mesh=make_worker_mesh(devices=["cpu"]))
    assert len(h.records) == 2
    assert np.isfinite(h.as_arrays()["loss"]).all()


@pytest.mark.parametrize("entry", ["run_algorithm", "setup_experiment",
                                   "resolve_device"])
def test_default_device_needs_a_gpu(entry):
    """``device=None`` means the GPU: without one it raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    call = {"run_algorithm": lambda: run_algorithm("dpsgd", port_config(),
                                                   rounds=1),
            "setup_experiment": lambda: setup_experiment(port_config()),
            "resolve_device": lambda: engine.resolve_device(None)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


_ROOT = Path(__file__).resolve().parents[1]
_PORT_FILES = sorted((_ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [_ROOT / "chip_smoke.py", _ROOT / "tools" / "kernel_ab.py"]


@pytest.mark.parametrize("path", _PORT_FILES,
                         ids=[str(p.relative_to(_ROOT)) for p in _PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    """No module of the port, and neither chip_smoke.py nor
    tools/kernel_ab.py, imports jax or the reference package ``repro``
    (statically, anywhere in the file)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"
