"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), on one on-disk format: a bf16 round
trip bit for bit; a checkpoint the reference writes loads in the port,
and the reverse, bit for bit, under ``convert``'s key map (the port's
``"/"`` names are the reference's tree paths); the shape and dtype
checks; retention (keep 2 of 5); ``elastic_reshard`` as the reference's;
and save -> load -> resume: the port's ``run_dfl(init_params=...)`` from
a saved fleet of a bf16 registry LM, whose round-0 consensus is the
saved fleet's spread moved by one round, not a fresh start's (the
reference's ``tests/test_modelspec.py`` case).
"""
from __future__ import annotations

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DATA_KW, port_config
from repro.checkpoint import store as jax_store
from repro_torch.checkpoint import store
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import engine, modelspec
from repro_torch.core.algorithms import make_strategy
from repro_torch.core.experiment import setup_experiment
from repro_torch.core.topology import make_base_topology

torch.set_num_threads(1)


def _state(seed: int = 0) -> dict:
    """A worker-stacked bf16 + f32 + int state, flat port names."""
    gen = torch.Generator().manual_seed(seed)
    return {"blocks/attn/wq": torch.randn(4, 2, 8, 8, generator=gen)
            .to(torch.bfloat16),
            "embed": torch.randn(4, 16, 8, generator=gen)
            .to(torch.bfloat16),
            "mamba/a_log": torch.randn(4, 3, generator=gen),
            "steps": torch.arange(4, dtype=torch.int32)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_bf16_round_trip_is_bit_exact(tmp_path):
    state = _state()
    store.save_checkpoint(str(tmp_path), 7, state, meta={"note": "x"})
    loaded, meta = store.load_checkpoint(str(tmp_path), state)
    assert meta == {"step": 7, "note": "x"}
    for k, v in state.items():
        assert loaded[k].dtype == v.dtype and loaded[k].shape == v.shape
        np.testing.assert_array_equal(_bits(loaded[k]), _bits(v))
    with open(tmp_path / "step_00000007" / "meta.json") as f:
        names = json.load(f)["_leaf_dtypes"]
    assert names["embed"] == "bfloat16" and names["steps"] == "int32"
    with np.load(tmp_path / "step_00000007" / "state.npz") as z:
        assert z["embed"].dtype == np.uint16


def _jax_tree(state: dict):
    """The port's flat state as the reference's nested pytree (bf16
    through f32, exact)."""
    out = {}
    for name, v in state.items():
        *parents, leaf = name.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        dt = jnp.bfloat16 if v.dtype == torch.bfloat16 else None
        arr = jnp.asarray(v.float().numpy() if dt else v.numpy())
        node[leaf] = arr.astype(dt) if dt else arr
    return out


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    state = _state(1)
    jax_store.save_checkpoint(str(tmp_path), 3, _jax_tree(state))
    loaded, meta = store.load_checkpoint(str(tmp_path), state)
    assert meta["step"] == 3
    for k, v in state.items():
        assert loaded[k].dtype == v.dtype
        np.testing.assert_array_equal(_bits(loaded[k]), _bits(v))


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    state = _state(2)
    store.save_checkpoint(str(tmp_path), 5, state)
    tree = _jax_tree(state)
    loaded, meta = jax_store.load_checkpoint(str(tmp_path), tree)
    assert meta["step"] == 5
    got, want = jax.tree.leaves(loaded), jax.tree.leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    # the port's names are convert's: the reference's pytree comes back
    # to the same flat dict
    back = params_from_jax(loaded)
    for k, v in state.items():
        np.testing.assert_array_equal(_bits(back[k]), _bits(v))


def test_mismatched_templates_are_named(tmp_path):
    state = {"w": torch.ones(4, 3), "b": torch.zeros(3, dtype=torch.int32),
             "h": torch.ones(4, 2, dtype=torch.bfloat16)}
    store.save_checkpoint(str(tmp_path), 0, state)
    with pytest.raises(ValueError, match="shape"):
        store.load_checkpoint(str(tmp_path), {**state, "w": torch.ones(4, 5)})
    with pytest.raises(ValueError, match="dtype"):
        store.load_checkpoint(str(tmp_path),
                              {**state, "b": torch.zeros(3,
                                                         dtype=torch.int64)})
    with pytest.raises(ValueError, match="dtype"):
        store.load_checkpoint(str(tmp_path), {**state, "h": torch.ones(4, 2)})
    with pytest.raises(KeyError, match="missing"):
        store.load_checkpoint(str(tmp_path), {**state, "z": torch.ones(1)})
    # elastic restore: another leading (worker) dim is fine
    loaded, _ = store.load_checkpoint(str(tmp_path),
                                      {**state, "w": torch.ones(9, 3)})
    assert tuple(loaded["w"].shape) == (4, 3)
    with pytest.raises(FileNotFoundError):
        store.load_checkpoint(str(tmp_path / "none"), state)


def test_manager_keeps_the_newest(tmp_path):
    state = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    mgr = store.CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, state, meta={"s": s})
    assert store.list_steps(str(tmp_path)) == [3, 4]
    assert mgr.latest_step() == 4
    restored, meta = mgr.restore(state)
    assert meta["step"] == 4 and meta["s"] == 4
    assert torch.equal(restored["a"], state["a"])
    assert torch.equal(restored["b"]["c"], state["b"]["c"])
    assert not any(f.startswith("tmp") for f in os.listdir(tmp_path))
    restored, meta = mgr.restore(state, step=3)
    assert meta["s"] == 3


@pytest.mark.parametrize("new_w", [2, 4, 7])
def test_elastic_reshard_matches_reference(new_w):
    state = _state(3)
    got = store.elastic_reshard(state, new_w)
    want = jax_store.elastic_reshard(_jax_tree(state), new_w)
    back = params_from_jax(want)
    for k, v in got.items():
        assert v.shape[0] == new_w
        np.testing.assert_array_equal(_bits(v), _bits(back[k]))


def test_save_load_resume_dfl(tmp_path):
    """A bf16 registry LM trains 2 rounds, its ``final_params`` are saved
    and loaded, and a run resumed from them with ``init_params=`` starts
    from the checkpoint: bit-equal leaves, a starting matrix whose spread
    is exactly the saved run's last consensus record, and a first round
    that differs from a fresh start's."""
    spec = "dense:d=32,layers=1,heads=2,kv=1,ff=32,vocab=32,seq=12"
    tiny = modelspec.get_adapter(spec)
    adapter = modelspec.RegistryAdapter(
        replace(tiny.cfg, dtype="bfloat16", remat="block"), tiny.seq_len,
        tiny.num_classes, "bf16-resume")
    cfg = port_config(num_workers=4, model=spec, algorithm="dpsgd",
                      tau_init=2, tau_max=2)

    def run(rounds, init_params=None):
        train, tx, ty, shards, cluster = setup_experiment(
            cfg, rounds=rounds, device="cpu", **DATA_KW)
        strategy = make_strategy(cfg, make_base_topology(
            cfg.num_workers, cfg.base_topology, cfg.seed))
        return engine.run_dfl(train, tx, ty, shards, cluster, cfg, strategy,
                              rounds=rounds, adapter=adapter,
                              init_params=init_params, device="cpu")

    h1 = run(2)
    saved = h1.final_params
    assert {v.dtype for v in saved.values()} == {torch.bfloat16}
    store.save_checkpoint(str(tmp_path), 2, saved)
    loaded, meta = store.load_checkpoint(str(tmp_path), saved)
    assert meta["step"] == 2
    for k, v in saved.items():
        np.testing.assert_array_equal(_bits(loaded[k]), _bits(v))
    # the reference reads the same files into its pytree
    assert jax_store.list_steps(str(tmp_path)) == [2]
    np_tree = params_to_numpy(loaded)
    assert np_tree["embed"].dtype == np.float32
    start = engine.initial_params(adapter, cfg.num_workers, cfg.seed,
                                  loaded, "cpu")
    assert torch.equal(start, adapter.flatten(saved))
    spread = engine.consensus_record(start, np.ones(cfg.num_workers, bool))
    assert spread == h1.records[-1].consensus > 0
    h2 = run(2, init_params=loaded)
    fresh = run(2)
    assert h2.records[0].consensus != fresh.records[0].consensus
    assert all(np.isfinite(r.loss) for r in h2.records)
