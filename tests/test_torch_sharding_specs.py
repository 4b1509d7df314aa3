"""The port's sharding spec rules (``repro_torch.runtime.sharding``)
against the reference's (``repro.runtime.sharding``), on the production
meshes: 16 x 16 ``("data", "model")`` and 2 x 16 x 16 ``("pod", "data",
"model")``.

The reference's meshes are ``jax.sharding.AbstractMesh``es, the port's
``DeviceMesh``es of ``meta`` slots, so no 256 devices are needed. Every
parameter leaf of every registry config (published widths), with and
without the worker dim, every batch leaf of every shape (the train
shape's worker split through ``train_batch_spec``, every shape's serving
batch, its one-token batch and its logits through ``serve_batch_spec``)
and every decode-cache leaf at ``decode_32k`` and ``long_500k``
(``cache_spec``) gets the reference's spec, entry for entry. The port's
caches carry a leading replica dim of 1, which the rule does not see.
A control swaps the column-parallel rule for the row-parallel one on
``attn/wq`` and must part from the reference.
"""
from __future__ import annotations

import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro.runtime import sharding as ref_sharding
from repro_torch.configs import ARCH_IDS, SHAPES, arch_shape_cells, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.runtime import sharding

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)

MESHES = {"16x16": False, "2x16x16": True}
META = torch.device("meta")


def _meshes(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return (AbstractMesh(shape, axes),
            make_production_mesh(multi_pod=multi_pod,
                                 devices=["meta"] * int(np.prod(shape))))


def _path(path) -> str:
    return "/".join(str(p.key) for p in path)


def _ref_leaves(tree) -> dict:
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, l: out.__setitem__(_path(p), (p, l.shape)), tree)
    return out


def _ref_params(arch: str) -> dict:
    cfg = ref_get_config(arch)
    return _ref_leaves(jax.eval_shape(
        lambda: ref_registry.init_params(cfg, jax.random.PRNGKey(0))))


@pytest.mark.parametrize("worker_dim", [True, False],
                         ids=["workers", "replica"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs(arch, mesh_name, worker_dim):
    jmesh, tmesh = _meshes(MESHES[mesh_name])
    cfg, jcfg = get_config(arch), ref_get_config(arch)
    w = sharding.num_workers(cfg, tmesh)
    assert w == ref_sharding.num_workers(jcfg, jmesh)
    shapes = registry.leaf_shapes(cfg)
    if worker_dim:
        shapes = sharding.stack_worker_dim(shapes, w)
    got = sharding.param_pspecs(cfg, tmesh, shapes, worker_dim=worker_dim)
    ref = _ref_params(arch)
    assert set(got) == set(ref)
    for name, (path, shape) in ref.items():
        if worker_dim:
            shape = (w, *shape)
        assert tuple(shapes[name]) == tuple(shape), name
        want = ref_sharding.param_spec(path, shape, jcfg, jmesh,
                                       worker_dim=worker_dim)
        assert got[name] == tuple(want), (name, got[name], want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs(arch, mesh_name):
    jmesh, tmesh = _meshes(MESHES[mesh_name])
    cfg, jcfg = get_config(arch), ref_get_config(arch)
    w = sharding.num_workers(cfg, tmesh)
    for shape in SHAPES.values():
        bs = registry.batch_shapes(cfg, shape)
        jbs = ref_registry.batch_shapes(jcfg, shape)
        assert {k: s for k, (s, _) in bs.items()} == \
            {k: tuple(v.shape) for k, v in jbs.items()}
        if shape.kind == "train":
            for name, (s, _) in sharding.split_batch_shapes(bs, w).items():
                assert sharding.train_batch_spec(cfg, tmesh, name, s) == \
                    tuple(ref_sharding.train_batch_spec(jcfg, jmesh, name, s))
        b = shape.global_batch
        leaves = [s for k, (s, _) in bs.items() if k != "labels"]
        for s in leaves + [(b, 1), (b, cfg.vocab_size)]:
            assert sharding.serve_batch_spec(cfg, tmesh, s) == \
                tuple(ref_sharding.serve_batch_spec(jcfg, jmesh, s)), s


CACHE_CELLS = [(a, s) for a, s, _ in arch_shape_cells()
               if s in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", CACHE_CELLS)
def test_cache_specs(arch, shape_name, mesh_name):
    jmesh, tmesh = _meshes(MESHES[mesh_name])
    cfg, jcfg = get_config(arch), ref_get_config(arch)
    shape = SHAPES[shape_name]
    b = shape.global_batch
    cache = registry.make_decode_cache(cfg, b, shape.seq_len, device=META)
    shapes = {k: tuple(v.shape[1:]) if v.dim() else ()
              for k, v in cache.items()}
    got = sharding.cache_specs(cfg, tmesh, shapes, b)
    ref = _ref_leaves(jax.eval_shape(
        lambda: ref_registry.make_decode_cache(jcfg, b, shape.seq_len)))
    assert set(got) == set(ref)
    for name, (path, s) in ref.items():
        assert shapes[name] == tuple(s), name
        want = ref_sharding.cache_spec(jcfg, jmesh, path, s, b) if len(s) \
            else ()
        assert got[name] == tuple(want), (name, got[name], want)


@pytest.mark.parametrize("ndim,axes", [(2, ("data",)), (3, ("pod", "data")),
                                       (1, ("workers",))])
def test_worker_stack_spec(ndim, axes):
    assert sharding.worker_stack_spec(ndim, axes) == \
        tuple(ref_sharding.worker_stack_spec(ndim, axes))


def test_spec_shards():
    _, tmesh = _meshes(True)
    assert sharding.spec_shards(tmesh, (("pod", "data"), None, "model")) \
        == 512
    assert sharding.spec_shards(tmesh, (None, None)) == 1


def test_control_row_rule_on_wq_parts(monkeypatch):
    """The control: ``attn/wq`` taken row-parallel must differ from the
    reference somewhere (internlm2-20b, tensor-parallel within a worker)."""
    monkeypatch.setattr(sharding, "_RULES", [
        (re.compile(r"attn/wq$"), 2, sharding._ROW), *sharding._RULES])
    with pytest.raises(AssertionError, match="attn/wq"):
        test_param_specs("internlm2-20b", "16x16", False)
