"""The per-leaf codec maps (``compress="leafmap:..."``) against the
reference, function by function.

Every input is a numpy array made from a seed; the reference's functions
run eagerly (not under ``jax.jit``):

- ``parse_mode`` / ``parse_leafmap``: rules, default and the ``mode``
  string round trip equal, and the same rejects (``ValueError``);
- ``LeafmapCodec.compile`` on the MLP's leaf table and on the tiny dense
  LM's (``_torch_parity.TINY_LM``): the same segments (start, stop,
  codec, resolved k), and ``wire_bits`` / ``wire_ratio`` exactly equal;
- each rand-k segment's mask draw (the run's key folded on the
  segment's start, then on the step) bit-equal to ``jax.random``;
- ``leafmap_payload``, ``leafmap_state_init``,
  ``leafmap_state_after_join`` and ``leafmap_gamma_mask`` bit-equal;
- ``leafmap_gossip_ref``, dense and over a CSR edge list: the codec state
  bit-equal, the mixed parameters within 1e-6 absolute — the dense
  product ``W v`` sums in another order than the reference's
  ``tensordot`` (worst measured 1.2e-7, one ulp; the edge sum came out
  bit-equal to ``segment_sum``); an identity mix and an empty edge list
  are exact no-ops.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_LM
from repro.core import compression as jc
from repro.core import modelspec as jax_modelspec
from repro.core import topology as jax_topo
from repro_torch.core import compression as tc
from repro_torch.core import engine, modelspec
from repro_torch.core.topology import erdos_topology, mixing_matrix_uniform

# the suite runs one test file per xdist worker: keep each on one core
torch.set_num_threads(1)

MODES = ["leafmap:w1=topk:0.1,b=none,default=int8",
         "leafmap:embed=randk:0.05,ln=none,default=int8",
         "leafmap:W=randk:0.2",
         "leafmap:w2=int8,w=topk:300,default=randk:0.5",
         "leafmap:default=int8",
         "leafmap:b=topk:0.5,w3=none,default=topk:0.05"]
MODEL_SPECS = {"mlp": "mlp", "tiny-lm": TINY_LM}


def _leaf_tables(model: str):
    """(reference leaf table, port leaf table) of the model ``model``
    names."""
    return (jax_modelspec.get_adapter(MODEL_SPECS[model]).leaf_offsets(),
            modelspec.get_adapter(MODEL_SPECS[model]).leaf_offsets())


def _compiled(mode: str, model: str):
    jt, pt = _leaf_tables(model)
    return jc.parse_mode(mode).compile(jt), tc.parse_mode(mode).compile(pt)


def _same_codec(a, b) -> bool:
    return (a.kind, a.k, a.mode) == (b.kind, b.k, b.mode)


@pytest.mark.parametrize("mode", MODES)
def test_parse_matches_reference(mode):
    a, b = jc.parse_mode(mode), tc.parse_mode(mode)
    assert isinstance(b, tc.LeafmapCodec) and b.kind == "leafmap"
    assert a.mode == b.mode
    assert [p for p, _ in a.rules] == [p for p, _ in b.rules]
    assert all(_same_codec(x, y) for (_, x), (_, y) in zip(a.rules,
                                                          b.rules))
    assert _same_codec(a.default, b.default)
    assert not b.is_sparse and not b.compiled and b.resolve_k(100) == 0
    # the mode string parses back to the same map
    assert tc.parse_mode(b.mode) == b
    assert tc.parse_mode(b) is b
    with pytest.raises(ValueError, match="compiled"):
        b.wire_ratio()


@pytest.mark.parametrize("bad", ["leafmap:embed", "leafmap:x=leafmap:y=int8",
                                 "leafmap:x=topk:0", "leafmap:x=bogus"])
def test_parse_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jc.parse_mode(bad)
    with pytest.raises(ValueError):
        tc.parse_mode(bad)


@pytest.mark.parametrize("model", list(MODEL_SPECS))
@pytest.mark.parametrize("mode", MODES)
def test_compile_and_wire_accounting_match(mode, model):
    a, b = _compiled(mode, model)
    assert b.compiled and len(a.segments) == len(b.segments)
    for sa, sb in zip(a.segments, b.segments):
        assert (sa.start, sa.stop, sa.k_abs, sa.size) == \
            (sb.start, sb.stop, sb.k_abs, sb.size)
        assert _same_codec(sa.codec, sb.codec)
    jt, pt = _leaf_tables(model)
    assert b.segments[-1].stop == pt[-1].stop
    for ja, pa in zip(jt, pt):
        assert _same_codec(a.codec_for(ja.name), b.codec_for(pa.name))
    assert a.wire_bits() == b.wire_bits()
    assert a.wire_ratio() == b.wire_ratio() == b.wire_ratio(12345)
    np.testing.assert_array_equal(
        tc.leafmap_gamma_mask(b, True), jc.leafmap_gamma_mask(a, True))
    np.testing.assert_array_equal(
        tc.leafmap_gamma_mask(b, False), jc.leafmap_gamma_mask(a, False))
    assert tc.leafmap_carries_state(b, True) == \
        jc.leafmap_carries_state(a, True)
    assert tc.leafmap_carries_state(b, False) == \
        jc.leafmap_carries_state(a, False)


@pytest.mark.parametrize("seed,step", [(3, 0), (5, 7), (11, 123)])
def test_segment_randk_draws_match_jax_random(seed, step):
    a, b = _compiled("leafmap:w=randk:0.2,b1=randk:3,default=none", "mlp")
    skey = tc.sparsify_base_key(seed)
    scores = tc.leafmap_scores(b, skey, step)
    key = jnp.asarray(skey, jnp.uint32)
    randk = [s for s in a.segments if s.codec.kind == "randk"]
    assert len(randk) == 2
    for s in randk:
        want = jc.randk_scores(jc.jax.random.fold_in(key, s.start), step,
                               s.size)
        np.testing.assert_array_equal(scores[s.start:s.stop],
                                      np.asarray(want))
    assert tc.leafmap_scores(_compiled("leafmap:default=int8", "mlp")[1],
                             skey, step) is None


def _inputs(p: int, w: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    flat = (rng.normal(size=(w, p)) * 0.3).astype(np.float32)
    err = (rng.normal(size=(w, p)) * 0.01).astype(np.float32)
    keep = rng.random(w) < 0.4
    mix = mixing_matrix_uniform(erdos_topology(w, 0.5, rng))
    return flat, err, keep, mix.astype(np.float32)


def _states(mode: str, model: str, ef: bool, seed: int):
    """Both packages' compiled maps, inputs, and each one's state_init
    of ``flat`` plus ``err`` (a stale x̂ on top-k segments, a residual
    elsewhere)."""
    a, b = _compiled(mode, model)
    flat, err, keep, mix = _inputs(b.segments[-1].stop, seed=seed)
    ja = np.asarray(jc.leafmap_state_init(jnp.asarray(flat), a, ef))
    tb = tc.leafmap_state_init(torch.from_numpy(flat), b, ef)
    np.testing.assert_array_equal(tb.numpy(), ja)
    state = (ja + err).astype(np.float32)
    return a, b, flat, state, keep, mix


CASES = [(m, model, ef) for m in MODES[:4] for model in MODEL_SPECS
         for ef in (True, False)]
CASE_IDS = [f"{i}-{model}-{'ef' if ef else 'noef'}"
            for i, (_, model, ef) in enumerate(CASES)]


@pytest.mark.parametrize("mode,model,ef", CASES, ids=CASE_IDS)
def test_payload_state_init_and_join_bit_equal(mode, model, ef):
    a, b, flat, state, keep, _ = _states(mode, model, ef, seed=1)
    skey, step = tc.sparsify_base_key(3), 5
    pay_j, st_j = jc.leafmap_payload(
        jnp.asarray(flat), jnp.asarray(state), a, error_feedback=ef,
        key=jnp.asarray(skey, jnp.uint32), step=step)
    scores = tc.leafmap_scores(b, skey, step)
    pay, st = tc.leafmap_payload(
        torch.from_numpy(flat), torch.from_numpy(state), b,
        error_feedback=ef,
        scores=None if scores is None else torch.from_numpy(scores))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(pay_j))
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    joined_j = jc.leafmap_state_after_join(
        jnp.asarray(state), jnp.asarray(keep)[:, None],
        jnp.asarray(flat), a, ef)
    joined = tc.leafmap_state_after_join(
        torch.from_numpy(state), torch.from_numpy(keep)[:, None],
        torch.from_numpy(flat), b, ef)
    np.testing.assert_array_equal(joined.numpy(), np.asarray(joined_j))
    # the engines' dispatch takes the same path
    np.testing.assert_array_equal(
        tc.codec_state_after_join(torch.from_numpy(state),
                                      torch.from_numpy(keep)[:, None],
                                      torch.from_numpy(flat), b,
                                      ef).numpy(), joined.numpy())


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("mode,model,ef", CASES, ids=CASE_IDS)
def test_leafmap_gossip_matches_reference(mode, model, ef, sparse):
    a, b, flat, state, _, mix = _states(mode, model, ef, seed=2)
    skey, step, gamma = tc.sparsify_base_key(5), 9, 0.25
    scores = tc.leafmap_scores(b, skey, step)
    scores = None if scores is None else torch.from_numpy(scores)
    adj = (mix > 0) & ~np.eye(len(mix), dtype=bool)
    kw = dict(error_feedback=ef, gamma=gamma)
    if sparse:
        e = jax_topo.edges_from_adj(adj.astype(np.int32))
        src, dst, w = jax_topo.directed_edges(
            e, jax_topo.edge_mixing_weights(e, len(mix), "uniform"))
        x_j, e_j = jc.leafmap_gossip_ref(
            jnp.asarray(flat), jnp.asarray(state), None, a,
            key=jnp.asarray(skey, jnp.uint32), step=step,
            edges=tuple(map(jnp.asarray, (src, dst, w))), **kw)
        csr = tuple(map(torch.as_tensor, engine.round_edges(
            adj.astype(np.int32), "uniform")))
        x, e_t = tc.leafmap_gossip_ref(
            torch.from_numpy(flat), torch.from_numpy(state), None, b,
            scores=scores, edges=csr, **kw)
    else:
        x_j, e_j = jc.leafmap_gossip_ref(
            jnp.asarray(flat), jnp.asarray(state), jnp.asarray(mix), a,
            key=jnp.asarray(skey, jnp.uint32), step=step, **kw)
        x, e_t = tc.leafmap_gossip_ref(
            torch.from_numpy(flat), torch.from_numpy(state),
            torch.from_numpy(mix), b, scores=scores, **kw)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-6)
    # an identity mix / an empty edge list is an exact no-op on the
    # parameters
    if sparse:
        n = len(mix)
        empty = (torch.zeros(n + 1, dtype=torch.int32),
                 torch.zeros(0, dtype=torch.int32), torch.zeros(0))
        x_id, _ = tc.leafmap_gossip_ref(
            torch.from_numpy(flat), torch.from_numpy(state), None, b,
            scores=scores, edges=empty, **kw)
    else:
        x_id, _ = tc.leafmap_gossip_ref(
            torch.from_numpy(flat), torch.from_numpy(state),
            torch.eye(len(mix)), b, scores=scores, **kw)
    np.testing.assert_array_equal(x_id.numpy(), flat)


def test_engine_codec_helpers():
    """``run_codec`` compiles a leafmap against the adapter and
    ``round_codec`` keeps the compiled map whatever the plan carries."""
    from repro_torch.configs.base import FedHPConfig
    from repro_torch.core.algorithms import RoundPlan
    adapter = modelspec.get_adapter("mlp")
    cfg = FedHPConfig(compress=MODES[0])
    codec = engine.run_codec(cfg, adapter)
    assert codec.compiled and codec.segments[-1].stop == adapter.param_count
    plan = RoundPlan(np.zeros((2, 2)), np.ones(2),
                     codec=tc.parse_mode(MODES[0]))
    assert engine.round_codec(plan, codec) is codec
    uniform = tc.parse_mode("topk:0.1")
    tighter = uniform.with_k(0.05)
    assert engine.round_codec(RoundPlan(np.zeros((2, 2)), np.ones(2),
                                        codec=tighter), uniform) is tighter
