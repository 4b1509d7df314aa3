"""The port's synchronous engines under per-leaf codec maps
(``compress="leafmap:..."``), against the reference.

The reference JAX ``engine.run_dfl`` and the port's ``run_dfl`` and
``run_dfl_fused`` run on the CPU from the same seeds and the same JAX
initialisation (``convert.params_from_jax``), at W = 8:

- on the paper's MLP for 6 rounds: FedHP and D-PSGD, with and without
  churn, dense and sparse gossip, under ``leafmap:w1=topk:0.1,b=none,
  default=int8`` (the first layer's weights top-k, the biases raw, the
  rest int8), LD-SGD with churn (dense) and without (sparse) and PENS
  (dense; its fused run replays the reference's plans, as
  ``tests/test_torch_engine.py`` says why) under the same map; and FedHP
  with churn (dense) and D-PSGD (sparse) under a map with no int8
  segment, ``leafmap:w1=topk:0.1,b=randk:0.5,default=none``;
- on the tiny dense LM (``_torch_parity.TINY_LM``) for 5 rounds: D-PSGD
  with churn over sparse gossip under the reference's map
  ``leafmap:embed=randk:0.05,ln=none,default=int8`` (FedHP on that LM is
  in ``tests/test_torch_leafmap_registry.py``).

Host record fields (times — Eq. 10 charges comm / the compiled map's
wire ratio —, taus, links) must be exactly equal, with the port's own
strategies (no plan replay). Device metrics: the parity contract of
``tests/test_torch_engine.py`` (accuracy within 1/512, loss and
consensus within 1e-4 relative, consensus also 1e-6 absolute) for a map
with no int8 segment; a map with one carries int8's rounding chaos and
is held to int8's tolerances (loss 2e-3, consensus 1e-2 relative;
``tests/test_torch_codec_engine.py`` says why). Worst measured: loss
1.3e-4 and consensus 1.6e-4 relative under the int8-bearing map (FedHP
with churn over sparse gossip, reference engine), 1.5e-7 under the
int8-free one.

AD-PSGD refuses a leafmap with the reference's ``ValueError``.
"""
from __future__ import annotations

import pytest

from _torch_parity import (TINY_LM, assert_parity, port_config, run_port,
                           run_reference, worst_diffs)
from repro_torch.core.experiment import run_algorithm

MLP_ROUNDS = 6
LM_ROUNDS = 5
MLP_MAP = "leafmap:w1=topk:0.1,b=none,default=int8"
MLP_MAP_NO_INT8 = "leafmap:w1=topk:0.1,b=randk:0.5,default=none"
LM_MAP = "leafmap:embed=randk:0.05,ln=none,default=int8"

# id -> (algorithm, churn, rounds, config fields)
CASES = {
    f"{algo}-{'churn' if churn else 'nochurn'}-{gossip}":
        (algo, churn, MLP_ROUNDS, dict(compress=MLP_MAP, gossip=gossip))
    for algo in ("fedhp", "dpsgd")
    for churn in (False, True)
    for gossip in ("dense", "sparse")}
CASES.update({
    "fedhp-churn-dense-noint8": ("fedhp", True, MLP_ROUNDS,
                                 dict(compress=MLP_MAP_NO_INT8)),
    "dpsgd-nochurn-sparse-noint8": ("dpsgd", False, MLP_ROUNDS,
                                    dict(compress=MLP_MAP_NO_INT8,
                                         gossip="sparse")),
    "ldsgd-churn-dense": ("ldsgd", True, MLP_ROUNDS,
                          dict(compress=MLP_MAP)),
    "ldsgd-nochurn-sparse": ("ldsgd", False, MLP_ROUNDS,
                             dict(compress=MLP_MAP, gossip="sparse")),
    "pens-nochurn-dense": ("pens", False, MLP_ROUNDS,
                           dict(compress=MLP_MAP)),
    "lm-dpsgd-churn-sparse": ("dpsgd", True, LM_ROUNDS,
                              dict(compress=LM_MAP, gossip="sparse",
                                   model=TINY_LM)),
})
# PENS through the fused engine replays the reference's plans (exact
# cross-loss ties, tests/test_torch_engine.py)
REPLAY = {("pens-nochurn-dense", "fused")}

_reference_runs: dict = {}


def _reference(case: str):
    if case not in _reference_runs:
        algo, churn, rounds, kw = CASES[case]
        _reference_runs[case] = run_reference(algo, churn, rounds, **kw)
    return _reference_runs[case]


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_reference_under_leafmap(case, engine_name):
    algo, churn, rounds, kw = CASES[case]
    h_ref, recorded = _reference(case)
    replay = recorded if (case, engine_name) in REPLAY else None
    h_port = run_port(algo, churn, engine_name, rounds=rounds,
                      replay=replay, **kw)
    print(f"{case} [{engine_name}] worst differences:",
          worst_diffs(h_ref.as_arrays(), h_port.as_arrays()))
    assert_parity(h_ref, h_port, rounds, int8="int8" in kw["compress"])


def test_leafmap_bills_its_wire_ratio():
    """Eq. 10 charges the compiled map's own ratio: on the same plans a
    map that ships most of the model int8 runs a faster clock than
    uncompressed, and a slower one than uniform int8 (its biases go
    raw, its top-k segment ships indices)."""
    times = {codec: run_port("dpsgd", False, "reference", rounds=2,
                             compress=codec).as_arrays()["round_time"]
             for codec in ("none", "int8", MLP_MAP)}
    assert (times[MLP_MAP] < times["none"]).all()
    assert (times["int8"] < times[MLP_MAP]).all()


@pytest.mark.parametrize("fused", [False, True], ids=["reference", "fused"])
def test_adpsgd_refuses_a_leafmap(fused):
    with pytest.raises(ValueError, match="synchronous-engine only"):
        run_algorithm("adpsgd", port_config(compress=MLP_MAP), rounds=2,
                      fused=fused, device="cpu")
