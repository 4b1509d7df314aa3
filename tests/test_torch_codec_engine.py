"""The port's synchronous engines under the wire codecs, against the
reference.

The reference JAX ``engine.run_dfl`` and the port's ``run_dfl`` and
``run_dfl_fused`` run on the CPU from the same seeds and the same JAX
initialisation, at W = 8 for 6 rounds, under int8, top-k and rand-k:
D-PSGD, LD-SGD and FedHP under int8 and top-k with and without churn,
rand-k for D-PSGD and FedHP, error feedback off for int8 and top-k, and
FedHP with k-tightening (``tighten_k``; a fast learning-rate decay
shrinks the consensus distance enough for the tightening to fire).

Host-side record fields (times — Eq. 10 charges comm / the codec's wire
ratio —, taus, links) must be exactly equal, with the port's own
strategies (no plan replay). Device metrics: accuracy within one eval
sample of one worker (1/512), loss within 1e-4 relative, consensus
within 1e-4 relative plus 1e-6 absolute — the uncompressed engines'
tolerances (``tests/test_torch_engine.py``), which the sparse codecs meet
by orders of magnitude (a pure select keeps the engines' float drift
where it was; worst case measured 2.3e-7 relative).

int8 is the exception, wider on purpose: the reference's jitted residual
``z - q * scale`` fuses the dequantize multiply into the subtraction
(no rounding of the product), its local SGD sums in another order than
PyTorch's, and any 1-ulp difference in z = x + e that lands on a
half-quantum boundary moves that coordinate by a whole quantum
(amax / 127, about 1e-2 here). Round 0 agrees exactly; the difference
then grows about threefold a round, as flipped coordinates train on
(measured per round). So int8 holds loss to 2e-3 and consensus to 1e-2
relative (worst measured, FedHP without churn at round 5: loss 9.5e-4,
consensus 4.7e-3, accuracy 1.5e-3; D-PSGD and LD-SGD stay under
7e-4). The run stops at 6 rounds because by round 7 such flips turn one
of FedHP's integer tau decisions with churn — the JAX package's own two engines part the same
way there (``tests/test_fused_equivalence.py`` ``[fedhp-churn]``). A
wiring fault (a residual not carried, a state not reset at a join, a
wrong wire ratio) shows at round 0 or in the exact host fields.
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_parity import run_port, run_reference, worst_diffs

EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time")
ROUNDS = 6
ACC_ATOL = 1.0 / 512
REL_TOL = 1e-4
CONSENSUS_ATOL = 1e-6
INT8_LOSS_RTOL = 2e-3
INT8_CONSENSUS_RTOL = 1e-2

# id -> (algorithm, churn, config fields)
CASES = {
    f"{algo}-{codec.partition(':')[0]}-{'churn' if churn else 'nochurn'}":
        (algo, churn, dict(compress=codec))
    for algo in ("dpsgd", "ldsgd", "fedhp")
    for codec in ("int8", "topk:0.1")
    for churn in (False, True)}
CASES.update({
    "dpsgd-randk-nochurn": ("dpsgd", False, dict(compress="randk:0.1")),
    "fedhp-randk-churn": ("fedhp", True, dict(compress="randk:0.1")),
    "dpsgd-int8-noef-churn": ("dpsgd", True, dict(compress="int8",
                                                  error_feedback=False)),
    "dpsgd-topk-noef-churn": ("dpsgd", True, dict(compress="topk:0.1",
                                                  error_feedback=False)),
    "fedhp-topk-tighten": ("fedhp", False, dict(
        compress="topk:0.5", tighten_k=True, sparse_k_floor=0.125,
        lr_decay=0.5)),
})

_reference_runs: dict = {}


def _reference(case: str):
    if case not in _reference_runs:
        algo, churn, kw = CASES[case]
        _reference_runs[case] = run_reference(algo, churn, ROUNDS, **kw)[0]
    return _reference_runs[case]


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_reference_under_codec(case, engine_name):
    algo, churn, kw = CASES[case]
    h_ref = _reference(case)
    h_port = run_port(algo, churn, engine_name, rounds=ROUNDS, **kw)
    assert len(h_ref.records) == len(h_port.records) == ROUNDS
    a, b = h_ref.as_arrays(), h_port.as_arrays()
    print(f"{case} [{engine_name}] worst differences:", worst_diffs(a, b))
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    int8 = kw["compress"] == "int8"
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_ATOL)
    np.testing.assert_allclose(a["loss"], b["loss"],
                               rtol=INT8_LOSS_RTOL if int8 else REL_TOL)
    np.testing.assert_allclose(
        a["consensus"], b["consensus"],
        rtol=INT8_CONSENSUS_RTOL if int8 else REL_TOL, atol=CONSENSUS_ATOL)


def test_codecs_cut_the_clock():
    """Eq. 10 charges each codec's wire ratio: on the same plans, int8
    and rand-k rounds run strictly faster than uncompressed ones, and
    rand-k (no indices on the wire) faster than top-k."""
    times = {codec: run_port("dpsgd", False, "reference", rounds=2,
                             compress=codec).as_arrays()["round_time"]
             for codec in ("none", "int8", "topk:0.1", "randk:0.1")}
    assert (times["int8"] < times["none"]).all()
    assert (times["topk:0.1"] < times["none"]).all()
    assert (times["randk:0.1"] < times["topk:0.1"]).all()
