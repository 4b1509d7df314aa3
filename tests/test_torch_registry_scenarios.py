"""The port's engines training a registry LM, against the reference:
D-PSGD with and without churn, under ``gossip="sparse"`` and under
``robust="median"`` (2 of 8 workers sign-flip their rows on the wire),
and AD-PSGD, which runs through the shared adapter unchanged.

The tiny dense LM and the parity contract are those of
``tests/test_torch_registry_engine.py`` (FedHP): W = 8, 5 rounds, the
reference's ``engine.run_dfl`` / ``run_adpsgd`` against the port's two
engines on the CPU from the reference's initialisation; host fields
exactly equal, accuracy within 1/512, loss and consensus within 1e-4
relative (consensus also 1e-6 absolute).
"""
from __future__ import annotations

import pytest

from _torch_parity import (TINY_LM, assert_parity, run_port, run_port_adpsgd,
                           run_reference, run_reference_adpsgd)

ROUNDS = 5
BYZ = dict(byzantine=(0, 5), byzantine_attack="signflip")
CASES = {"dpsgd-nochurn": (False, {}),
         "dpsgd-churn": (True, {}),
         "dpsgd-sparse": (False, dict(gossip="sparse")),
         "dpsgd-median": (False, dict(BYZ, robust="median"))}


@pytest.mark.parametrize("case", list(CASES))
def test_dpsgd_engines_match_reference(case):
    churn, fields = CASES[case]
    h_ref, _ = run_reference("dpsgd", churn, ROUNDS, model=TINY_LM, **fields)
    for engine_name in ("reference", "fused"):
        assert_parity(h_ref, run_port("dpsgd", churn, engine_name,
                                      rounds=ROUNDS, model=TINY_LM,
                                      **fields), ROUNDS)


def test_adpsgd_engines_match_reference():
    h_ref = run_reference_adpsgd(False, ROUNDS, model=TINY_LM)
    for engine_name in ("reference", "fused"):
        assert_parity(h_ref, run_port_adpsgd(False, engine_name,
                                             rounds=ROUNDS, model=TINY_LM),
                      ROUNDS)
