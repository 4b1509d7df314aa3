"""The port's synchronous engines training the hybrid family against the
reference, on the settings of ``tests/test_torch_families_engine.py``
(the moe family; its docstring says why these sizes and settings).

A tiny spec (``_torch_parity.FAMILY_SPECS["hybrid"]``: d 64, 2 Mamba2
blocks of state 8 (two heads of 64) and one shared attention + MLP block
(2 query heads over 1 KV head, d_ff 64), vocabulary 32, sequences of 12
tokens) trains at W = 4 for 3 rounds through the reference JAX
``engine.run_dfl`` and the port's ``run_dfl`` and ``run_dfl_fused`` on
the CPU: FedHP with and without churn, D-PSGD, and D-PSGD under int8,
held to the parity contract (int8's tolerances under int8).
"""
from __future__ import annotations

import pytest

from _torch_parity import FAMILY_CASES, check_family_engines


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_hybrid_engines_match_reference(case):
    check_family_engines("hybrid", case)
