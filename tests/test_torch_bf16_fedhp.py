"""FedHP on a bf16 registry LM: the reference's ``engine.run_dfl`` and
the port's two synchronous engines on ``TINY_LM`` in bf16, W = 8, 3
rounds, under the bounds ``tests/test_torch_bf16_engine.py`` states
(its own file, so the two spread over test workers). FedHP's plans match
the reference's without replay: at W = 8 its measurements move by less
than its decisions' margins (at W = 4 one round's tau decision turns).
"""
from __future__ import annotations

from _torch_parity import CFG_KW
from test_torch_bf16_engine import check_sync_engines


def test_fedhp_engines_match_reference_in_bf16():
    check_sync_engines("fedhp", CFG_KW["num_workers"])
