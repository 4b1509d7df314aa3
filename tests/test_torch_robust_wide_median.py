"""Byzantine-robust gossip past 64 neighbours, median: the companion of
``tests/test_torch_robust_wide.py`` (its docstring has the set-up).

1. ``ops.robust_gossip`` at D = 65 with ``mode="median"`` on CPU tensors
   against the reference's Pallas ``robust_gossip`` in interpret mode:
   the same bits (a median adds no window).
2. FedHP over the same fleet of 66 under ``robust="median"`` through the
   reference JAX ``engine.run_dfl`` and both port engines, under the
   parity contract.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, run_port, run_reference
from repro_torch.kernels import ops
from test_torch_robust_wide import ROUNDS, WIDE_KW, wide_inputs

torch.set_num_threads(1)


def test_robust_gossip_wide_median_matches_pallas_kernel():
    from repro.kernels.robust_gossip import robust_gossip as pallas_robust
    x, t, nbr, deg = wide_inputs(67, 37, seed=6)
    want = np.asarray(pallas_robust(x, t, nbr, deg, b=0.0, mode="median",
                                    interpret=True))
    got = ops.robust_gossip(*(torch.from_numpy(a) for a in (x, t, nbr, deg)),
                            b=0.0, mode="median").numpy()
    np.testing.assert_array_equal(got, want)


_reference: dict = {}


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
def test_port_matches_reference_wide_median(engine_name):
    kw = dict(WIDE_KW, robust="median")
    if "h" not in _reference:
        _reference["h"] = run_reference("fedhp", False, ROUNDS, **kw)[0]
    assert_parity(_reference["h"], run_port("fedhp", False, engine_name,
                                            rounds=ROUNDS, **kw), ROUNDS)
