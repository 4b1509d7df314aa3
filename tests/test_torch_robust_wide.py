"""Byzantine-robust gossip past 64 neighbours, trimmed mean (the median
is in ``tests/test_torch_robust_wide_median.py``; the two files split
the engine runs so that each stays near a minute on one core).

1. ``ops.robust_gossip`` on CPU tensors takes a neighbour table of any
   width: at D = 65 and 130 it runs the plain version
   (``ref.robust_gossip_ref``) bit for bit, agrees with a numpy trimmed
   mean, and at D = 65 with the reference's Pallas ``robust_gossip`` in
   interpret mode (1e-6: the two add the window in another order).
2. The engines: FedHP over a fleet of 66 with two sign-flip attackers
   and ``robust="trimmed:2"``, through the reference JAX
   ``engine.run_dfl`` and the port's ``run_dfl`` and ``run_dfl_fused``
   (the fused engine pads round 0's table, D = 65, to 128), under the
   parity contract (ROADMAP.md). The base is ``erdos:0.95``, where 41
   workers have all 65 others as neighbours: on a complete base every
   honest worker trims the same multiset, the honest rows come out
   identical and the consensus metric is f32 noise around zero, which
   the two engines compute differently (PERF.md, section 6).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import assert_parity, run_port, run_reference
from repro_torch.core import robust, topology as topo
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

ROUNDS = 2
WIDE_KW = dict(num_workers=66, byzantine=(0, 1), base_topology="erdos:0.95")


def wide_inputs(w: int, c: int, seed: int):
    """A complete graph on ``w`` workers with worker 2 cut off (so the
    table is w - 2 wide), unit-normal rows, every fifth row sign-flipped
    in the transmitted copy."""
    rng = np.random.default_rng(seed)
    adj = topo.make_base_topology(w, "full", seed)
    adj[2, :] = adj[:, 2] = 0
    nbr, deg = robust.neighbor_table(adj)
    x = rng.normal(size=(w, c)).astype(np.float32)
    t = np.where((np.arange(w) % 5 == 0)[:, None], -x, x)
    return x, t, nbr, deg


def numpy_robust(x, t, nbr, deg, b: float, mode: str) -> np.ndarray:
    """The statistic worker by worker in float64: sort the closed
    neighbourhood, then the trimmed mean or the median."""
    y = x.astype(np.float64).copy()
    for i in range(len(x)):
        if deg[i] == 0:
            continue
        win = np.sort(np.concatenate([x[i][None], t[nbr[i, :deg[i]]]]),
                      axis=0).astype(np.float64)
        cnt = deg[i] + 1
        if mode == "median":
            y[i] = 0.5 * (win[(cnt - 1) // 2] + win[cnt // 2])
        else:
            bi = min(int(np.floor(np.float32(b) * np.float32(cnt)))
                     if b < 1 else int(b), (cnt - 1) // 2)
            y[i] = win[bi:cnt - bi].mean(axis=0)
    return y


@pytest.mark.parametrize("mode,b", [("trimmed", 2.0), ("trimmed", 0.2),
                                    ("median", 0.0)],
                         ids=["trim2", "trim20pct", "median"])
@pytest.mark.parametrize("w", [67, 132], ids=["D65", "D130"])
def test_robust_gossip_wide_table_on_cpu(w, mode, b):
    x, t, nbr, deg = wide_inputs(w, 48, seed=w)
    assert nbr.shape[1] == w - 2 > ops.ROBUST_REGISTER_MAX_DEGREE
    args = [torch.from_numpy(a) for a in (x, t, nbr, deg)]
    y = ops.robust_gossip(*args, b=b, mode=mode)
    assert torch.equal(y, ref.robust_gossip_ref(*args, b=b, mode=mode))
    np.testing.assert_allclose(y.numpy(), numpy_robust(x, t, nbr, deg, b,
                                                       mode),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(y[2].numpy(), x[2])     # degree 0
    # the fused engine's power-of-two table gives the same bits
    wide = torch.from_numpy(np.pad(nbr, ((0, 0), (0, 256 - nbr.shape[1]))))
    assert torch.equal(ops.robust_gossip(args[0], args[1], wide, args[3],
                                         b=b, mode=mode), y)


def test_robust_gossip_wide_matches_pallas_kernel():
    """D = 65, trimmed:2, against the reference's Pallas kernel in
    interpret mode (the median's Pallas case is in the median file)."""
    from repro.kernels.robust_gossip import robust_gossip as pallas_robust
    x, t, nbr, deg = wide_inputs(67, 37, seed=5)
    want = np.asarray(pallas_robust(x, t, nbr, deg, b=2.0, mode="trimmed",
                                    interpret=True))
    got = ops.robust_gossip(*(torch.from_numpy(a) for a in (x, t, nbr, deg)),
                            b=2.0, mode="trimmed").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


_reference: dict = {}


@pytest.mark.parametrize("engine_name", ["reference", "fused"])
def test_port_matches_reference_wide_trimmed(engine_name):
    kw = dict(WIDE_KW, robust="trimmed:2")
    if "h" not in _reference:
        _reference["h"] = run_reference("fedhp", False, ROUNDS, **kw)[0]
    h_ref = _reference["h"]
    assert int(h_ref.as_arrays()["num_links"][0]) > 2100   # hubs of 65
    assert_parity(h_ref, run_port("fedhp", False, engine_name,
                                  rounds=ROUNDS, **kw), ROUNDS)
