"""The port's roofline terms (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``).

``model_flops`` is bit-equal to the reference's on every (arch, shape)
cell, skipped ones included. The reference's term test is mirrored with
the H100 constants that replace its TPU v5e ones. The port has no HLO to
parse: its collective bytes are counted from the round's matching weight
tables, held here to a count by hand (every edge of the topology lies in
one matching, and both its workers receive the other's row).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_rl
from repro_torch.configs import arch_shape_cells, get_config
from repro_torch.core import topology as topo
from repro_torch.launch import roofline as rl

# xdist runs one test file a worker (--dist loadfile): keep each on one core
torch.set_num_threads(1)


@pytest.mark.parametrize("arch,shape_name,shape",
                         arch_shape_cells(include_skipped=True),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_model_flops_bit_equal(arch, shape_name, shape):
    want = ref_rl.model_flops(ref_get_config(arch), REF_SHAPES[shape_name])
    got = rl.model_flops(get_config(arch), shape)
    assert got == want and type(got) is type(want)


def test_roofline_terms_and_dominance():
    r = rl.Roofline(flops=989e12 * 256, hbm_bytes=3.35e12 * 256 * 2,
                    collective_bytes=450e9 * 256 * 0.5, chips=256)
    assert np.isclose(r.compute_s, 1.0)
    assert np.isclose(r.memory_s, 2.0)
    assert np.isclose(r.collective_s, 0.5)
    assert r.dominant == "memory"
    assert np.isclose(r.step_time_s, 2.0)
    # MFU bound: useful fraction over the binding term
    assert np.isclose(r.mfu(989e12 * 256), 0.5)
    assert np.isclose(r.useful_fraction(989e12 * 128), 0.5)


def test_hardware_constants_are_the_h100s():
    assert rl.PEAK_FLOPS == 989e12
    assert rl.HBM_BW == 3.35e12
    assert rl.LINK_BW == 450e9


def test_roofline_from_counts():
    stats = rl.CollectiveStats({"collective-permute": 10}, {"collective-permute": 1})
    r = rl.roofline_from_counts(2, 3, 10, 4, stats)
    assert (r.flops, r.hbm_bytes, r.collective_bytes, r.chips) == \
        (2.0, 3.0, 10.0, 4)
    assert r.collectives.total_bytes == 10


@pytest.mark.parametrize("w,base", [(4, "ring"), (8, "erdos:0.5"),
                                    (1, "ring")])
def test_collective_bytes_by_hand(w, base):
    adj = topo.make_base_topology(w, base, 3) if w > 1 else \
        np.zeros((1, 1), np.int8)
    row_bytes = 4 * 1000
    stats = rl.collective_bytes_from_tables(
        adj, topo.mixing_matrix_uniform(adj) if w > 1 else np.ones((1, 1)),
        row_bytes)
    edges = int(np.triu(adj, 1).sum())
    if w == 4:
        assert edges == 4                 # the ring
    if w == 1:
        assert stats.bytes_by_kind == {} and stats.total_bytes == 0
        return
    assert stats.bytes_by_kind == {"collective-permute": 2 * edges * row_bytes}
    assert stats.count_by_kind == {
        "collective-permute": len(topo.matching_decomposition(adj))}
