"""Roofline terms of a step — the port of ``repro.launch.roofline``.

    compute term    = FLOPs / (chips x 989e12 bf16 FLOP/s)
    memory term     = bytes / (chips x 3.35e12 B/s HBM)
    collective term = collective_bytes / (chips x 450e9 B/s NVLink)

The counts are global (summed over the chips), so each term is the
seconds one chip takes for its share. The reference reads its FLOPs and
bytes from XLA's ``cost_analysis()`` of the compiled step and parses its
collective bytes from the optimized HLO text (``parse_collective_bytes``).
The port has no compiled module and no HLO: ``launch/dryrun.py`` counts
the FLOPs and bytes of the step traced on the ``meta`` device, and
``collective_bytes_from_tables`` counts what the round's matching gossip
moves from the topology's weight tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.runtime import collectives

# NVIDIA H100 SXM, per card (NVIDIA H100 Tensor Core GPU datasheet, dense
# rates without sparsity); they replace the reference's TPU v5e constants
PEAK_FLOPS = 989e12          # bf16 on the tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s: NVLink 4, one direction of 900 GB/s


@dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int] = field(default_factory=dict)
    count_by_kind: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_bytes_from_tables(adj: np.ndarray, mix: np.ndarray,
                                 row_bytes: int) -> CollectiveStats:
    """What a round's matching gossip moves between workers, under the
    reference's kind ``collective-permute`` (one a matching, as its
    ``gossip_fn`` runs one ``ppermute`` a matching): each matching's
    partner rows — a worker with a non-zero weight for its partner in
    the matching (``collectives.matching_weight_tables``) receives the
    partner's row — times ``row_bytes``, one worker's replica. A global
    count: every row a receiving worker takes, whatever chips hold it."""
    if adj.shape[0] < 2:
        return CollectiveStats()
    table = collectives.matching_weight_tables(adj, mix)
    rows = int(np.count_nonzero(table))
    return CollectiveStats({"collective-permute": rows * int(row_bytes)},
                           {"collective-permute": table.shape[0]})


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    collectives: CollectiveStats | None = None

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time lower bound (terms overlap perfectly)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def useful_fraction(self, model_flops: float) -> float:
        """MODEL_FLOPS / counted FLOPs — remat / redundancy waste
        detector."""
        return model_flops / max(self.flops, 1.0)

    def mfu(self, model_flops: float) -> float:
        """Roofline-bound MFU: useful FLOPs over peak at the bound step
        time (the score: fraction of roofline achieved)."""
        t = self.step_time_s
        return model_flops / (self.chips * PEAK_FLOPS * max(t, 1e-30))


def roofline_from_counts(flops: float, hbm_bytes: float,
                         collective_bytes: float, chips: int,
                         collectives: CollectiveStats | None = None
                         ) -> Roofline:
    """The reference's ``roofline_from_compiled`` for counts taken
    without a compiler: ``flops``, ``hbm_bytes`` and ``collective_bytes``
    global (summed over the ``chips``), as the reference stores them."""
    return Roofline(flops=float(flops), hbm_bytes=float(hbm_bytes),
                    collective_bytes=float(collective_bytes), chips=chips,
                    collectives=collectives)


def model_flops_train(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) per step."""
    n = cfg.active_param_count()
    d = shape.seq_len * shape.global_batch
    return 6.0 * n * d


def model_flops_decode(cfg, shape) -> float:
    """Decode: 2·N_active per generated token (fwd only) x batch."""
    n = cfg.active_param_count()
    return 2.0 * n * shape.global_batch


def model_flops_prefill(cfg, shape) -> float:
    n = cfg.active_param_count()
    return 2.0 * n * shape.seq_len * shape.global_batch


def model_flops(cfg, shape) -> float:
    if shape.kind == "train":
        return model_flops_train(cfg, shape)
    if shape.kind == "prefill":
        return model_flops_prefill(cfg, shape)
    return model_flops_decode(cfg, shape)
