"""GPU smoke run of the PyTorch port (``src/repro_torch``): the quickest
proof that the port builds, launches its kernels and runs its main path
on an NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   ``nvcc`` compiles ``src/repro_torch/kernels/csrc`` for sm_90a, one
   process per source started together;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few others — bit-equality required of the
   gossip and codec kernels — with
   CUDA-event times of the kernel, the plain version and the nearest
   PyTorch library call computing the same function: ``gossip_mix``
   (the MLP path's round, a fleet of 100 whose K spans two staged
   chunks, AD-PSGD's pair and the registry path's 8 x 45,228,480
   round), the wire codecs' ``quantize_block``, ``dequantize_block`` and
   ``sparsify_block`` (a top-k gate per row, and rand-k's shared row;
   each line names its cluster size), the edge-list ``gossip_edges``
   (``EDGES_CASES``: W = 30 full graph and ring, odd P, offset views,
   both sides of the staged instance's limit, a W = 300 star, the
   W = 2,048 ring and a W = 2,048 ``ba:2`` graph, honest and over a
   lying wire; each line names its instance), the Byzantine-robust ``robust_gossip`` (trimmed and
   median, W = 30 full graph, a W = 30 ``erdos:0.3`` graph of mixed
   degrees in a table 32 wide and the W = 2,048 ring in the register
   instances, full graphs of 66, 130 and 300 workers and a W = 1,000
   ``ba:2`` graph of mostly small degrees in the wide one, a full graph
   of 1,100 at P = 256 in the shared one; each line names its instance
   and bound), ``flash_attention``
   (the registry path's local step and measurement stack, smollm-360m's
   train shape, a gemma3-27b local layer, a 192-wide head, the forced
   causal rule, the short-sequence kernel's dispatch limit and one key
   past it, a non-causal Sk = 128 and a short sliding window, and at
   head width 112 zamba2-7b's attention on its path, zamba2-7b's and
   kimi-k2's train shapes at S = 4,096 and the short kernel's limit and
   one key past it, and phase 5's serving prefills (smollm-360m,
   gemma3-27b's local and global layers, olmoe-1b-7b, zamba2-7b and
   qwen2-vl-2b); each line names the instance that ran; within 2e-5,
   with the f32-FMA bound
   (operations at 67 TFLOP/s or bytes), the tensor-core bound (3 x the
   operations at 495 TFLOP/s, or bytes) and
   ``scaled_dot_product_attention``'s time; its bf16 instances at
   ``FLASH_BF16_CASES`` within one bf16 ulp, with the share of elements
   that differ, the bound of bf16 bytes against the operations at bf16's
   989 TFLOP/s, the issued bound (1.5 x those operations: the tile
   instance's p v twice, p split hi / lo) and bf16 SDPA's time; the bf16
   tile instance, ``flash_attention_bf16.cu``, is an entry of the
   kernels line of its own) and
   ``consensus_dist`` (the kernel benchmark's shape and phase 7's, its
   path: 3 rows of L = 361,821,120; within 1e-6 relative); gossip_mix's
   bf16-rounded form at phase 7's shape ([4, 361,821,120], K = 12)
   beside its library yardstick, x (1 - rowsum) plus the weights folded
   to [4, 4] by x in one f32 ``torch.addmm`` (the unrounded mix);
   ``gossip_mix``'s lane-strided
   form (the batched seeds axis: 4 lanes of the MLP path's round, of
   AD-PSGD's pair and of both endpoints' rows), bit-equal to its plain
   version and to one single-form launch a lane, timed beside those 4
   launches; the codec kernels also at leaf-segment widths (P = 1, 138
   and 4,736); and ``launch_floor_us``, the time of ``dequantize_block``
   on one element, timed the same way;
3. the main path: ``run_algorithm(algo, cfg, fused=True)`` at the
   paper's fleet (30 workers) and MLP (P = 6,922) — FedHP and the
   synchronous baselines uncompressed, FedHP and D-PSGD under int8,
   top-k and rand-k, AD-PSGD uncompressed and under int8; sparse
   edge-list gossip (FedHP, D-PSGD, under int8 and top-k, and the
   reference's W = 2,048 ring); 20% sign-flip attackers with the
   attacked baseline dense and sparse, trimmed:6 dense and sparse, the
   median under a norm-blown attack and AD-PSGD screening; FedHP on
   70 workers over a complete base with trimmed:2 (degree 69: the
   robust kernel's wide instance, its launches asserted; gossip_edges'
   staged instance asserted at W = 30, its gather one at W = 2,048); and the
   registry path: a dense LM at smollm-360m's widths (d 960, 15 / 5
   heads of 64, d_ff 2,560; 4 layers, a vocabulary of 6,144) with
   ``use_flash_kernel=True``, FedHP and D-PSGD at W = 8 through
   ``run_dfl_fused(adapter=...)``, and FedHP there under the per-leaf
   codec map ``leafmap:embed=randk:0.05,ln=none,default=int8`` (its
   seconds a round, peak memory and wire ratio beside uniform int8's);
   FedHP on that path as published (``LM_BF16_MODEL``: bf16 leaves and
   flash instances, remat "block"), its seconds a round and peak memory
   beside the f32 path's, and on one of its worker groups the loss and
   gradients under each remat policy (bit-equal) with each one's memory;
   FedHP on the moe, hybrid and xlstm families at published widths
   (``FAMILY_PATHS``: olmoe-1b-7b 1 layer at W = 4, zamba2-7b one
   Mamba2 block and the shared block at W = 2, xlstm-1.3b one mLSTM and
   one sLSTM block at W = 4; vocabulary 6,144, the flash
   kernel on; zamba2 and xlstm at a lower learning rate), its flash
   launches held to the family's attention calls a forward pass times
   the passes, with P, W and peak memory;
   FedHP and D-PSGD on the MLP under ``leafmap:w1=topk:0.1,b=none,
   default=int8``, dense and sparse; D-PSGD, LD-SGD and AD-PSGD with
   ``seeds`` of 4 lanes — each after a short warm-up run (the family
   paths without one), 10 timed rounds (3 on the W = 2,048 ring, 10 at
   W = 70, the registry paths' own, one on the family paths), with the
   launch counters zeroed before each timed run and read after it, and
   held to what the path must launch;
4. the reference engine against the fused engine on the card — FedHP
   uncompressed, under int8 and under top-k, AD-PSGD uncompressed and
   under int8, sparse FedHP uncompressed and under int8, trimmed:6
   sparse and dense, the median, AD-PSGD screening, and the registry
   path's FedHP over an ``erdos:0.5`` base, and the 70-worker trimmed
   FedHP over ``erdos:0.95`` (degrees 65-69), FedHP under the MLP's
   leafmap and the registry path's FedHP under its leafmap, the path as
   published in bf16 (loss and consensus within ``BF16_LOSS_RTOL`` and
   ``BF16_CONSENSUS_RTOL``, twice a one-ulp nudge's effect, and the final
   parameters bit-equal), and FedHP on
   each of the three families' paths over ``erdos:0.5``: host record
   fields (and screening's rejection counts) equal, device metrics within
   the tests' tolerances (int8's wider wherever a codec quantizes to
   int8, ``tests/test_torch_codec_engine.py``); and each batched lane of
   D-PSGD, LD-SGD and AD-PSGD against its single-lane run (host fields
   equal, device metrics within 1e-5; the cfg.seed lane also against the
   unbatched run).

5. serving (``SERVE_MODELS``, through ``repro_torch.launch.serve``'s
   ``prompt_batch`` and ``generate``): smollm-360m (B = 8, a 1,024-token
   prompt, 32 generated), gemma3-27b (B = 2, 2,048, 16: past its 1,024
   window, so the local caches roll), olmoe-1b-7b, zamba2-7b and
   xlstm-1.3b (B = 4, 512, 16), whisper-large-v3 (B = 4, 1,504 frames, a
   23-token prompt, 16) and qwen2-vl-2b (B = 4, 1,024, 16), each at its
   published config, whole, in bf16 with the flash kernel on, built on
   the card from a seed: prefill seconds and tokens/s, decode tokens/s,
   peak memory, and flash's launches held to the attention layers of
   one prefill (the tile instance), every call of a warm-up prefill
   held to the plain version within one bf16 ulp; printed, not held:
   the teacher-forced gap (each step's logits against the training
   forward's, relative to the largest), the gap of a prefill without
   the kernel, and their witness, the plain prefill against itself with
   its input embeddings one bf16 ulp away. In f32, cut to the fewest
   layers that run every block kind (smollm whole), the teacher-forced
   gap within 1e-4, and prefill with the kernel against prefill without
   it: every flash call within 2e-5 + 2e-5 |y| on its own inputs, the
   logits and every cache leaf within 2e-5 of the leaf's largest
   magnitude.

6. sharded execution (``run_sharded``; it runs between phases 4 and 5,
   on the registry corpus phase 3 built), each sharded run's launches
   counted from zero and held to gossip_edges alone for its gossip (one
   launch a shard and offset with edges, of the instance a block's rows
   take; never gossip_mix), and every gossip_edges call of a sharded
   run held bit-equal to its plain version on the same inputs as it
   runs (``_edges_held``: the shards' own and received blocks, at
   every shape the path gives the kernel; a run's seconds include
   that check): (a) D-PSGD at W = 8 on a sparse ring, 30
   fused rounds over ``make_worker_mesh(4, devices=["cuda:0"] * 4)``,
   against the unsharded run (final accuracy within 1e-3, host fields
   equal, the launches exactly 30 rounds of the ring's), FedHP with
   and without churn at the paper's fleet, 10 rounds over 2 shards on
   both engines, within the reference's ``DEVICE_TOL``, and D-PSGD
   there under int8, top-k and rand-k (fused; the codec kernels once a
   shard a round, held exactly) within ``SHARDED_COMPRESSED_TOL``; (b) the
   reference bench's big leg at full size, D-PSGD on a W = 4,096 sparse
   ring, 3 fused rounds over 4 shards, once held and once unheld for
   its rounds/s and peak memory: a shard's block bytes against the whole
   [4096, 6922], final accuracy (at least 0.5, the reference's gate, and
   within 1e-3 of the 0.946586 it reaches at these seeds) and the
   gossip_edges launches by instance, at most 120 s a round; (c) the registry path as published
   (``LM_BF16_MODEL``, W = 8), 2 FedHP rounds over 2 shards against the
   unsharded run over ``erdos:0.5``, within phase 4's bf16 bounds.

7. the production trainer (``run_trainer``, after phase 5):
   ``repro_torch.launch.train.train`` at smollm-360m as published (32
   layers, d 960, vocabulary 49,152, bf16, remat "block") with the flash
   kernel, W = 4 on a ``(data, model) = (4, 1)`` mesh of 4 slots of the
   one card (``REPRO_DEVICES=4``, ``build_mesh``), train_4k's S = 4,096,
   tau_max 2 over a complete base with the controller on, a global batch
   of 8 (2 sequences a worker; train_4k's 256 does not fit one card: the
   cut): (a) one round with every kernel call held to its plain version
   as it runs — gossip_mix (its bf16-rounded form, the matching gossip
   laid out matching-major: u the 4 rows, K = 12 weight columns)
   bit-equal, consensus_dist (worker 0's distances) within 1e-6
   relative, every flash call (the bf16 tile, 512 a round) within one
   bf16 ulp —, then a round timed unheld, every round's gossip result
   within its bound of the dense mix ``mixing_matrix_uniform(adj) @ x``,
   and the round's own gossip_mix weights, on rows made distinct, within
   the bf16 and f32 bounds of that dense mix (where rows left unmixed
   trip them): seconds a round, tokens a second (W × 2 × S × tau over
   the rounds' wall time), peak memory, the path kernels' times on their
   own inputs; (b) that first round with the plain attention composition
   (``use_flash_kernel=False``) from the same start and batch: loss and
   distances within the CPU tests' bf16 bounds (2e-3, 2e-2 relative);
   (c) that round under ``--compressed``: int8 a leaf, every quantize and
   dequantize call (11 leaves) and the bf16-rounded gossip_mix (from x,
   the decoded payload as u and as the centre) bit-equal; the model axis
   (``runtime/sharding``'s rules executed, a worker's replica over its
   model-axis slots): (d) dp, the same model over ``(data, model) =
   (4, 2)``, 8 slots of the card (``REPRO_DEVICES=8``): each slot the
   whole replica and 1 of its worker's 2 sequences, a held round from
   (a)'s init and first batch (every kernel call held as in (a), its
   FLOPs on the card equal to the dry run's of this cell) within the
   bf16 bounds of (a)'s first round (loss 2e-3, distances over sqrt(2)
   2e-2 — the reference counts a whole leaf once a slot —, parameters
   1e-3 relative in norm): seconds net of its checks, tokens a second,
   peak memory; (e)-(j) at published widths (bf16, remat "block") over
   ``(2, 2)`` (``REPRO_DEVICES=4``, ``--workers 2``;
   ``MODEL_PIECE_CASES``), tp on a global batch of 2 (1 sequence a
   worker): (e) internlm2-20b depth 2 of 48 (d 6,144, 48 / 8 heads of
   128, d_ff 16,384, vocabulary 92,544), (f) olmoe-1b-7b depth 2 of 16
   (its 64 experts over the model axis, routing once on slot 0), (g)
   zamba2-7b one group of 6 Mamba2 blocks and the shared blocks
   (Mamba2's projections split), (h) xlstm-1.3b one group of 7 mLSTM
   and 1 sLSTM block at S = 512 (the mLSTM's and sLSTM's projections
   split); dp on a global batch of 4 (each slot 1 of its worker's 2
   sequences): (i) whisper-large-v3 16 + 16 layers of 32 + 32, (j)
   qwen2-vl-2b depth 22 of 28: a held round (its FLOPs on the card equal
   to the dry run's of this cell; its distances within 1e-5 of the
   reference's rule on its own slots' inputs, sqrt of the sum over the
   slots of each slot's d^2 in f64, the leaves every slot holds whole
   equal on every slot), then the same round at ``(2, 1)`` from the
   same init and batch, loss and parameters within those bounds and the
   distances
   against the reference's rule on the (2, 1) rows, sqrt(d^2 + d^2 of
   the leaves every slot holds whole) (sqrt(2) d in dp), within the
   case's own bound, twice the largest move of a one-bf16-ulp nudge of
   the start (``ModelCase``, ``tools/model_axis_witness.py``): seconds a
   round (the held one's net of its checks), tokens a second, peak
   memory beside the dry run's bound and estimate. Each run's launches
   counted from zero and held to the path's: gossip_mix and
   consensus_dist once a slot a round (gossip_mix in both forms where
   an f32 leaf sits beside the bf16 ones), flash once a slot's
   attention layer a forward pass.

Then a JSON line describing every kernel, the card line, and the last
line ``{"ok": true, "device": {...}}``; ``[timing]`` lines give each
phase's seconds, phase 2's by check and phase 5's by model. Exits
non-zero, printing no result, without a CUDA device or outside a
checkout of the repo.

    python3 chip_smoke.py --serve

builds the kernels and runs phase 5 alone;

    python3 chip_smoke.py --sharded

phase 6 alone (after building the registry corpus);

    python3 chip_smoke.py --train

phase 7 alone ((d) to (j) included; ``[timing]`` gives them apart), and
with ``--trace`` a traced round of its trainer.

    python3 chip_smoke.py --trace

instead traces one round of the registry path's FedHP and D-PSGD with
``torch.profiler`` (after a warm-up round): wall and device-busy seconds,
the kernels that take the most device time, and the port's own kernels.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, smollm_360m  # noqa: E402
from repro_torch.configs.base import FedHPConfig, InputShape  # noqa: E402
from repro_torch.core import compression  # noqa: E402
from repro_torch.core import engine, fused, modelspec  # noqa: E402
from repro_torch.core import robust  # noqa: E402
from repro_torch.core import topology as topo  # noqa: E402
from repro_torch.core.algorithms import make_strategy  # noqa: E402
from repro_torch.core.experiment import (run_algorithm,  # noqa: E402
                                         setup_experiment)
from repro_torch.data.partition import pskew_partition  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun, serve  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.launch.mesh import make_worker_mesh  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402
from repro_torch.runtime import collectives, shardexec  # noqa: E402
from repro_torch.runtime import sharding, steps  # noqa: E402
from repro_torch.simulation.cluster import SimCluster  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores — the bound of a kernel is the larger of its bytes
# over the first and its operations over the second
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# and TF32 on the tensor cores: flash's tile kernel does each f32
# product as three TF32 products (3xTF32), so its tensor-core bound is
# the larger of the bytes and 3 flops at this rate
TF32_FLOPS = 495e12
# and bf16 (f32 accumulation) on the tensor cores, dense: the peak that
# bounds a function of bf16 operands, whatever instructions it issues
BF16_FLOPS = 989e12
# the paper's MLP (32 -> 64 -> 64 -> 10): the width of a worker's row
PAPER_MLP_P = 6922

# the paper's configuration (benchmarks/run.py of the reference)
PAPER_CFG = FedHPConfig(num_workers=30, tau_init=8, tau_max=30, lr=0.15,
                        lr_decay=0.993, batch_size=32, seed=5)
PAPER_KW = dict(non_iid_p=0.4, spread=3.0)
# 20% sign-flip attackers on the paper's fleet, trimmed by their count
# (the reference's scenario benchmark, benchmarks/run.py:630-639)
BYZ = dict(tau_init=4, byzantine=(0, 5, 10, 15, 20, 25),
           byzantine_attack="signflip")
SPARSE = dict(gossip="sparse")
# the reference's large-W sparse leg (benchmarks/run.py:366-373): a
# W = 2,048 ring the dense [W, W] path cannot reach
BIG_CFG = FedHPConfig(num_workers=2048, rounds=3, tau_init=2, tau_max=4,
                      lr=0.1, batch_size=16, seed=5, base_topology="ring",
                      gossip="sparse")
BIG_KW = dict(non_iid_p=0.1, num_samples=65536)
BIG_ROUNDS = 3
# the fleet past 64 neighbours: 70 workers on a complete base (degree 69,
# the robust kernel's wide instance), two sign-flip attackers, trimmed:2
# (the case the port refused before the wide instance, ROADMAP.md); phase
# 4 runs it over erdos:0.95 (every worker still of degree 65-69): on a
# complete base every honest worker trims the same multiset and the
# engines' consensus metrics are f32 noise around zero
WIDE_FIELDS = dict(num_workers=70, byzantine=(0, 1), robust="trimmed:2",
                   base_topology="full")
WIDE_ROUNDS = 10
# the per-leaf codec maps: on the MLP the first layer's weights top-k,
# the biases raw, the rest int8; on the registry LM the reference's
# pytree leg's map (benchmarks/run.py:733-800)
LEAFMAP_MLP = "leafmap:w1=topk:0.1,b=none,default=int8"
LEAFMAP_LM = "leafmap:embed=randk:0.05,ln=none,default=int8"
# the batched seeds axis: 4 lanes, the first PAPER_CFG's own seed, for
# the static-plan strategies (an adaptive plan is one lane's feedback)
LANES = (5, 6, 7, 8)
LANE_PATHS = ("dpsgd", "ldsgd", "adpsgd")
LANE_TOL = 1e-5
# the main path's runs: (algorithm, config fields over PAPER_CFG)
MAIN_PATHS = (("fedhp", {}), ("dpsgd", {}), ("ldsgd", {}), ("pens", {}),
              ("fedhp", dict(compress="int8")),
              ("fedhp", dict(compress="topk:0.1")),
              ("fedhp", dict(compress="randk:0.1")),
              ("dpsgd", dict(compress="int8")),
              ("dpsgd", dict(compress="topk:0.1")),
              ("dpsgd", dict(compress="randk:0.1")),
              ("adpsgd", {}), ("adpsgd", dict(compress="int8")),
              ("fedhp", SPARSE),
              ("dpsgd", dict(SPARSE, base_topology="ring")),
              ("fedhp", dict(SPARSE, compress="int8")),
              ("dpsgd", dict(SPARSE, compress="topk:0.1")),
              ("dpsgd", BYZ), ("dpsgd", dict(BYZ, **SPARSE)),
              ("dpsgd", dict(BYZ, robust="trimmed:6")),
              ("dpsgd", dict(BYZ, **SPARSE, robust="trimmed:6")),
              ("fedhp", dict(BYZ, robust="trimmed:6")),
              ("dpsgd", dict(BYZ, **SPARSE, robust="median",
                             byzantine_attack="largenorm")),
              ("adpsgd", dict(BYZ, robust="screen:8")),
              ("fedhp", dict(compress=LEAFMAP_MLP)),
              ("dpsgd", dict(compress=LEAFMAP_MLP)),
              ("fedhp", dict(SPARSE, compress=LEAFMAP_MLP)),
              ("dpsgd", dict(SPARSE, compress=LEAFMAP_MLP)))
PARITY_PATHS = (("fedhp", {}), ("fedhp", dict(compress="int8")),
                ("fedhp", dict(compress="topk:0.1")), ("adpsgd", {}),
                ("adpsgd", dict(compress="int8")),
                ("fedhp", SPARSE), ("fedhp", dict(SPARSE, compress="int8")),
                ("dpsgd", dict(BYZ, **SPARSE, robust="trimmed:6")),
                # FedHP over a base that is not complete (degrees up to
                # 29: the D_PAD = 32 instance): on a complete graph every
                # honest worker trims the same multiset, their rows come
                # out identical, and the consensus metric of both engines
                # is f32 noise around zero (PERF.md, section 6)
                ("fedhp", dict(BYZ, robust="trimmed:6",
                               base_topology="erdos:0.9")),
                ("dpsgd", dict(BYZ, robust="median")),
                ("adpsgd", dict(BYZ, robust="screen:8")),
                ("fedhp", dict(WIDE_FIELDS, base_topology="erdos:0.95")),
                ("fedhp", dict(compress=LEAFMAP_MLP)))
# 10 timed rounds a path: the room phase 7's model-axis cases need within
# the script's time limit (a cut of the paths' rounds, PERF.md §4)
MAIN_ROUNDS = 10
WARMUP_ROUNDS = 2
PARITY_ROUNDS = 10

# the registry path: smollm-360m's published widths, its depth cut from 32
# to 4 layers and its vocabulary from 49,152 to 6,144 (make_token_data
# draws a dense V x V transition matrix per document class), trained in
# f32 with the flash-attention kernel in every forward pass
LM_MODEL = replace(smollm_360m.CONFIG, num_layers=4, vocab_size=6144,
                   dtype="float32", remat="none", use_flash_kernel=True)
LM_PARAMS = 45_228_480
# the spec that builds the same token corpus (the spec cannot tie the
# embeddings or turn the kernel on, so the run's adapter is built from
# LM_MODEL); S = 16 is the spec's default sequence length
LM_SPEC = "dense:d=960,layers=4,heads=15,kv=5,ff=2560,vocab=6144,seq=16"
LM_SEQ = 16
LM_CLASSES = 8
# the reference's quick-mode fleet (benchmarks/run.py:763-766)
LM_CFG = FedHPConfig(num_workers=8, tau_init=6, tau_max=12, lr=0.05,
                     seed=5, model=LM_SPEC)
LM_KW = dict(non_iid_p=0.4)
# the registry path's timed rounds (phase 3) and rounds held (phase 4):
# 2, part of the room phase 7's (h)-(j) need
LM_ROUNDS = 2
LM_WARMUP_ROUNDS = 1
# phase 4 over a sparse base (17 of 28 links at W = 8, seed 5): on a
# complete or near-complete mix (erdos:0.9, 27 links) the fleet ends the
# round 0.028 apart at P = 45 M, and the two engines' mixing formulas,
# which differ in the last ulp, move that distance by 2.8e-4 relative —
# past the 1e-4 of the parity contract; over this base the distance is
# 0.25-0.29 and they agree within 2e-6 (PERF.md, section 6, PR 14)
LM_PARITY_FIELDS = dict(base_topology="erdos:0.5")
# the moe, hybrid and xlstm families on the registry path: each at its
# published widths, its depth cut to the fewest blocks that run every
# block kind and its vocabulary to the path's 6,144, trained in f32 with
# the flash kernel on, under LM_CFG's settings apart from the fleet size
# W and, for zamba2 and xlstm, the learning rate: (arch, the config's
# depth fields, P, W, lr). W is 4 where the peak stays under about 70 GB
# of the card's 80, else 2 (zamba2 at W = 4 and 6 Mamba2 blocks: five
# [4, P] f32 matrices alone are 73.8 GB). At LM_CFG's lr 0.05
# xlstm-1.3b's loss turns NaN in both engines (its input gates exp(i) are
# unbounded, as in the reference), and at 0.05 (zamba2-7b) or 0.01
# (xlstm) the engines part by about 6e-4 in loss, past the parity
# contract, where the fused engine from a start moved by one ulp parts
# from itself by 1.3-1.8e-3 (tools/family_witness.py; PERF.md §6, at
# zamba2's 6 Mamba2 blocks and xlstm's 8 layers): there the trajectory
# itself amplifies the engines' last-ulp differences. Phase 4 holds at
# these lr.
# olmoe-1b-7b: one layer (attention at head width 128, 64 experts, 8 a
# token); zamba2-7b: one Mamba2 block and shared block A after it
# (ssm_every 1; attention at head width 112); xlstm-1.3b: one mLSTM and
# one sLSTM block (slstm_every 1; no attention): the room phase 7's
# (h)-(j) need; phase 7 (g) and (h) run a whole group of each (6 Mamba2
# blocks; 7 mLSTM blocks and an sLSTM) at published widths.
# kimi-k2-1t-a32b holds 17.16 G parameters in one layer, 68.6 GB in f32
# for one worker: phase 7 runs its family's model axis on olmoe-1b-7b
FAMILY_PATHS = (("olmoe-1b-7b", {"num_layers": 1}, 444_733_440, 4,
                 LM_CFG.lr),
                ("zamba2-7b", {"num_layers": 1, "ssm_every": 1},
                 533_077_968, 2, 0.01),
                ("xlstm-1.3b", {"num_layers": 2, "slstm_every": 1},
                 121_686_024, 4, 5e-4))
# phase 3 runs the family paths one round and phase 4 holds their two
# engines over one: the room the script's time limit leaves phase 7's
# model-axis runs (a cut of the paths' rounds, not of a width)
FAMILY_ROUNDS = 1
FAMILY_PARITY_ROUNDS = 1
# the registry path as published: smollm-360m at its own dtype (bf16
# leaves and activations, the flash kernel's bf16 instances) and
# activation-checkpoint policy ("block"), with LM_MODEL's cuts (depth 4
# of 32, vocabulary 6,144): the same P, a bf16 value in each f32 slot of
# the engines' [W, P] matrix
LM_BF16_MODEL = replace(LM_MODEL, dtype="bfloat16", remat="block")
LM_BF16_ROUNDS = 2
# the policies whose loss and gradients phase 3 holds bit-equal on one
# worker group of the bf16 path
REMAT_POLICIES = ("none", "dots", "block")
# phase 4 on the bf16 path: the engines' loss and consensus relative
# gaps. A bf16 path rounds every weight to 8 significand bits after each
# SGD step and gossip, so the engines' last-ulp differences in f32 (the
# reference mixes as sum_j w_ij x_j, the kernel as x_i + sum_j w_ij (x_j
# - x_i)) move a weight by a whole bf16 ulp where they straddle a
# rounding boundary. The bounds are the trajectory's own sensitivity:
# the fused engine from a start nudged by one bf16 ulp per weight parts
# from itself by 1.29e-5 in loss and 4.08e-4 in consensus (relative)
# after 2 rounds over erdos:0.5 (tools/family_witness.py
# smollm-360m-bf16:0.05:ref, on an H100 at 700 W; PERF.md §2), and the
# engines are held to twice that
BF16_LOSS_RTOL = 2.6e-5
BF16_CONSENSUS_RTOL = 8.2e-4
# Those bounds admit one unrounded write (it moves weights by less than
# the nudge does), so the engines' final bf16 parameters are also held
# bit-equal, as every run on the card has found them (PERF.md §2).

# the kernels' agreement with their plain versions where it is not
# bit-equality: flash attention reassociates the softmax sums (the
# reference's own flash tolerance, tests/test_kernels.py), consensus_dist
# sums in another order
FLASH_ATOL = FLASH_RTOL = 2e-5
CONSENSUS_RTOL = 1e-6
# the bf16 instances: each element within one bf16 ulp of the plain
# version (which rounds its f32 result once), or within FLASH_ATOL where
# an element is so near 0 that the two f32 results' own difference
# passes its ulp (tests/test_torch_kernels.py); at FLASH_CASES' shapes of
# the paths that run bf16 and the train shapes
FLASH_BF16_CASES = ("local-step", "measurement-group", "smollm-train",
                    "gemma3-local", "hd192", "zamba2-step", "zamba2-train",
                    "smollm-prefill", "gemma3-prefill-local",
                    "gemma3-prefill-global", "olmoe-prefill",
                    "zamba2-prefill", "qwen2-vl-prefill")
# reference vs fused on the card: the tests' tolerances
# (tests/test_torch_engine.py, tests/test_torch_codec_engine.py) — host
# fields exact; accuracy to one eval sample, loss and consensus to 1e-4
# relative, under int8 loss to 2e-3 and consensus to 1e-2 (a 1-ulp
# difference on a half-quantum boundary moves a coordinate by a quantum)
EXACT = ("round", "round_time", "waiting_time", "mean_tau", "num_links",
         "cumulative_time", "staleness")
ACC_ATOL = 1.0 / 512
REL_TOL = 1e-4
CONSENSUS_ATOL = 1e-6
INT8_LOSS_RTOL = 2e-3
INT8_CONSENSUS_RTOL = 1e-2


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing: CUDA events around a batch of launches queued behind a sleep
# kernel, so the device runs them back to back however slow the host is
# ---------------------------------------------------------------------------

# timing repeats of phase 2's small kernels (gossip_mix, the codecs,
# gossip_edges), cut from 50 for phase 7's room (ROADMAP queue 2 item 7)
PHASE2_REPS = 20


def _sleep_cycles_per_ms() -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cycles = 20_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn, cycles_per_ms: float, *, batch: int,
            reps: int = 50) -> float:
    """Median over ``reps`` batches of the device time per call of
    ``fn`` (each batch: ``batch`` calls between two CUDA events, queued
    behind a sleep kernel long enough to cover their enqueueing; keep
    ``batch`` times the kernels per call well under the launch queue)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batch):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(cycles_per_ms * (4.0 * host_ms + 2.0))
    per_call = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / batch)
    return statistics.median(per_call)


# ---------------------------------------------------------------------------
# phase 2: gossip_mix against its plain version
# ---------------------------------------------------------------------------

def _bound(nbytes: int, flops: int,
           peak: float = F32_FLOPS) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of device memory traffic and
    ``flops`` operations at ``peak`` FLOP/s (f32 outside the tensor cores
    unless given), and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def _mix_inputs(gen, b, k, length, main: bool):
    x = torch.randn(b, length, generator=gen, device="cuda")
    if main:
        # the main path: u = x, w = the uniform Eq. 6 mixing matrix of a
        # random connected topology, with departed workers' identity rows
        # (three of a larger fleet, one of the registry path's eight)
        rng = np.random.default_rng(7)
        adj = topo.erdos_topology(b, 0.3, rng)
        dead = rng.choice(b, 1 if b <= 8 else 3, replace=False)
        alive = np.ones(b, bool)
        alive[dead] = False
        adj = topo.repair_connectivity(adj, alive)
        w = torch.tensor(topo.mixing_matrix_uniform(adj), dtype=torch.float32,
                         device="cuda")
        return x, x, w, dead
    u = torch.randn(k, length, generator=gen, device="cuda")
    if k == 1:
        w = torch.full((b, k), 0.5, device="cuda")
    else:
        w = torch.rand(b, k, generator=gen, device="cuda") / k
    return x, u, w, ()


# (case, B, K, L, a fleet's mix with u = x): the MLP path's round (the
# kernel line's shape), an aligned and a short row, AD-PSGD's pair, a
# fleet of 100 (K past one staged chunk of 64 neighbours) and the
# registry path's round (W = 8, P = 45,228,480: u = x is 1.45 GB)
MIX_CASES = (("main", 30, 30, PAPER_MLP_P, True),
             ("aligned", 30, 30, 8192, False),
             ("short", 30, 30, 1000, False),
             ("adpsgd", 1, 1, PAPER_MLP_P, False),
             ("chunked", 100, 100, PAPER_MLP_P, True),
             ("registry", 8, 8, LM_PARAMS, True))


def check_gossip_mix(cycles_per_ms: float) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    main = None
    for name, b, k, length, is_main in MIX_CASES:
        x, u, w, dead = _mix_inputs(gen, b, k, length, is_main)
        y = ops.gossip_mix(x, u, w)
        y_ref = ref.gossip_mix_ref(x, u, w)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        if not torch.equal(y, y_ref):
            raise AssertionError(f"gossip_mix[{name}] differs from its plain "
                                 f"version: max |diff| = {err}")
        for i in dead:
            if not torch.equal(y[i], x[i]):
                raise AssertionError(f"gossip_mix[{name}]: identity row {i} "
                                     "is not an exact no-op")
        worst = max(worst, err)

        def library():
            # the whole function in library calls: the x * (1 - rowsum(w))
            # term, then one addmm
            return torch.addmm(x * (1.0 - w.sum(dim=1))[:, None], w, u)

        lib_err = float((library() - y_ref).abs().max())
        reps = 10 if name == "registry" else PHASE2_REPS
        kernel_ms = time_ms(lambda: ops.gossip_mix(x, u, w), cycles_per_ms,
                            batch=10, reps=reps)
        # the plain version is 3 K launches per call
        plain_ms = time_ms(lambda: ref.gossip_mix_ref(x, u, w),
                           cycles_per_ms, batch=2, reps=reps)
        library_ms = time_ms(library, cycles_per_ms, batch=10, reps=reps)
        # each input read once, y written once; on the main path u is x,
        # so its bytes are read once, as x's
        u_bytes = 0 if u.data_ptr() == x.data_ptr() else k * length
        nbytes = (2 * b * length + u_bytes + b * k) * 4
        flops = 3 * b * k * length
        bound_ms, bound_by = _bound(nbytes, flops)
        log("phase2", kernel="gossip_mix", case=name, B=b, K=k, L=length,
            bit_equal=True, max_abs_err=err, addmm_max_abs_diff=lib_err,
            ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            addmm_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
            bound_mb=f"{nbytes / 1e6:.6f}",
            share_of_bound=f"{bound_ms / kernel_ms:.4f}")
        if name == "main":
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        # the registry case's 1.45 GB rows are freed before phase 3
        del x, u, w, y, y_ref
        torch.cuda.empty_cache()
    return dict(name="gossip_mix", route="cuda",
                source="src/repro_torch/kernels/csrc/gossip_mix.cu",
                replaces="src/repro/kernels/gossip_mix.py:45",
                max_abs_err=worst, **main)


def check_gossip_mix_trainer(cycles_per_ms: float) -> list:
    """gossip_mix's bf16-rounded form at phase 7's shape (the trainer's
    matching gossip: x [4, TRAIN_P] of bf16 values, u = x, the complete
    graph's 3 matchings laid out matching-major, K = 12), bit-equal to its
    plain version on a column chunk, timed beside its library yardstick:
    x (1 - rowsum(w)) plus the matchings' weights folded to [4, 4] by x,
    one ``torch.addmm`` in f32 — the unrounded mix, which the bf16-rounded
    form's roundings part from. No kernel entry of its own (row 1's)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    adj = topo.make_base_topology(TRAIN_WORKERS, "full", TRAIN_SEED)
    pairs = collectives.matchings_as_pairs(adj)
    w = torch.from_numpy(collectives.matching_mix_weights(
        pairs, collectives.matching_weight_tables(
            adj, topo.mixing_matrix_uniform(adj)))).cuda()
    x = torch.randn(TRAIN_WORKERS, TRAIN_P, generator=gen, device="cuda") \
        .mul_(0.02).to(torch.bfloat16).float()
    y = ops.gossip_mix(x, x, w, round_bf16=True)
    cols = slice(0, HOLD_COLS)
    _require_equal("gossip_mix", "trainer-bf16round", [(
        y[:, cols], ref.gossip_mix_ref(x[:, cols].contiguous(),
                                       x[:, cols].contiguous(), w,
                                       round_bf16=True))])
    folded = torch.zeros(TRAIN_WORKERS, TRAIN_WORKERS, device="cuda")
    folded.index_add_(1, torch.arange(w.shape[1], device="cuda")
                      % TRAIN_WORKERS, w)

    def library():
        return torch.addmm(x * (1.0 - w.sum(dim=1))[:, None], folded, x)

    lib_gap = float((library() - y).abs().max())
    del y
    kernel_ms = time_ms(lambda: ops.gossip_mix(x, x, w, round_bf16=True),
                        cycles_per_ms, batch=2, reps=5)
    library_ms = time_ms(library, cycles_per_ms, batch=2, reps=5)
    nbytes = 2 * x.numel() * 4 + w.numel() * 4
    bound_ms, bound_by = _bound(nbytes, 5 * TRAIN_WORKERS * w.shape[1]
                                * TRAIN_P)
    log("phase2", kernel="gossip_mix", case="trainer-bf16round",
        B=TRAIN_WORKERS, K=w.shape[1], L=TRAIN_P, bit_equal_chunk=True,
        ms=f"{kernel_ms:.6f}", addmm_f32_ms=f"{library_ms:.6f}",
        addmm_max_abs_diff=lib_gap, bound_ms=f"{bound_ms:.6f}",
        bound_by=bound_by, share_of_bound=f"{bound_ms / kernel_ms:.4f}")
    del x, w
    torch.cuda.empty_cache()
    return []


# (case, S, B, K, L): the batched MLP round (4 lanes of the W = 30
# fleet, u = x, one mixing matrix shared by the lanes: the kernel line's
# shape), AD-PSGD's pairwise average (one row a lane) and both endpoints'
# rows (two)
MIX_LANE_CASES = (("lanes", len(LANES), 30, 30, PAPER_MLP_P),
                  ("adpsgd-lanes", len(LANES), 1, 1, PAPER_MLP_P),
                  ("pair-lanes", len(LANES), 2, 2, PAPER_MLP_P))


def check_gossip_mix_lanes(cycles_per_ms: float) -> dict:
    """gossip_mix's lane-strided form against its plain version and
    against one single-form launch a lane (both bit for bit), timed
    beside those S launches."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    main = None
    for name, lanes, b, k, length in MIX_LANE_CASES:
        if b == k > 2:
            x1, _, w, _ = _mix_inputs(gen, b, k, length, True)
            x = torch.stack([x1] + [torch.randn_like(x1)
                                    for _ in range(lanes - 1)])
            u = x
        else:
            x = torch.randn(lanes, b, length, generator=gen, device="cuda")
            u = torch.randn(lanes, k, length, generator=gen, device="cuda")
            w = torch.diag(torch.full((b,), 0.5, device="cuda")) \
                if b == k else torch.full((b, k), 0.5, device="cuda")
        wl = w.expand(lanes, b, k)
        y = ops.gossip_mix_lanes(x, u, wl)
        singles = torch.stack([ops.gossip_mix(x[s], u[s], w)
                               for s in range(lanes)])
        y_ref = ref.gossip_mix_lanes_ref(x, u, wl)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        if not (torch.equal(y, y_ref) and torch.equal(y, singles)):
            raise AssertionError(
                f"gossip_mix_lanes[{name}] differs from its plain version "
                f"or from {lanes} single launches: max |diff| = {err}, "
                f"{float((y - singles).abs().max())}")
        worst = max(worst, err)

        def separate():
            for s in range(lanes):
                ops.gossip_mix(x[s], u[s], w)

        def library():
            # the whole function in library calls: each lane's
            # x * (1 - rowsum(w)) term, then one baddbmm over the lanes
            return torch.baddbmm(x * (1.0 - wl.sum(dim=2))[:, :, None],
                                 wl, u)

        kernel_ms = time_ms(lambda: ops.gossip_mix_lanes(x, u, wl),
                            cycles_per_ms, batch=10)
        separate_ms = time_ms(separate, cycles_per_ms, batch=10)
        plain_ms = time_ms(lambda: ref.gossip_mix_lanes_ref(x, u, wl),
                           cycles_per_ms, batch=2)
        library_ms = time_ms(library, cycles_per_ms, batch=10)
        u_bytes = 0 if u.data_ptr() == x.data_ptr() else lanes * k * length
        nbytes = (2 * lanes * b * length + u_bytes + b * k) * 4
        bound_ms, bound_by = _bound(nbytes, 3 * lanes * b * k * length)
        log("phase2", kernel="gossip_mix_lanes", case=name, S=lanes, B=b,
            K=k, L=length, bit_equal=True, equal_to_single_launches=True,
            max_abs_err=err, ms=f"{kernel_ms:.6f}",
            single_launches_ms=f"{separate_ms:.6f}",
            plain_ms=f"{plain_ms:.6f}", baddbmm_ms=f"{library_ms:.6f}",
            bound_ms=f"{bound_ms:.6f}", bound_mb=f"{nbytes / 1e6:.6f}",
            share_of_bound=f"{bound_ms / kernel_ms:.4f}")
        if name == "lanes":
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
    return dict(name="gossip_mix_lanes", route="cuda",
                source="src/repro_torch/kernels/csrc/gossip_mix.cu",
                replaces="src/repro/kernels/gossip_mix.py:45",
                max_abs_err=worst, **main)


# ---------------------------------------------------------------------------
# phase 2: the wire codecs' kernels against their plain versions
# ---------------------------------------------------------------------------

def _require_equal(name: str, case: str, pairs) -> float:
    """Bit-equality of each (kernel, plain) output pair; returns the
    largest absolute difference (0.0)."""
    worst = 0.0
    for got, want in pairs:
        worst = max(worst, float((got.double() - want.double()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"{name}[{case}] differs from its plain "
                                 f"version: max |diff| = {worst}")
    return worst


# (case, W, P) of the codec kernels
# and the leaf segments a leafmap sends through them: one coordinate, the
# MLP's merged biases (138 < 1,024 columns) and its merged int8 leaves
# (4,736: 5 rows of 1,024, not a multiple of 8)
CODEC_CASES = (("main", 30, 6922), ("adpsgd", 2, 6922),
               ("tiles", 30, 100000), ("short", 30, 1000),
               ("odd", 30, 6921), ("single", 1, 6922),
               ("seg-p1", 30, 1), ("seg-narrow", 30, 138),
               ("seg-rows5", 30, 4736))


def sparsify_bytes(w: int, p: int, gate_rows: int) -> int:
    """sparsify_block's traffic: x, the gate (a row per worker, or one
    shared row) and the thresholds read once, y and the counts written
    once."""
    n_tiles = ref.wire_tiles(p)[2]
    return 8 * w * p + 4 * gate_rows * p + 4 * w + 4 * w * n_tiles


def check_codecs(cycles_per_ms: float) -> list[dict]:
    """quantize_block, dequantize_block and sparsify_block at the main
    path's [30, 6922] (one tile per worker), AD-PSGD's pair [2, 6922],
    [30, 100000] (13 tiles, the last ragged), [30, 1000], an odd P whose
    rows start on 4 bytes only ([30, 6921]) and one worker ([1, 6922]).
    Each quantize and sparsify line names its cluster size."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {name: dict(max_abs_err=0.0) for name in
           ("quantize_block", "dequantize_block", "sparsify_block")}

    def record(name, case, err, kernel_fn, plain_fn, library_fn, nbytes,
               flops, **extra):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        kernel_ms = time_ms(kernel_fn, cycles_per_ms, batch=10,
                            reps=PHASE2_REPS)
        plain_ms = time_ms(plain_fn, cycles_per_ms, batch=2, reps=PHASE2_REPS)
        library_ms = (time_ms(library_fn, cycles_per_ms, batch=10,
                              reps=PHASE2_REPS)
                      if library_fn is not None else None)
        bound_ms, bound_by = _bound(nbytes, flops)
        log("phase2", kernel=name, case=case, bit_equal=True,
            max_abs_err=err, ms=f"{kernel_ms:.6f}",
            plain_ms=f"{plain_ms:.6f}",
            library_ms="none" if library_ms is None else f"{library_ms:.6f}",
            bound_ms=f"{bound_ms:.6f}", bound_mb=f"{nbytes / 1e6:.6f}",
            **extra)
        return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by)

    for case, w, p in CODEC_CASES:
        x = 0.3 * torch.randn(w, p, generator=gen, device="cuda")
        row_len, tile_len, n_tiles = ref.wire_tiles(p)
        shape = dict(W=w, P=p, tiles=n_tiles)

        q, scales = ops.quantize_block(x)
        err = _require_equal("quantize_block", case,
                             zip((q, scales), ref.quantize_block_ref(x)))
        # x read once, q (the padded wire row) and the scales written
        # once; abs, max, divide, round and clamp per element
        cluster = ops.quantize_cluster(w, n_tiles, tile_len,
                                       ops.sm_count(x.device))
        main = record("quantize_block", case, err,
                      lambda: ops.quantize_block(x),
                      lambda: ref.quantize_block_ref(x), None,
                      4 * w * p + w * row_len + 4 * w * n_tiles,
                      6 * w * p, cluster=cluster, **shape)
        if case == "main":
            out["quantize_block"].update(main)

        y = ops.dequantize_block(q, scales, p)
        err = _require_equal("dequantize_block", case,
                             [(y, ref.dequantize_block_ref(q, scales, p))])
        # one library call computes q * scale where the wire row is whole
        # tiles (the main shape: one 7168-element tile): a broadcast
        # multiply over the padded grid, of which y is the first P columns
        library = None
        if row_len == n_tiles * tile_len:
            q3, s3 = q.view(w, n_tiles, tile_len), scales[:, :, None]

            def library():
                return torch.mul(q3, s3)
        # q's first P bytes of each row and the scales read once, y
        # written once; one multiply per element
        main = record("dequantize_block", case, err,
                      lambda: ops.dequantize_block(q, scales, p),
                      lambda: ref.dequantize_block_ref(q, scales, p),
                      library, w * p + 4 * w * n_tiles + 4 * w * p, w * p,
                      **shape)
        if case == "main":
            out["dequantize_block"].update(main)

        k = max(round(0.1 * p), 1)
        scores = torch.from_numpy(compression.randk_scores(
            compression.sparsify_base_key(5), 3, p)).to("cuda")
        for gate_name, gate in (("topk", x.abs()), ("randk", scores[None])):
            thresh = torch.topk(gate, k, dim=1).values[:, -1] \
                .expand(w).contiguous()
            err = _require_equal(
                "sparsify_block", f"{case}-{gate_name}",
                zip(ops.sparsify_block(x, gate, thresh),
                    ref.sparsify_block_ref(x, gate, thresh)))

            def library(gate=gate, thresh=thresh):
                # the select alone, without the per-tile counts
                return torch.where(gate >= thresh[:, None], x, 0.0)
            # a compare and a count per element
            main = record("sparsify_block", f"{case}-{gate_name}", err,
                          lambda gate=gate, thresh=thresh:
                          ops.sparsify_block(x, gate, thresh),
                          lambda gate=gate, thresh=thresh:
                          ref.sparsify_block_ref(x, gate, thresh),
                          library, sparsify_bytes(w, p, gate.shape[0]),
                          2 * w * p, k=k,
                          cluster=ops.sparsify_cluster(
                              w, n_tiles, tile_len, ops.sm_count(x.device)),
                          **shape)
            if case == "main" and gate_name == "topk":
                out["sparsify_block"].update(main)
    src = "src/repro_torch/kernels/csrc/"
    return [dict(name="quantize_block", route="cuda",
                 source=src + "quantize_block.cu",
                 replaces="src/repro/kernels/quantize_block.py:36",
                 **out["quantize_block"]),
            dict(name="dequantize_block", route="cuda",
                 source=src + "quantize_block.cu",
                 replaces="src/repro/kernels/quantize_block.py:70",
                 **out["dequantize_block"]),
            dict(name="sparsify_block", route="cuda",
                 source=src + "sparsify_block.cu",
                 replaces="src/repro/kernels/sparsify_block.py:38",
                 **out["sparsify_block"])]


def launch_floor(cycles_per_ms: float) -> float:
    """The device time (ms) of a launch that does next to nothing:
    ``dequantize_block`` at [1, 1] (one block, one element), timed as
    every kernel is. The share of a small kernel's time no redesign of
    its body can remove."""
    q, scales = ops.quantize_block(torch.ones(1, 1, device="cuda"))
    floor_ms = time_ms(lambda: ops.dequantize_block(q, scales, 1),
                       cycles_per_ms, batch=10)
    log("phase2", launch_floor_us=f"{floor_ms * 1e3:.4f}",
        kernel="dequantize_block", W=1, P=1)
    return floor_ms


# ---------------------------------------------------------------------------
# phase 2: the edge-list and robust gossip kernels
# ---------------------------------------------------------------------------

def _graph(w: int, spec: str, cut=(), pad: int = 0):
    """A ``spec`` graph on ``w`` workers (a base-topology spec, or
    ``star``: worker 0 joined to every other) with the workers in ``cut``
    isolated, its CSR edge list on the card (uniform weights; ``pad``
    zero-weight self-loops at vertex 0 appended first, as the reference
    pads) and its adjacency."""
    if spec == "star":
        adj = np.zeros((w, w), np.int8)
        adj[0, 1:] = adj[1:, 0] = 1
    else:
        adj = topo.make_base_topology(w, spec, 5)
    for i in cut:
        adj[i, :] = adj[:, i] = 0
    e = topo.edges_from_adj(adj)
    src, dst, wts = topo.directed_edges(e, topo.edge_mixing_weights(e, w))
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    wts = np.concatenate([wts, np.zeros(pad, np.float32)])
    csr = [torch.from_numpy(a).to("cuda")
           for a in topo.edges_to_csr(src, dst, wts, w)]
    return adj, csr


def _lying(x: torch.Tensor) -> torch.Tensor:
    """The transmitted copy with every fifth row sign-flipped."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return torch.where(rows % 5 == 0, -x, x)


# (case, W, base, cut workers, padding edges, P, offset): the W = 30
# full graph (870 directed edges) and a ring with padding edges and an
# isolated worker, the staged instance's limit (ops.EDGES_STAGED_MAX_ROWS
# workers) and one worker past it on a ``ba:2`` graph, an odd P (rows
# start on 4 bytes), x whose storage starts 4 bytes before its rows
# (offset 1; the lying wire's t 8 bytes), a W = 300 star (in-degree 299
# at the hub), the W = 2,048 ring (4,096 edges) and a W = 2,048 ``ba:2``
# graph (hubs of in-degree up to 149)
EDGES_CASES = (("full30", 30, "full", (), 0, PAPER_MLP_P, 0),
               ("ring30-pad", 30, "ring", (3,), 8, PAPER_MLP_P, 0),
               ("staged-limit", ops.EDGES_STAGED_MAX_ROWS, "ba:2", (), 0,
                PAPER_MLP_P, 0),
               ("staged-limit+1", ops.EDGES_STAGED_MAX_ROWS + 1, "ba:2", (),
                0, PAPER_MLP_P, 0),
               ("odd30", 30, "full", (), 0, PAPER_MLP_P - 1, 0),
               ("offset30", 30, "full", (), 0, PAPER_MLP_P, 1),
               ("star300", 300, "star", (), 0, PAPER_MLP_P, 0),
               ("ring2048", 2048, "ring", (), 0, PAPER_MLP_P, 0),
               ("ba2048", 2048, "ba:2", (), 0, PAPER_MLP_P, 0))


# timing repeats of gossip_edges' kernel and library call, and of its
# plain version
EDGES_REPS = PHASE2_REPS
EDGES_PLAIN_REPS = 10


def edges_inputs(gen, w: int, spec: str, cut, pad: int, p: int,
                 offset: int):
    """An EDGES_CASES case on the card -> (csr, x, the lying wire's t):
    x [W, P] random, t with every fifth row sign-flipped; with an offset,
    x starts ``offset`` floats into its storage and t twice as far, so
    the two differ in alignment."""
    _, csr = _graph(w, spec, cut, pad)
    if not offset:
        x = torch.randn(w, p, generator=gen, device="cuda")
        return csr, x, _lying(x)
    x = torch.randn(w * p + offset, generator=gen,
                    device="cuda")[offset:].view(w, p)
    t = torch.empty(w * p + 2 * offset, device="cuda")[2 * offset:]
    return csr, x, t.view(w, p).copy_(_lying(x))


def edges_bound(w: int, p: int, n_edges: int, t_is_x: bool) -> tuple:
    """(bound ms, what binds, bytes): x read once (t too when it is not
    x), the CSR arrays read once, y written once; a subtract, multiply
    and add per edge and column."""
    nbytes = ((2 * w + (0 if t_is_x else w)) * p + (w + 1)
              + 2 * n_edges) * 4
    return (*_bound(nbytes, 3 * n_edges * p), nbytes)


def check_gossip_edges(cycles_per_ms: float) -> dict:
    """gossip_edges on each of EDGES_CASES, honest (t = x) and over a
    lying wire; each line names the instance that ran."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, main = 0.0, None
    for case, w, spec, cut, pad, p, offset in EDGES_CASES:
        csr, x, lying = edges_inputs(gen, w, spec, cut, pad, p, offset)
        row_ptr, col, wts = csr
        n_edges = int(row_ptr[-1])
        max_in = int((row_ptr[1:] - row_ptr[:-1]).max())
        lib_a = torch.sparse_csr_tensor(row_ptr.long(), col[:n_edges].long(),
                                        wts[:n_edges], size=(w, w))
        ones = torch.ones(w, 1, device="cuda")
        for wire, t in (("honest", x), ("lying", lying)):
            name = f"{case}-{wire}"
            y = ops.gossip_edges(x, t, *csr)
            err = _require_equal("gossip_edges", name,
                                 [(y, ref.gossip_edges_ref(x, t, *csr))])
            for i in cut:
                if not torch.equal(y[i], x[i]):
                    raise AssertionError(f"gossip_edges[{name}]: row {i} "
                                         "without edges changed")
            worst = max(worst, err)

            def library(t=t):
                # the whole function in library calls: the CSR
                # off-diagonal weights times t, plus x (1 - rowsum)
                return torch.sparse.mm(lib_a, t) + \
                    x * (1.0 - torch.sparse.mm(lib_a, ones))
            lib_err = float((library() - y).abs().max())
            # the plain version syncs the host on every call
            kernel_ms = time_ms(lambda t=t: ops.gossip_edges(x, t, *csr),
                                cycles_per_ms, batch=10, reps=EDGES_REPS)
            plain_ms = time_ms(lambda t=t: ref.gossip_edges_ref(x, t, *csr),
                               cycles_per_ms, batch=2, reps=EDGES_PLAIN_REPS)
            library_ms = time_ms(library, cycles_per_ms, batch=10,
                                 reps=EDGES_REPS)
            bound_ms, bound_by, nbytes = edges_bound(w, p, n_edges, t is x)
            log("phase2", kernel="gossip_edges", case=name,
                instance=ops.edges_instance(w), W=w, P=p, E=n_edges,
                max_in_degree=max_in, offset=offset, bit_equal=True,
                max_abs_err=err, sparse_mm_max_abs_diff=lib_err,
                ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
                sparse_mm_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
                bound_by=bound_by, bound_mb=f"{nbytes / 1e6:.6f}",
                share_of_bound=f"{bound_ms / kernel_ms:.4f}")
            if name == "full30-honest":
                main = dict(ms=kernel_ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        del x, lying, t, y, lib_a
        torch.cuda.empty_cache()
    return dict(name="gossip_edges", route="cuda",
                source="src/repro_torch/kernels/csrc/gossip_edges.cu",
                replaces="src/repro/kernels/gossip_edges.py:66",
                max_abs_err=worst, **main)


@functools.lru_cache(maxsize=None)
def _sort_compare_exchanges(cnt: int) -> int:
    """The compare-exchanges that sorting a window of ``cnt`` values needs:
    Batcher's odd-even merge sort for the next power of two, less every
    compare-exchange that touches a slot at or past ``cnt`` (those slots
    would hold +inf, which no compare-exchange moves). The count the
    function needs, whatever network an instance runs (543 at 64 values,
    against a bitonic network's 672)."""
    n = 1 << max(cnt - 1, 0).bit_length()
    count, p = 0, 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p) and \
                            i + j + k < cnt:
                        count += 1
            k //= 2
        p *= 2
    return count


# (case, W, base, cut workers, workers whose degree is set to 0, P, the
# table's width or 0): the main path's W = 30 full graph (D_PAD = 32),
# a W = 30 ``erdos:0.3`` graph (degrees 2 to 10 once workers 1 and 7
# are cut: the sparser bases FedHP's controller builds) in a table
# padded to D_PAD = 32, as the fused engine pads a segment's tables to
# its widest (each block sorts its own worker's window), and the
# W = 2,048 ring (D_PAD = 2), register instances; full graphs of 66,
# 130 and 300 (D = 65, 129 and 299) and a W = 1,000 ``ba:2`` graph (a
# table 102 wide, half its workers of degree 2: each block sorts its own
# worker's window), the wide instance; a full graph of 1,100 (D = 1,099,
# N = 2,048) at P = 256, the shared instance, narrow so that the plain
# version's [W, D + 1, P] window stays near 1.2 GB. Worker 7's degree is
# zeroed so the table keeps its width. A width of 0 is D's, rounded up
# to a power of two for the register instance
ROBUST_CASES = (("full30", 30, "full", (1, 7), (), PAPER_MLP_P, 0),
                ("mixed30", 30, "erdos:0.3", (1, 7), (), PAPER_MLP_P, 32),
                ("ring2048", 2048, "ring", (1, 7), (), PAPER_MLP_P, 0),
                ("full66", 66, "full", (), (7,), PAPER_MLP_P, 0),
                ("full130", 130, "full", (), (7,), PAPER_MLP_P, 0),
                ("full300", 300, "full", (), (7,), PAPER_MLP_P, 0),
                ("ba1000", 1000, "ba:2", (), (7,), PAPER_MLP_P, 0),
                ("full1100", 1100, "full", (), (7,), 256, 0))


# the robust modes phase 2 runs on every table: trimmed by a count and
# by a fraction, and the median
ROBUST_MODES = (("trimmed", 6.0), ("trimmed", 0.2), ("median", 0.0))


def robust_table(w: int, spec: str, cut, zeroed, width: int = 0):
    """A ROBUST_CASES table on the card -> (nbr, deg, the instance a
    launch runs, the compare-exchanges that sorting one column's windows
    needs, each window of its own deg + 1 values: degree-0 rows sort
    nothing). The table is padded to ``width``, or where that is 0 the
    register instance's to D_PAD, as the fused engine pads it."""
    adj, _ = _graph(w, spec, cut=cut)
    nbr_np, deg_np = robust.neighbor_table(adj)
    deg_np[list(zeroed)] = 0
    if not width and ops.robust_instance(nbr_np.shape[1]) == "register":
        width = _pow2(nbr_np.shape[1])
    nbr_np = np.pad(nbr_np, ((0, 0), (0, max(width - nbr_np.shape[1], 0))))
    kind = ops.robust_instance(nbr_np.shape[1])
    exchanges = sum(_sort_compare_exchanges(int(k) + 1)
                    for k in deg_np if k > 0)
    nbr, deg = (torch.from_numpy(a).to("cuda") for a in (nbr_np, deg_np))
    return nbr, deg, kind, exchanges


def robust_bound(w: int, p: int, d: int, exchanges: int) -> tuple:
    """(bound ms, what binds, bytes): x and t read once, the table and
    the degrees read once, y written once; a min and a max per
    compare-exchange of every column."""
    nbytes = (3 * w * p + w * d + w) * 4
    return (*_bound(nbytes, 2 * exchanges * p), nbytes)


def check_robust_gossip(cycles_per_ms: float) -> dict:
    """robust_gossip with ROBUST_MODES on each of ROBUST_CASES, with every
    fifth row sign-flipped in t and rows of degree 0."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, main = 0.0, None
    for case, w, spec, cut, zeroed, p, width in ROBUST_CASES:
        nbr, deg, kind, exchanges = robust_table(w, spec, cut, zeroed, width)
        d = nbr.shape[1]
        instance = f"{kind} D={d}"
        x = torch.randn(w, p, generator=gen, device="cuda")
        t = _lying(x)
        reps = 20 if kind == "register" else 5
        for mode, b in ROBUST_MODES:
            name = f"{case}-{mode}:{b:g}"
            y = ops.robust_gossip(x, t, nbr, deg, b=b, mode=mode)
            err = _require_equal("robust_gossip", name, [
                (y, ref.robust_gossip_ref(x, t, nbr, deg, b=b, mode=mode))])
            for i in (*cut, *zeroed):
                if not torch.equal(y[i], x[i]):
                    raise AssertionError(f"robust_gossip[{name}]: degree-0 "
                                         f"row {i} changed")
            worst = max(worst, err)
            mask = (torch.arange(d, device="cuda")[None, :]
                    < deg[:, None].long())[:, :, None]
            cnt = deg.long() + 1

            def composition(mode=mode, b=b):
                # no single PyTorch call computes it: gather, sort, then
                # the window's masked sum (or the middle pair)
                win = torch.cat([x[:, None], torch.where(
                    mask, t[nbr.long()], float("inf"))], dim=1)
                sv = torch.sort(win, dim=1).values
                if mode == "median":
                    lo = ((cnt - 1) // 2)[:, None, None].expand(w, 1, p)
                    hi = (cnt // 2)[:, None, None].expand(w, 1, p)
                    y = 0.5 * (sv.gather(1, lo) + sv.gather(1, hi))[:, 0]
                else:
                    bi = robust.resolve_trim(b, cnt)
                    pos = torch.arange(d + 1, device="cuda")[None, :, None]
                    inside = (pos >= bi[:, None, None]) & \
                        (pos < (cnt - bi)[:, None, None])
                    y = torch.where(inside, sv, 0.0).sum(dim=1) / \
                        (cnt - 2 * bi).float()[:, None]
                return torch.where((deg > 0)[:, None], y, x)
            comp_err = float((composition() - y).abs().max())
            kernel_ms = time_ms(
                lambda mode=mode, b=b: ops.robust_gossip(x, t, nbr, deg, b=b,
                                                         mode=mode),
                cycles_per_ms, batch=10, reps=reps)
            plain_ms = time_ms(
                lambda mode=mode, b=b: ref.robust_gossip_ref(
                    x, t, nbr, deg, b=b, mode=mode), cycles_per_ms, batch=1,
                reps=3)
            comp_ms = time_ms(composition, cycles_per_ms, batch=1, reps=3)
            bound_ms, bound_by, nbytes = robust_bound(w, p, d, exchanges)
            log("phase2", kernel="robust_gossip", case=name,
                instance=repr(instance), W=w, P=p, D=d, bit_equal=True,
                max_abs_err=err, composition_max_abs_diff=comp_err,
                ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
                composition_ms=f"{comp_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
                bound_by=bound_by, bound_mb=f"{nbytes / 1e6:.6f}",
                compare_exchanges=exchanges * p,
                share_of_bound=f"{bound_ms / kernel_ms:.4f}")
            if name == "full30-trimmed:6":
                main = dict(ms=kernel_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by)
        del x, t, y
        torch.cuda.empty_cache()
    return dict(name="robust_gossip", route="cuda",
                source="src/repro_torch/kernels/csrc/robust_gossip.cu",
                replaces="src/repro/kernels/robust_gossip.py:101",
                max_abs_err=worst, **main)


# ---------------------------------------------------------------------------
# phase 2: flash attention and consensus distance
# ---------------------------------------------------------------------------

# (case, B, S, Hq, Hkv, hd, causal, window, main), S = Sk: the registry
# path's launches (S = 15, the next-token inputs of 16-token sequences):
# a local SGD step (W = 8 workers x 32 sequences), one group of the
# measurement stack (2 workers x 2,048 sequences: the engines compute the
# stack's gradients 2 workers a pass, ModelAdapter.workers_per_pass; the
# fleet metrics' 8 x 512 sequences are the same B) and the whole stack in
# one launch (8 x 2,048); smollm-360m's train shape, a gemma3-27b local
# layer, a nemotron-4 head width (192) and the forced causal rule
# (non-causal, S not a multiple of 128); the short-sequence kernel's
# dispatch limit at hd 64 (Sk = FLASH_SHORT_MAX_KEYS[64]) and one key
# past it, a non-causal Sk = 128 (a multiple of 128, so no mask is
# forced) and a sliding window inside the short kernel's reach; then head
# width 112: zamba2-7b's attention on its path (32 heads, no grouping: a
# local step of W = 2 workers x 32 sequences and a measurement pass of one
# worker on the W x 256 eval stack), zamba2-7b's and kimi-k2's (64 / 8
# heads) train shape at S = 4,096 (the tile kernel), and the short
# kernel's dispatch limit at hd 112 and one key past it; then the serving
# prefills of phase 5 (the tile kernel): smollm-360m (B = 8, S = 1,024),
# gemma3-27b's local (window 1,024) and global layers (B = 2, S = 2,048),
# olmoe-1b-7b (16 heads of 128, S = 512), zamba2-7b's shared attention
# (hd 112, S = 512) and qwen2-vl-2b (12 / 2 heads of 128, S = 1,024)
FLASH_CASES = (("local-step", 256, 15, 15, 5, 64, True, 0, False),
               ("measurement-group", 4096, 15, 15, 5, 64, True, 0, True),
               ("measurement-stack", 16384, 15, 15, 5, 64, True, 0, False),
               ("smollm-train", 2, 4096, 15, 5, 64, True, 0, False),
               ("gemma3-local", 1, 4096, 32, 16, 128, True, 1024, False),
               ("hd192", 1, 1000, 96, 8, 192, True, 0, False),
               ("forced-causal", 4, 100, 6, 2, 64, False, 0, False),
               ("short-limit", 256, ops.FLASH_SHORT_MAX_KEYS[64], 15, 5, 64,
                True, 0, False),
               ("short-limit+1", 256, ops.FLASH_SHORT_MAX_KEYS[64] + 1, 15,
                5, 64, True, 0, False),
               ("noncausal-128", 64, 128, 15, 5, 64, False, 0, False),
               ("short-window", 64, ops.FLASH_SHORT_MAX_KEYS[128], 32, 16,
                128, True, 16, False),
               ("zamba2-step", 64, 15, 32, 32, 112, True, 0, False),
               ("zamba2-measure", 512, 15, 32, 32, 112, True, 0, False),
               ("zamba2-train", 1, 4096, 32, 32, 112, True, 0, False),
               ("kimi-k2-train", 1, 4096, 64, 8, 112, True, 0, False),
               ("short-limit-hd112", 64, ops.FLASH_SHORT_MAX_KEYS[112], 32,
                32, 112, True, 0, False),
               ("short-limit+1-hd112", 64, ops.FLASH_SHORT_MAX_KEYS[112] + 1,
                32, 32, 112, True, 0, False),
               ("smollm-prefill", 8, 1024, 15, 5, 64, True, 0, False),
               ("gemma3-prefill-local", 2, 2048, 32, 16, 128, True, 1024,
                False),
               ("gemma3-prefill-global", 2, 2048, 32, 16, 128, True, 0,
                False),
               ("olmoe-prefill", 4, 512, 16, 16, 128, True, 0, False),
               ("zamba2-prefill", 4, 512, 32, 32, 112, True, 0, False),
               ("qwen2-vl-prefill", 4, 1024, 12, 2, 128, True, 0, False))


def check_flash_attention(cycles_per_ms: float,
                          dtype: torch.dtype = torch.float32) -> dict:
    """The flash instances of ``dtype`` against the plain version: in f32
    at every one of ``FLASH_CASES``, each element within ``FLASH_ATOL``
    + ``FLASH_RTOL`` |y|; in bf16 at ``FLASH_BF16_CASES``, each element
    within one bf16 ulp (or ``FLASH_ATOL`` near 0), with the share of
    elements that differ. Each case logs the kernel's, the plain
    version's and ``scaled_dot_product_attention``'s times in that dtype
    and the bound: the bytes at the dtype's element size over HBM's rate,
    against the operations at the dtype's peak (f32 FMAs outside the
    tensor cores, or bf16's dense tensor-core rate). ``tc_bound_ms`` is a
    diagnostic beside it: the operations the tile instance issues on the
    tensor cores (in f32 three TF32 products per product, 3xTF32, at
    TF32's rate; in bf16 one product for q k^T and two for p v, p split
    hi / lo, at bf16's rate). In bf16 the short instance and the tile
    instance (its own kernel, ``flash_attention_bf16.cu``) are two
    entries of the kernels line: the short one at the measurement
    group, the tile one at smollm-360m's train shape."""
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5 if bf16 else 4)
    cases = [c for c in FLASH_CASES if not bf16 or c[0] in FLASH_BF16_CASES]
    elem, peak, tc_products, tc_peak = (2, BF16_FLOPS, 1.5, BF16_FLOPS) \
        if bf16 else (4, F32_FLOPS, 3.0, TF32_FLOPS)
    suffix = "/bf16" if bf16 else ""
    worst, main, tile_worst, tile_main = 0.0, None, 0.0, None
    for case, b, s, hq, hkv, hd, causal, window, is_main in cases:
        q, k, v = (torch.randn(b, s, h, hd, generator=gen, device="cuda")
                   .to(dtype) for h in (hq, hkv, hkv))
        forced = causal or s % 128 != 0
        y = ops.flash_attention(q, k, v, causal=causal, window=window)
        y_ref = ref.flash_attention_ref(q, k, v, causal=forced,
                                        window=window)
        torch.cuda.synchronize()
        if y.dtype != dtype:
            raise AssertionError(f"flash_attention[{case}{suffix}] returned "
                                 f"{y.dtype}")
        diff = (y.float() - y_ref.float()).abs()
        tol = ref.bf16_ulp(y_ref).clamp_min(FLASH_ATOL) if bf16 else \
            FLASH_ATOL + FLASH_RTOL * y_ref.abs()
        err = float(diff.max())
        if not bool((diff <= tol).all()):      # a NaN fails too
            raise AssertionError(
                f"flash_attention[{case}{suffix}] differs from its plain "
                f"version past " + ("one bf16 ulp" if bf16 else "2e-5")
                + f": max |diff| = {err}")
        worst = max(worst, err)
        extra = dict(share_differ=f"{float((diff > 0).float().mean()):.6f}")
        if bf16:
            extra["share_past_one_ulp"] = \
                f"{float((diff > ref.bf16_ulp(y_ref)).float().mean()):.2e}"
        mask = ref.attention_mask(s, s, causal=forced, window=window,
                                  device="cuda")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            # one PyTorch call: scaled_dot_product_attention over the
            # [B, H, S, hd] views, GQA by its own head grouping
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask if window else None,
                is_causal=forced and not window, enable_gqa=True)
        lib_err = float((library().transpose(1, 2).float()
                         - y_ref.float()).abs().max())
        heavy = s >= 1000
        kernel_ms = time_ms(
            lambda: ops.flash_attention(q, k, v, causal=causal,
                                        window=window), cycles_per_ms,
            batch=2 if heavy else 5, reps=10 if heavy else 20)
        plain_ms = time_ms(
            lambda: ref.flash_attention_ref(q, k, v, causal=forced,
                                            window=window), cycles_per_ms,
            batch=1, reps=3 if heavy else 5)
        library_ms = time_ms(library, cycles_per_ms, batch=2 if heavy else 5,
                             reps=10 if heavy else 20)
        # q, k and v read once, o written once; two products of 2 hd
        # operations per (query, key in reach) pair and query head
        pairs = int(mask.sum())
        nbytes = (2 * b * s * hq * hd + 2 * b * s * hkv * hd) * elem
        flops = 4 * b * hq * hd * pairs
        bound_ms, bound_by = _bound(nbytes, flops, peak)
        tc_ms = max(nbytes / HBM_BYTES_PER_S,
                    tc_products * flops / tc_peak) * 1e3
        instance = ops.flash_instance(q, k, v)
        log("phase2", kernel="flash_attention", case=case + suffix,
            instance=instance, B=b, S=s, Hq=hq,
            Hkv=hkv, hd=hd, causal=forced, window=window,
            max_abs_err=err, sdpa_max_abs_diff=lib_err, **extra,
            ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            sdpa_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
            bound_by=bound_by, tc_bound_ms=f"{tc_ms:.6f}",
            bound_mb=f"{nbytes / 1e6:.6f}", gflop=f"{flops / 1e9:.6f}",
            tflops=f"{flops / kernel_ms / 1e9:.3f}",
            share_of_bound=f"{bound_ms / kernel_ms:.4f}",
            share_of_tc_bound=f"{tc_ms / kernel_ms:.4f}")
        timed = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by=bound_by)
        if is_main:
            main = timed
        if bf16 and instance == "tile":
            tile_worst = max(tile_worst, err)
            if case == "smollm-train":
                tile_main = timed
        del q, k, v, y, y_ref, mask, diff, tol
        torch.cuda.empty_cache()
    tag = "bf16" if bf16 else "f32"
    out = [dict(name="flash_attention" + ("_bf16" if bf16 else ""),
                route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:77",
                max_abs_err=worst, count_key=f"flash_attention:{tag}",
                **main)]
    if bf16:
        out.append(dict(
            name="flash_attention_bf16_tile", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
            replaces="src/repro/kernels/flash_attention.py:77",
            max_abs_err=tile_worst, count_key="flash_attention:bf16_tile",
            **tile_main))
    return out


def check_consensus_dist(cycles_per_ms: float) -> dict:
    """consensus_dist at the reference kernel benchmark's shape (L = 2^17,
    K = 4) and at phase 7's, its path (worker 0's row against its
    partners in the 3 matchings of a complete graph of 4, L =
    361,821,120: the trainer's measured distances), neighbours near x:
    1e-6 relative, and the same bits on a second run."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst, main = 0.0, None
    for case, k, length in (("kernel-bench", 4, 2 ** 17),
                            ("trainer", TRAIN_WORKERS - 1, TRAIN_P)):
        x = torch.randn(length, generator=gen, device="cuda")
        u = x + 0.1 * torch.randn(k, length, generator=gen, device="cuda")
        d = ops.consensus_dist(x, u)
        d_ref = ref.consensus_dist_ref(x, u)
        rel = float(((d - d_ref).abs() / d_ref).max())
        if rel > CONSENSUS_RTOL or not torch.equal(d, ops.consensus_dist(x,
                                                                         u)):
            raise AssertionError(f"consensus_dist[{case}]: relative "
                                 f"difference {rel} or not repeatable")
        err = float((d - d_ref).abs().max())
        worst = max(worst, err)

        def library():
            return torch.linalg.vector_norm(u - x, dim=1)
        lib_rel = float(((library() - d_ref).abs() / d_ref).max())
        kernel_ms = time_ms(lambda: ops.consensus_dist(x, u), cycles_per_ms,
                            batch=5, reps=20)
        plain_ms = time_ms(lambda: ref.consensus_dist_ref(x, u),
                           cycles_per_ms, batch=2, reps=10)
        library_ms = time_ms(library, cycles_per_ms, batch=2, reps=10)
        # x and u read once, the K distances written once; a subtract, a
        # multiply and an add per element of u
        nbytes = ((k + 1) * length + k) * 4
        bound_ms, bound_by = _bound(nbytes, 3 * k * length)
        log("phase2", kernel="consensus_dist", case=case, K=k, L=length,
            max_rel_err=rel, max_abs_err=err, vector_norm_max_rel_diff=lib_rel,
            ms=f"{kernel_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
            vector_norm_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
            bound_by=bound_by, bound_mb=f"{nbytes / 1e6:.6f}")
        if case == "trainer":
            main = dict(ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        del x, u
        torch.cuda.empty_cache()
    return dict(name="consensus_dist", route="cuda",
                source="src/repro_torch/kernels/csrc/consensus_dist.cu",
                replaces="src/repro/kernels/consensus_dist.py:37",
                max_abs_err=worst, **main)


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def _codec_launches(cfg: FedHPConfig, adapter) -> dict[str, int]:
    """The codec kernels one exchange launches: per int8 segment one
    quantize and one dequantize, per top-k or rand-k segment one
    sparsify (a uniform codec is one segment; a leafmap's segments come
    from its map compiled against the adapter's leaf layout)."""
    codec = engine.run_codec(cfg, adapter)
    kinds = ([seg.codec.kind for seg in codec.segments]
             if codec.kind == "leafmap" else [codec.kind])
    out = {k: 0 for k in ops.LAUNCHES}
    for kind in kinds:
        if kind == "int8":
            out["quantize_block"] += 1
            out["dequantize_block"] += 1
        elif kind in ("topk", "randk"):
            out["sparsify_block"] += 1
    return out


def _expected_launches(algo: str, cfg: FedHPConfig, hist,
                       lanes: int = 1) -> dict[str, int]:
    """What a fused run must launch, per communicating round (per event
    for AD-PSGD, where every round holds W events) and nothing else:

    - trimmed/median (dense or sparse gossip): one robust_gossip;
    - attackers without a robust mode: one gossip_mix (dense) or one
      gossip_edges (sparse) over the lying wire;
    - a codec: one quantize and one dequantize per int8 segment, one
      sparsify per top-k and rand-k segment (a uniform codec is one
      segment, a leafmap has several), and under sparse gossip one
      gossip_edges for the mixing delta;
    - honest and uncompressed: one gossip_mix (dense) or gossip_edges
      (sparse);
    - AD-PSGD: one gossip_mix per event uncompressed, over a lying wire
      or screened (both endpoints' rows in one launch), the codec's
      kernels under a codec.

    With ``lanes`` > 1 every one of these launches once for all lanes,
    gossip_mix in its lane-strided form (``gossip_mix_lanes``)."""
    arr = hist.as_arrays()
    n = (len(hist.records) * cfg.num_workers if algo == "adpsgd"
         else int((arr["num_links"] > 0).sum()))
    sparse = cfg.gossip == "sparse" and algo != "adpsgd"
    mix = "gossip_mix" if lanes == 1 else "gossip_mix_lanes"
    per = {k: 0 for k in ops.LAUNCHES}
    if cfg.robust.partition(":")[0] in ("trimmed", "median"):
        per["robust_gossip"] = 1
    elif cfg.compress == "none":
        per["gossip_edges" if sparse else mix] = 1
    else:
        per = _codec_launches(cfg, modelspec.adapter_for(cfg))
        if sparse:
            per["gossip_edges"] = 1
    return {k: n * v for k, v in per.items()}


def _label(algo: str, fields: dict) -> str:
    """algo/field=value/...: the attackers by their count, the signflip
    default and the Byzantine legs' tau 4 left out."""
    parts = [algo]
    for k, v in fields.items():
        if k == "byzantine":
            parts.append(f"byzantine={len(v)}")
        elif (k, v) not in (("byzantine_attack", "signflip"),
                            ("tau_init", 4)):
            parts.append(f"{k}={v}")
    return "/".join(parts)


def _timed_run(algo: str, cfg: FedHPConfig, rounds: int, warmup: int,
               **kw):
    """A warm-up run, then the timed run with the launch counters zeroed
    just before it and read just after -> (histories, seconds, counts):
    one History, or one per lane under ``seeds``."""
    # warm-up: the first use of cuBLAS and autograd on the card is not
    # the algorithm's (rounds/s below still include set-up)
    run_algorithm(algo, cfg, rounds=warmup, fused=True, **kw)
    torch.cuda.synchronize()
    for counts in (ops.LAUNCHES, ops.INSTANCE_LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    hist = run_algorithm(algo, cfg, rounds=rounds, fused=True, **kw)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return hist, elapsed, dict(ops.LAUNCHES)


def _check_run(name: str, algo: str, cfg: FedHPConfig, rounds: int, hists,
               counts: dict) -> None:
    lanes = len(hists)
    expected = _expected_launches(algo, cfg, hists[0], lanes)
    if counts != expected:
        raise AssertionError(f"{name}: launched {counts}, the path must "
                             f"launch {expected}")
    inst = ops.INSTANCE_LAUNCHES
    for kernel in ("robust_gossip", "gossip_edges"):
        if sum(v for k, v in inst.items() if k.startswith(f"{kernel}:")) \
                != counts[kernel]:
            raise AssertionError(f"{name}: {kernel} instances {inst} do "
                                 f"not add up to {counts[kernel]}")
    # every sparse round of a fleet runs one gossip_edges instance: the
    # staged one at W = 30, the gather one on the W = 2,048 ring (lanes
    # run as one block-diagonal fleet of lanes x W rows)
    want = f"gossip_edges:{ops.edges_instance(cfg.num_workers * lanes)}"
    if inst[want] != counts["gossip_edges"]:
        raise AssertionError(f"{name}: gossip_edges launched {inst}, all "
                             f"{counts['gossip_edges']} must be {want}")
    # a round whose plan has a worker of degree past 64 (round 0 of a
    # complete base of 70) takes the wide instance, registers and shuffles
    if cfg.num_workers - 1 > ops.ROBUST_REGISTER_MAX_DEGREE and \
            cfg.base_topology == "full" and cfg.robust not in ("none", "") \
            and inst["robust_gossip:wide"] == 0:
        raise AssertionError(f"{name}: the wide robust_gossip instance "
                             "never launched")
    for hist in hists:
        _check_history(name, cfg, rounds, hist)
    # the lanes share the host control plane and differ on the device
    for hist in hists[1:]:
        a, b = hists[0].as_arrays(), hist.as_arrays()
        if not all(np.array_equal(a[k], b[k]) for k in EXACT):
            raise AssertionError(f"{name}: lanes differ in host fields")
        if np.array_equal(a["loss"], b["loss"]):
            raise AssertionError(f"{name}: two lanes ran the same "
                                 "experiment")


def _check_history(name: str, cfg: FedHPConfig, rounds: int, hist) -> None:
    """The run's records: as many as its rounds, finite metrics, finite
    final parameters of every worker, and rejections where it screens."""
    arr = hist.as_arrays()
    if len(hist.records) != rounds:
        raise AssertionError(f"{name}: {len(hist.records)} records")
    for key in ("accuracy", "loss", "consensus"):
        if not np.isfinite(arr[key]).all():
            raise AssertionError(f"{name}: non-finite {key}")
    for leaf_name, leaf in hist.final_params.items():
        if leaf.shape[0] != cfg.num_workers or \
                not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{name}: bad final {leaf_name}")
    if cfg.robust.startswith("screen") and not sum(hist.screen_rejects):
        raise AssertionError(f"{name}: screening rejected nothing")


def run_main_path() -> dict[str, int]:
    """Phase 3; returns the launches of each kernel summed over the
    timed runs."""
    total = {k: 0 for k in ops.LAUNCHES}
    legs = [(algo, fields, replace(PAPER_CFG, **fields), MAIN_ROUNDS,
             WARMUP_ROUNDS, PAPER_KW) for algo, fields in MAIN_PATHS]
    legs.append(("dpsgd", dict(num_workers=2048, **SPARSE), BIG_CFG,
                 BIG_ROUNDS, 1, BIG_KW))
    legs.append(("fedhp", WIDE_FIELDS, replace(PAPER_CFG, **WIDE_FIELDS),
                 WIDE_ROUNDS, 1, PAPER_KW))
    legs += [(algo, dict(seeds=len(LANES)), PAPER_CFG, MAIN_ROUNDS,
              WARMUP_ROUNDS, dict(PAPER_KW, seeds=LANES))
             for algo in LANE_PATHS]
    for algo, fields, cfg, rounds, warmup, kw in legs:
        name = _label(algo, fields)
        out, elapsed, counts = _timed_run(algo, cfg, rounds, warmup, **kw)
        hists = out if isinstance(out, list) else [out]
        _check_run(name, algo, cfg, rounds, hists, counts)
        for k in total:
            total[k] += counts[k]
        hist = hists[0]
        arr = hist.as_arrays()
        extra = ({} if hist.screen_rejects is None
                 else dict(screen_rejects=hist.screen_rejects))
        for kernel, key in (("robust_gossip", "robust_instances"),
                            ("gossip_edges", "edges_instances")):
            if counts[kernel]:
                extra[key] = {k.split(":")[1]: v
                              for k, v in ops.INSTANCE_LAUNCHES.items()
                              if k.startswith(f"{kernel}:")}
        if len(hists) > 1:
            extra["lane_final_accuracy"] = [
                f"{h.final_accuracy:.6f}" for h in hists]
        if cfg.compress.startswith("leafmap:"):
            codec = engine.run_codec(cfg, modelspec.adapter_for(cfg))
            extra["segments"] = [f"{seg.codec.mode}:{seg.size}"
                                 for seg in codec.segments]
            extra["wire_ratio"] = f"{codec.wire_ratio():.6f}"
        log("phase3", path=name, rounds=rounds,
            comm_rounds=int((arr["num_links"] > 0).sum()),
            launches={k: v for k, v in counts.items() if v},
            rounds_per_s=f"{rounds / elapsed:.3f}",
            seconds_per_round=f"{elapsed / rounds:.4f}",
            seconds=f"{elapsed:.3f}",
            final_accuracy=f"{hist.final_accuracy:.6f}",
            final_loss=f"{arr['loss'][-1]:.6f}",
            sim_time=f"{arr['cumulative_time'][-1]:.3f}", **extra)
    return total


class _PlanRecorder:
    """Wraps a strategy and keeps each round's taus as the engines apply
    them (clipped to [1, tau_max] on the alive workers, 0 elsewhere)."""

    def __init__(self, inner, tau_max: int):
        self.inner = inner
        self.name = inner.name
        self.adaptive = getattr(inner, "adaptive", False)
        self.tau_max = tau_max
        self.taus: list[np.ndarray] = []

    def plan(self, h, alive=None):
        p = self.inner.plan(h, alive=alive)
        live = np.ones(len(p.taus), bool) if alive is None else alive
        self.taus.append(np.where(live, np.clip(p.taus, 1, self.tau_max), 0))
        return p

    def observe(self, h, **kw):
        self.inner.observe(h, **kw)


def _pow2(v: int) -> int:
    return 1 << (v - 1).bit_length() if v > 1 else 1


def _lm_forwards(adapter, cfg: FedHPConfig, taus: list[np.ndarray],
                 adaptive: bool) -> int:
    """The model forward passes a fused run must make (fused.py's
    _scan_segment): per round its segment's tau extent (the largest tau
    of the segment, rounded up to a power of two; a segment is one round
    for an adaptive strategy, the whole run here for a static one) of
    local SGD steps, the fleet metrics' accuracy and loss, and for an
    adaptive strategy the three measurement gradients (the eval stack
    twice, the probe once); a gradient pass on a batch runs in
    ceil(W / workers_per_pass) groups of workers. Under an
    activation-checkpoint policy (``cfg.remat`` of the adapter's model
    other than "none") each gradient pass runs its blocks' forward once
    more, in the backward pass."""
    w, s = cfg.num_workers, adapter.seq_len

    def groups(*shape):
        x = torch.zeros(1, dtype=torch.int32).expand(*shape)
        return -(-w // adapter.workers_per_pass(x))

    again = 2 if adapter.cfg.remat != "none" else 1
    local = again * groups(w, cfg.batch_size, s)
    measure = again * (2 * groups(w, w, 256, s) + groups(w, w, 32, s))
    caps = ([_pow2(int(max(t.max(), 1))) for t in taus] if adaptive else
            [_pow2(int(max(max(t.max() for t in taus), 1)))] * len(taus))
    return sum(cap * local + 2 + (measure if adaptive else 0)
               for cap in caps)


def _lm_data():
    """The registry path's corpus, test split and shards, once: from the
    spec through the user's entry point (``setup_experiment``)."""
    t0 = time.perf_counter()
    train, tx, ty, shards, _ = setup_experiment(LM_CFG, device="cuda",
                                                **LM_KW)
    return (train, tx, ty, shards), time.perf_counter() - t0


def _lm_run(adapter, data, algo: str, rounds: int, *, fused_engine: bool,
            init_params=None, mesh=None, **fields):
    """One registry-path run from a fresh cluster (which prices a model
    transfer at the trained model's size) and strategy, from
    ``init_params`` (the engines' ``init_params``) or the seed's weights,
    sharded over ``mesh`` when one is given -> (history, the recorded
    taus)."""
    cfg = replace(LM_CFG, algorithm=algo, **fields)
    train, tx, ty, shards = data
    cluster = SimCluster(cfg.num_workers, model_bits=adapter.model_bits,
                         seed=cfg.seed)
    strategy = _PlanRecorder(make_strategy(cfg, topo.make_base_topology(
        cfg.num_workers, cfg.base_topology, cfg.seed)), cfg.tau_max)
    run = fused.run_dfl_fused if fused_engine else engine.run_dfl
    hist = run(train, tx, ty, shards, cluster, cfg, strategy, rounds=rounds,
               adapter=adapter, init_params=init_params, mesh=mesh,
               device="cuda")
    return hist, strategy.taus


def lm_adapter(model=LM_MODEL):
    """The registry path's adapter (``model``: LM_MODEL in f32, or
    LM_BF16_MODEL as published)."""
    adapter = modelspec.RegistryAdapter(
        model, LM_SEQ, LM_CLASSES,
        spec=f"smollm-360m:layers=4,vocab=6144,flash,{model.dtype},"
             f"remat={model.remat}")
    if adapter.param_count != LM_PARAMS:
        raise AssertionError(f"registry path: P = {adapter.param_count}")
    return adapter


def _zero_counts() -> None:
    for counts in (ops.LAUNCHES, ops.INSTANCE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _read_counts() -> dict[str, int]:
    """The kernel launches and flash_attention's by operand dtype."""
    return {**ops.LAUNCHES,
            **{k: v for k, v in ops.INSTANCE_LAUNCHES.items()
               if k.startswith("flash_attention:")}}


def run_lm_path(adapter, data) -> tuple[dict[str, int], dict[str, float]]:
    """Phase 3's registry path: FedHP and D-PSGD through the fused
    engine, and FedHP under the reference's per-leaf codec map, a warm-up
    run and then the timed run, each held to exactly the flash_attention
    launches (layers x forward passes) and the gossip launches
    (communicating rounds: one gossip_mix uncompressed, the map's codec
    kernels per segment under the leafmap) the path must make -> (the
    launches, uncompressed FedHP's seconds a round and peak memory)."""
    total = dict.fromkeys(_read_counts(), 0)
    fedhp = {}
    uniform_int8 = compression.parse_mode("int8").wire_ratio(LM_PARAMS)
    for algo, fields in (("fedhp", {}), ("dpsgd", {}),
                         ("fedhp", dict(compress=LEAFMAP_LM))):
        _lm_run(adapter, data, algo, LM_WARMUP_ROUNDS, fused_engine=True,
                **fields)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        hist, taus = _lm_run(adapter, data, algo, LM_ROUNDS,
                             fused_engine=True, **fields)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        arr = hist.as_arrays()
        adaptive = algo == "fedhp"
        forwards = _lm_forwards(adapter, LM_CFG, taus, adaptive)
        comm = int((arr["num_links"] > 0).sum())
        cfg = replace(LM_CFG, **fields)
        if fields:
            expected = {k: comm * v for k, v in
                        _codec_launches(cfg, adapter).items()}
        else:
            expected = {k: 0 for k in ops.LAUNCHES}
            expected["gossip_mix"] = comm
        expected["flash_attention"] = LM_MODEL.num_layers * forwards
        name = f"{algo}/smollm-360m-4l" + ("/leafmap" if fields else "")
        if counts != expected:
            raise AssertionError(f"{name}: launched {counts}, the path must "
                                 f"launch {expected}")
        _check_history(name, LM_CFG, LM_ROUNDS, hist)
        for k, v in _read_counts().items():
            total[k] += v
        if algo == "fedhp" and not fields:
            fedhp.update(
                seconds_per_round=elapsed / LM_ROUNDS,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        extra = {}
        if fields:
            codec = engine.run_codec(cfg, adapter)
            # the host's share of a round: the rand-k segment's mask draw
            # (a numpy threefry over its 5.9 M coordinates)
            t0 = time.perf_counter()
            compression.leafmap_scores(
                codec, compression.sparsify_base_key(cfg.seed), 0)
            extra = dict(map=LEAFMAP_LM,
                         segments=[f"{seg.codec.mode}:{seg.size}"
                                   for seg in codec.segments],
                         randk_draw_s=f"{time.perf_counter() - t0:.4f}",
                         wire_ratio=f"{codec.wire_ratio():.6f}",
                         uniform_int8_wire_ratio=f"{uniform_int8:.6f}")
        log("phase3", path=name, rounds=LM_ROUNDS, P=adapter.param_count,
            launches={k: v for k, v in counts.items() if v},
            forward_passes=forwards,
            seconds_per_round=f"{elapsed / LM_ROUNDS:.4f}",
            seconds=f"{elapsed:.3f}",
            first_accuracy=f"{arr['accuracy'][0]:.9f}",
            last_accuracy=f"{arr['accuracy'][-1]:.9f}",
            first_loss=f"{arr['loss'][0]:.7f}",
            last_loss=f"{arr['loss'][-1]:.7f}",
            mean_tau=arr["mean_tau"].tolist(),
            num_links=arr["num_links"].tolist(),
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
            **extra)
    return total, fedhp


def run_lm_bf16_path(data, f32_fedhp: dict[str, float]) -> dict[str, int]:
    """Phase 3's registry path as published (``LM_BF16_MODEL``): FedHP
    through the fused engine, a warm-up round and the timed rounds, held
    to exactly the flash_attention launches (all bf16: layers x the
    forward passes, a gradient pass's twice under remat="block") and one
    gossip_mix a communicating round, with its seconds a round and peak
    memory beside the f32 path's (``f32_fedhp``, from ``run_lm_path``);
    bf16 leaves in the final parameters."""
    adapter = lm_adapter(LM_BF16_MODEL)
    _lm_run(adapter, data, "fedhp", LM_WARMUP_ROUNDS, fused_engine=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    hist, taus = _lm_run(adapter, data, "fedhp", LM_BF16_ROUNDS,
                         fused_engine=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    arr = hist.as_arrays()
    forwards = _lm_forwards(adapter, LM_CFG, taus, adaptive=True)
    expected = {k: 0 for k in ops.LAUNCHES}
    expected["gossip_mix"] = int((arr["num_links"] > 0).sum())
    expected["flash_attention"] = LM_BF16_MODEL.num_layers * forwards
    name = "fedhp/smollm-360m-4l/bf16/remat=block"
    if counts != expected or \
            ops.INSTANCE_LAUNCHES["flash_attention:bf16"] != \
            expected["flash_attention"]:
        raise AssertionError(f"{name}: launched {counts} "
                             f"({ops.INSTANCE_LAUNCHES}), the path must "
                             f"launch {expected}, all flash in bf16")
    _check_history(name, LM_CFG, LM_BF16_ROUNDS, hist)
    dtypes = {str(v.dtype) for v in hist.final_params.values()}
    if dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"{name}: final leaves in {dtypes}")
    log("phase3", path=name, rounds=LM_BF16_ROUNDS, P=adapter.param_count,
        launches={k: v for k, v in counts.items() if v},
        flash_bf16_launches=ops.INSTANCE_LAUNCHES["flash_attention:bf16"],
        flash_launches_per_layer=forwards,
        seconds_per_round=f"{elapsed / LM_BF16_ROUNDS:.4f}",
        f32_seconds_per_round=f"{f32_fedhp['seconds_per_round']:.4f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        f32_peak_gb=f"{f32_fedhp['peak_gb']:.3f}",
        first_loss=f"{arr['loss'][0]:.7f}",
        last_loss=f"{arr['loss'][-1]:.7f}",
        mean_tau=arr["mean_tau"].tolist(),
        num_links=arr["num_links"].tolist())
    total = _read_counts()
    del hist
    check_remat_policies(adapter, data)
    return total


def check_remat_policies(adapter, data) -> None:
    """On one worker group of the bf16 path's measurement pass (the
    workers ``workers_per_pass`` gives the W x 256 eval stack, on that
    stack), the loss and gradients under each of ``REMAT_POLICIES``, held
    bit-equal to "none"'s (a policy only chooses what is kept and what
    is computed again), and each policy's peak memory."""
    train, _, _, _ = data
    n = LM_CFG.num_workers
    seqs = torch.as_tensor(train.x[:n * 256], device="cuda")
    stack = seqs[None].expand(n, *seqs.shape)
    group = adapter.workers_per_pass(stack)
    x = stack[:group]
    y = torch.zeros(x.shape[:2], dtype=torch.long, device="cuda")
    p0 = adapter.init(torch.Generator().manual_seed(LM_CFG.seed))
    flat = adapter.flatten({k: v.expand(group, *v.shape)
                            for k, v in p0.items()}).to("cuda")
    del p0
    results, peaks = {}, {}
    for policy in REMAT_POLICIES:
        ad = lm_adapter(replace(LM_BF16_MODEL, remat=policy))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        results[policy] = engine._loss_and_grad(ad, flat, x, y)
        torch.cuda.synchronize()
        peaks[policy] = (torch.cuda.max_memory_allocated() - base) / 1e9
    diffs = {policy: max(float((a - b).abs().max()) for a, b in
                         zip(results[policy], results["none"]))
             for policy in REMAT_POLICIES}
    equal = {p: all(torch.equal(a, b) for a, b in zip(results[p],
                                                      results["none"]))
             for p in REMAT_POLICIES}
    log("phase3", path="remat/smollm-360m-4l/bf16", workers=group,
        sequences=int(x.shape[1]), max_abs_diff_from_none=diffs,
        bit_equal=equal,
        peak_gb_above_params={p: f"{v:.3f}" for p, v in peaks.items()})
    if not all(equal.values()):
        raise AssertionError(f"remat policies differ from 'none': {diffs}")
    del results, flat
    torch.cuda.empty_cache()


def _depth_tag(depth: dict) -> str:
    """A path name's depth: ``layers=N`` and any other depth field."""
    return ",".join(f"{'layers' if k == 'num_layers' else k}={v}"
                    for k, v in depth.items())


def family_adapter(arch: str, depth: dict, params: int):
    """``arch``'s published widths at ``depth`` (its config's depth
    fields), with the registry path's vocabulary, in f32 with the flash
    kernel on."""
    cfg = replace(get_config(arch), vocab_size=LM_MODEL.vocab_size,
                  dtype="float32", remat="none", use_flash_kernel=True,
                  **depth)
    adapter = modelspec.RegistryAdapter(
        cfg, LM_SEQ, LM_CLASSES,
        spec=f"{arch}:{_depth_tag(depth)},vocab={cfg.vocab_size},flash")
    if adapter.param_count != params:
        raise AssertionError(f"{arch}: P = {adapter.param_count}, the "
                             f"reference's is {params}")
    return adapter


def _fleet_data(data, num_workers: int):
    """The registry corpus and test split with the shards of a fleet of
    ``num_workers`` (``setup_experiment``'s partition at LM_CFG's seed)."""
    train, tx, ty, _ = data
    shards = pskew_partition(train.y, num_workers, LM_KW["non_iid_p"],
                             np.random.default_rng(LM_CFG.seed + 1))
    return train, tx, ty, shards


def run_family_paths(data) -> dict[str, int]:
    """Phase 3 for the moe, hybrid and xlstm families: FedHP through the
    fused engine at each family's published widths (``FAMILY_PATHS``),
    the timed rounds with no warm-up run (the first round also pays the
    family's first use of its shapes), held to exactly the
    flash_attention launches (the family's attention calls a forward x
    forward passes: olmoe one a layer, zamba2 one a group, xlstm none)
    and one gossip_mix a communicating round."""
    total = dict.fromkeys(_read_counts(), 0)
    for arch, depth, params, w, lr in FAMILY_PATHS:
        adapter = family_adapter(arch, depth, params)
        fdata = _fleet_data(data, w)
        cfg = replace(LM_CFG, num_workers=w, lr=lr)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        hist, taus = _lm_run(adapter, fdata, "fedhp", FAMILY_ROUNDS,
                             fused_engine=True, num_workers=w, lr=lr)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        arr = hist.as_arrays()
        forwards = _lm_forwards(adapter, cfg, taus, adaptive=True)
        expected = {k: 0 for k in ops.LAUNCHES}
        expected["gossip_mix"] = int((arr["num_links"] > 0).sum())
        expected["flash_attention"] = \
            registry.attention_calls(adapter.cfg) * forwards
        name = f"fedhp/{arch}:{_depth_tag(depth)}"
        if counts != expected:
            raise AssertionError(f"{name}: launched {counts}, the path must "
                                 f"launch {expected}")
        _check_history(name, cfg, FAMILY_ROUNDS, hist)
        for k, v in _read_counts().items():
            total[k] += v
        stack = torch.zeros(1, dtype=torch.int32).expand(w, w, 256, LM_SEQ)
        log("phase3", path=name, rounds=FAMILY_ROUNDS, W=w, lr=lr,
            P=adapter.param_count, launches={k: v for k, v in counts.items()
                                             if v},
            forward_passes=forwards,
            attention_calls_per_forward=registry.attention_calls(
                adapter.cfg),
            eval_workers_per_pass=adapter.workers_per_pass(stack),
            seconds_per_round=f"{elapsed / FAMILY_ROUNDS:.4f}",
            seconds=f"{elapsed:.3f}",
            first_loss=f"{arr['loss'][0]:.7f}",
            last_loss=f"{arr['loss'][-1]:.7f}",
            mean_tau=arr["mean_tau"].tolist(),
            num_links=arr["num_links"].tolist(),
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        del hist
        torch.cuda.empty_cache()
    return total


def check_family_engines_agree(data) -> None:
    """Phase 4 for the moe, hybrid and xlstm families: FedHP through both
    engines at each family's published widths, over the registry path's
    ``erdos:0.5`` base, ``FAMILY_PARITY_ROUNDS`` rounds."""
    for arch, depth, params, w, lr in FAMILY_PATHS:
        adapter = family_adapter(arch, depth, params)
        fdata = _fleet_data(data, w)
        hists, secs = {}, {}
        for fused_engine in (False, True):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            hists[fused_engine], _ = _lm_run(
                adapter, fdata, "fedhp", FAMILY_PARITY_ROUNDS,
                fused_engine=fused_engine, num_workers=w, lr=lr,
                **LM_PARITY_FIELDS)
            torch.cuda.synchronize()
            secs[fused_engine] = time.perf_counter() - t0
            log("phase4", path=f"fedhp/{arch}:{_depth_tag(depth)}",
                engine="fused" if fused_engine else "reference",
                peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
            # the first engine's final [W, P] parameters wait on the host
            # while the second runs, in the memory the first had
            hist = hists[False]
            hist.final_params = {k: v.to("cpu" if not fused_engine
                                         else "cuda")
                                 for k, v in hist.final_params.items()}
        _compare_engines(f"fedhp/{arch}:{_depth_tag(depth)}/W={w}/"
                         "erdos:0.5", hists, secs, int8=False,
                         rounds=FAMILY_PARITY_ROUNDS)
        del hists
        torch.cuda.empty_cache()


def check_lm_engines_agree(adapter, data) -> None:
    """Phase 4 on the registry path: FedHP through both engines,
    uncompressed and under the reference's per-leaf codec map."""
    for fields in ({}, dict(compress=LEAFMAP_LM)):
        hists, secs = {}, {}
        for fused_engine in (False, True):
            t0 = time.perf_counter()
            hists[fused_engine], _ = _lm_run(adapter, data, "fedhp",
                                             LM_ROUNDS,
                                             fused_engine=fused_engine,
                                             **LM_PARITY_FIELDS, **fields)
            torch.cuda.synchronize()
            secs[fused_engine] = time.perf_counter() - t0
        _compare_engines("fedhp/smollm-360m-4l/erdos:0.5"
                         + ("/leafmap" if fields else ""), hists, secs,
                         int8=bool(fields), rounds=LM_ROUNDS)


def check_lm_bf16_engines_agree(data) -> None:
    """Phase 4 on the registry path as published: FedHP through both
    engines over ``erdos:0.5``, host fields equal, accuracy within one
    eval sample, loss and consensus within the bf16 bounds
    (``BF16_LOSS_RTOL``, ``BF16_CONSENSUS_RTOL``), and the final
    parameters bit-equal: both engines round every bf16 leaf after each
    SGD step and gossip, so their f32 last-bit differences vanish in the
    rounding here, and an engine that left one write unrounded parts
    from the other by a bf16 ulp."""
    adapter = lm_adapter(LM_BF16_MODEL)
    hists, secs = {}, {}
    for fused_engine in (False, True):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        hists[fused_engine], _ = _lm_run(adapter, data, "fedhp",
                                         LM_BF16_ROUNDS,
                                         fused_engine=fused_engine,
                                         **LM_PARITY_FIELDS)
        torch.cuda.synchronize()
        secs[fused_engine] = time.perf_counter() - t0
    name = "fedhp/smollm-360m-4l/bf16/remat=block/erdos:0.5"
    _compare_engines(name, hists, secs, int8=False, rounds=LM_BF16_ROUNDS,
                     loss_rtol=BF16_LOSS_RTOL,
                     consensus_rtol=BF16_CONSENSUS_RTOL)
    gap = history_gaps(hists[False], hists[True])["params"]
    if gap != 0.0:
        raise AssertionError(f"{name}: final parameters differ by {gap}")


def check_lanes_agree() -> None:
    """Phase 4 for the batched seeds axis: each lane of a D-PSGD, LD-SGD
    and AD-PSGD run of ``LANES`` against its single-lane run (host fields
    equal, device metrics within ``LANE_TOL``), and the cfg.seed lane
    against the unbatched run."""
    for algo in LANE_PATHS:
        t0 = time.perf_counter()
        lanes = run_algorithm(algo, PAPER_CFG, rounds=PARITY_ROUNDS,
                              fused=True, seeds=LANES, **PAPER_KW)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        pairs = [(f"seed {s}", hv, run_algorithm(
            algo, PAPER_CFG, rounds=PARITY_ROUNDS, fused=True, seeds=[s],
            **PAPER_KW)[0]) for s, hv in zip(LANES, lanes)]
        pairs.append(("unbatched", lanes[0], run_algorithm(
            algo, PAPER_CFG, rounds=PARITY_ROUNDS, fused=True, **PAPER_KW)))
        worst = 0.0
        for what, hv, hi in pairs:
            a, b = hv.as_arrays(), hi.as_arrays()
            for k in EXACT:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"{algo} lanes, {what}: host field "
                                         f"{k} differs")
            diff = max(float(np.abs(a[k] - b[k]).max())
                       for k in ("accuracy", "loss", "consensus"))
            if diff > LANE_TOL:
                raise AssertionError(f"{algo} lanes, {what}: device metrics "
                                     f"differ by {diff}")
            worst = max(worst, diff)
        log("phase4", path=f"{algo}/seeds={len(LANES)}",
            rounds=PARITY_ROUNDS, host_fields_equal=True,
            lanes_vs_single_max_abs_diff=worst,
            batched_s=f"{batched_s:.3f}")


def check_engines_agree() -> None:
    """Phase 4: each PARITY_PATHS run through both engines."""
    for algo, fields in PARITY_PATHS:
        cfg = replace(PAPER_CFG, replan_every=1, **fields)
        hists, secs = {}, {}
        for fused_engine in (False, True):
            t0 = time.perf_counter()
            hists[fused_engine] = run_algorithm(
                algo, cfg, rounds=PARITY_ROUNDS, fused=fused_engine,
                **PAPER_KW)
            secs[fused_engine] = time.perf_counter() - t0
        _compare_engines(_label(algo, fields), hists, secs,
                         int8="int8" in cfg.compress, rounds=PARITY_ROUNDS)


def history_gaps(ha, hb) -> dict:
    """How far run ``hb`` is from run ``ha``: the largest accuracy
    difference, loss and consensus differences relative to ``ha``'s, and
    the largest difference of their final parameters (where the engines'
    mixing formulas part: the reference mixes as sum_j w_ij x_j, the
    kernel as x_i + sum_j w_ij (x_j - x_i))."""
    a, b = ha.as_arrays(), hb.as_arrays()
    gaps = {k: float((np.abs(a[k] - b[k])
                      / np.maximum(np.abs(a[k]), 1e-12)).max())
            for k in ("loss", "consensus")}
    gaps["acc"] = float(np.abs(a["accuracy"] - b["accuracy"]).max())
    gaps["params"] = max(float((ha.final_params[k].double()
                                - hb.final_params[k].double().to(
                                    ha.final_params[k].device))
                               .abs().max())
                         for k in ha.final_params)
    return gaps


def _compare_engines(name: str, hists: dict, secs: dict, *, int8: bool,
                     rounds: int, loss_rtol: float | None = None,
                     consensus_rtol: float | None = None) -> None:
    """Reference (``hists[False]``) against fused (``hists[True]``): host
    fields and rejection counts equal, device metrics within the tests'
    tolerances (or ``loss_rtol`` / ``consensus_rtol`` where given); logs
    the differences."""
    if loss_rtol is None:
        loss_rtol = INT8_LOSS_RTOL if int8 else REL_TOL
    if consensus_rtol is None:
        consensus_rtol = INT8_CONSENSUS_RTOL if int8 else REL_TOL
    a, b = hists[False].as_arrays(), hists[True].as_arrays()
    for k in EXACT:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{name}: host field {k} differs: "
                                 f"{a[k]} vs {b[k]}")
    if hists[False].screen_rejects != hists[True].screen_rejects:
        raise AssertionError(
            f"{name}: screen rejections differ: "
            f"{hists[False].screen_rejects} vs "
            f"{hists[True].screen_rejects}")
    gaps = history_gaps(hists[False], hists[True])
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_ATOL, err_msg=name)
    np.testing.assert_allclose(a["loss"], b["loss"], err_msg=name,
                               rtol=loss_rtol)
    np.testing.assert_allclose(
        a["consensus"], b["consensus"], atol=CONSENSUS_ATOL,
        rtol=consensus_rtol, err_msg=name)
    # the rounds that pass only through the absolute term, with both
    # engines' consensus values there
    cdiff = np.abs(a["consensus"] - b["consensus"])
    worst = int(np.argmax(cdiff))
    abs_only = np.nonzero(cdiff > consensus_rtol * np.abs(b["consensus"]))[0]
    extra = ({} if hists[True].screen_rejects is None
             else dict(screen_rejects=hists[True].screen_rejects))
    log("phase4", path=name, rounds=rounds,
        host_fields_equal=True, acc_max_abs_diff=gaps["acc"],
        loss_max_rel_diff=gaps["loss"],
        consensus_max_rel_diff=gaps["consensus"],
        consensus_max_abs_diff=float(cdiff[worst]), at_round=worst,
        consensus_there=[float(a["consensus"][worst]),
                         float(b["consensus"][worst])],
        rounds_admitted_by_atol=abs_only.tolist(),
        param_max_abs_diff=gaps["params"],
        reference_s=f"{secs[False]:.3f}", fused_s=f"{secs[True]:.3f}",
        mean_tau=a["mean_tau"].tolist(),
        num_links=a["num_links"].tolist(), **extra)


# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------

# the served models: (arch, B, prompt, generated, the f32 check's cut).
# Each serves at its published config, whole (every layer, the full
# vocabulary), in bf16 with the flash kernel on where the family attends
# (``SERVE_SEED``'s random weights, built on the card); whisper's prompt
# is the serve rule's: 8 x 188 = 1,504 frames (whisper's 30 s window is
# 1,500) and a 23-token decoder prompt. The f32 teacher-forced check cuts
# depth to the fewest layers that run every block kind (fields over the
# published config; None: the whole model): gemma3 one group of 5 local
# layers and a global one plus the 2-layer tail, zamba2 one group of 6
# Mamba2 blocks and shared block A, xlstm 7 mLSTM blocks and an sLSTM one
SERVE_MODELS = (
    ("smollm-360m", 8, 1024, 32, None),
    ("gemma3-27b", 2, 2048, 16, dict(num_layers=8)),
    ("olmoe-1b-7b", 4, 512, 16, dict(num_layers=1)),
    ("zamba2-7b", 4, 512, 16, dict(num_layers=6)),
    ("xlstm-1.3b", 4, 512, 16, dict(num_layers=8)),
    ("whisper-large-v3", 4, 188, 16, dict(num_layers=2, encoder_layers=2,
                                          decoder_layers=2)),
    ("qwen2-vl-2b", 4, 1024, 16, dict(num_layers=2)))
SERVE_SEED = 11
# the f32 teacher-forced check: prefill and decode steps fed a fixed
# sequence, each step's logits against the training forward's at that
# position, relative to the largest logit magnitude
TEACHER_RTOL = 1e-4
TEACHER_STEPS = 8


def _serve_cfg(arch: str, dtype: str, fields=None):
    return replace(get_config(arch), dtype=dtype, use_flash_kernel=True,
                   **(fields or {}))


def _serve_params(cfg, seed: int):
    """[1, ...] parameters built on the card by ``registry.init_params``,
    and the generator (for the prompts)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {k: v[None] for k, v in
            registry.init_params(cfg, gen).items()}, gen


def _bf16_bound(y_ref):
    """One bf16 ulp of each element, FLASH_ATOL near 0 (phase 2's bound)."""
    return ref.bf16_ulp(y_ref).clamp_min(FLASH_ATOL)


def _f32_bound(y_ref):
    """FLASH_ATOL + FLASH_RTOL |y| of each element (phase 2's bound)."""
    return FLASH_ATOL + FLASH_RTOL * y_ref.abs()


def _flash_call_err(q, k, v, kw, out, bound) -> tuple:
    """A flash call against its plain version on the same inputs ->
    (its instance, its q shape, max |diff|, every element within
    ``bound(y_ref)``)."""
    y_ref = ref.flash_attention_ref(q, k, v, causal=True,
                                    window=kw.get("window", 0))
    diff = (out.float() - y_ref.float()).abs()
    return (ops.flash_instance(q, k, v), tuple(q.shape),
            float(diff.max()), bool((diff <= bound(y_ref)).all()))


@contextlib.contextmanager
def _flash_held(bound):
    """Hold every ``ops.flash_attention`` call to its plain version as it
    runs (``_flash_call_err``); yields the list of the calls' results.
    Each call launches and counts as it does unheld."""
    held, orig = [], ops.flash_attention

    def holding(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        held.append(_flash_call_err(q, k, v, kw, out, bound))
        return out

    ops.flash_attention = holding
    try:
        yield held
    finally:
        ops.flash_attention = orig


def _held_failures(arch: str, held) -> list[str]:
    return [f"{arch} flash call {shape}: max |diff| {err} past the bound"
            for _, shape, err, ok in held if not ok]


def _no_drops(cfg):
    """For MoE the capacity factor E / k, where no expert drops a token
    (``moe.capacity_factor`` says why the checks need it)."""
    if cfg.family != "moe":
        return contextlib.nullcontext()
    return moe.capacity_factor(cfg.num_experts / cfg.experts_per_token)


def _ulp_nudged(cfg, params):
    """``cfg`` and ``params`` with the input embedding table moved one
    bf16 ulp away from 0 (each element's bit pattern plus one) and the
    output head left as it was (untied, the same tensor, where ``cfg``
    ties it): the witness of how far one ulp at the input carries."""
    embed = params["embed"]
    nudged = dict(params, embed=(embed.view(torch.int16) + 1).view(
        embed.dtype))
    if cfg.tie_embeddings:
        nudged["lm_head"] = embed.transpose(-1, -2)
        cfg = replace(cfg, tie_embeddings=False)
    return cfg, nudged


def _logits_gap(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def _teacher_gap(cfg, params, batch, cap: int, fed) -> float:
    """Prefill into a cache of capacity ``cap`` and decode steps fed
    ``fed`` [1, B, N - 1], their logits against the training forward's
    over the prompt followed by ``fed`` at the same positions: max |diff|
    / max |forward|. MoE at a capacity where no token drops."""
    with _no_drops(cfg):
        logits, cache = registry.run_prefill(cfg, params, batch, max_len=cap)
        seen = [logits]
        for i in range(fed.shape[-1]):
            logits, cache = registry.decode_step(cfg, params, cache,
                                                 fed[..., i:i + 1])
            seen.append(logits)
        full = dict(batch, tokens=torch.cat([batch["tokens"], fed], dim=-1))
        want = registry.forward_logits(cfg, params, full,
                                       start=batch["tokens"].shape[-1] - 1)
    return _logits_gap(torch.stack(seen, dim=2), want)


def serve_published(arch: str, b: int, prompt: int,
                    gen: int) -> tuple[dict[str, int], list[str]]:
    """One model served whole at its published config in bf16: built on
    the card, a warm-up generation of 2 tokens whose prefill's flash
    calls are each held to the plain version within one bf16 ulp, then
    the timed generation of ``gen`` with the launch counters zeroed
    before it and read after it: flash_attention's bf16 instance exactly
    once a prefill attention layer, nothing else. Printed, not held: the
    teacher-forced figure, the prefill's logits without the kernel, and
    the witness of both: the plain prefill against itself with its input
    embeddings one bf16 ulp away. The teacher-forced decode is fed the
    tokens the timed run generated (MoE at a capacity where no token
    drops, as in f32). Returns the timed run's launches and the
    failures."""
    cfg = _serve_cfg(arch, "bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, g = _serve_params(cfg, SERVE_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch, cap = serve.prompt_batch(cfg, b, prompt, gen, g)
    with _flash_held(_bf16_bound) as held:
        serve.generate(cfg, params, batch, 2, cap)
    _zero_counts()
    run = serve.generate(cfg, params, batch, gen, cap)
    counts = _read_counts()
    n_attn = registry.attention_calls(cfg)
    expected = dict.fromkeys(ops.LAUNCHES, 0)
    expected["flash_attention"] = n_attn
    if {k: counts[k] for k in ops.LAUNCHES} != expected or \
            counts["flash_attention:bf16"] != n_attn:
        raise AssertionError(f"serving {arch}: launched {counts}, the path "
                             f"must launch {expected} (bf16)")
    failures = _held_failures(arch, held)
    if len(held) != n_attn:
        failures.append(f"{arch}: held {len(held)} flash calls of a "
                        f"prefill, not {n_attn}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gap = _teacher_gap(cfg, params, batch, cap, run["tokens"][..., :-1])
    plain_cfg = replace(cfg, use_flash_kernel=False)
    plain, _ = registry.run_prefill(plain_cfg, params, batch, max_len=cap)
    nudged, _ = registry.run_prefill(*_ulp_nudged(plain_cfg, params), batch,
                                     max_len=cap)
    tokens = batch["tokens"].shape[-1]
    extra = {}
    if cfg.family == "encdec":
        frames = batch["frames"].shape[2]
        extra = dict(frames=frames,
                     frames_per_s=f"{b * frames / run['prefill_s']:.1f}")
    log("phase5", model=arch, dtype="bfloat16", layers=cfg.num_layers,
        vocab=cfg.vocab_size,
        params_b=f"{sum(v.numel() for v in params.values()) / 1e9:.4f}",
        B=b, prompt_tokens=tokens, generated=gen, cache_capacity=cap,
        **extra, init_s=f"{init_s:.3f}",
        prefill_s=f"{run['prefill_s']:.4f}",
        prefill_tokens_per_s=f"{b * tokens / run['prefill_s']:.1f}",
        decode_s=f"{run['decode_s']:.4f}",
        decode_tokens_per_s=f"{b * (gen - 1) / run['decode_s']:.1f}",
        peak_gb=f"{peak_gb:.3f}", flash_launches=counts["flash_attention"],
        attention_layers=n_attn,
        instance=sorted({h[0] for h in held}),
        flash_calls_held=len(held),
        flash_call_max_abs_err=max((h[2] for h in held), default=0.0),
        teacher_forced_gap=f"{gap:.3e}",
        flash_vs_plain_prefill_logits=
        f"{_logits_gap(run['prefill_logits'], plain):.3e}",
        ulp_nudge_prefill_logits=f"{_logits_gap(nudged, plain):.3e}",
        first_row=run["tokens"][0, 0, :8].tolist())
    del params, run, plain, nudged
    torch.cuda.empty_cache()
    return counts, failures


def check_serving_f32(arch: str, b: int, prompt: int, fields) -> list[str]:
    """The f32 self-checks of one model at its published widths, cut by
    ``fields``: the teacher-forced gap within TEACHER_RTOL; and where it
    attends, its prefill with the flash kernel against its prefill
    without it, the same weights: every flash call of the prefill on its
    own inputs within FLASH_ATOL + FLASH_RTOL |y| elementwise, as phase
    2 holds it, and the logits and every cache leaf within FLASH_RTOL of
    the leaf's largest magnitude (through the layers the calls'
    differences add up: elementwise, near-zero entries of a deep
    prefill pass 2e-5 absolute). Returns the failures."""
    cfg = _serve_cfg(arch, "float32", fields)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, g = _serve_params(cfg, SERVE_SEED)
    batch, cap = serve.prompt_batch(cfg, b, prompt, TEACHER_STEPS, g)
    fed = torch.randint(0, cfg.vocab_size, (1, b, TEACHER_STEPS - 1),
                        generator=g, device="cuda")
    gap = _teacher_gap(cfg, params, batch, cap, fed)
    failures = []
    if not gap <= TEACHER_RTOL:
        failures.append(f"{arch} teacher-forced gap {gap:.3e}")
    fields_out = {}
    n_attn = registry.attention_calls(cfg)
    if n_attn:
        with _flash_held(_f32_bound) as held:
            fl, fc = registry.run_prefill(cfg, params, batch, max_len=cap)
        pl, pc = registry.run_prefill(replace(cfg, use_flash_kernel=False),
                                      params, batch, max_len=cap)
        failures += _held_failures(arch, held)
        if len(held) != n_attn:
            failures.append(f"{arch}: held {len(held)} flash calls of a "
                            f"prefill, not {n_attn}")
        worst, worst_leaf = 0.0, None
        for name, y, y_ref in [("logits", fl, pl)] + [
                (k, fc[k], pc[k]) for k in fc if k != "len"]:
            rel = _logits_gap(y, y_ref)
            if rel >= worst:
                worst, worst_leaf = rel, name
        if worst > FLASH_RTOL:
            failures.append(f"{arch} prefill with flash against without: "
                            f"{worst:.3e} of {worst_leaf}'s magnitude")
        fields_out = dict(flash_calls_held=len(held),
                          flash_call_max_abs_err=max(h[2] for h in held),
                          flash_vs_plain_prefill=f"{worst:.3e}",
                          flash_vs_plain_worst_leaf=worst_leaf,
                          flash_vs_plain_logits_abs=float(
                              (fl - pl).abs().max()))
    log("phase5", check="f32", model=arch, layers=cfg.num_layers,
        vocab=cfg.vocab_size, B=b, prompt_tokens=batch["tokens"].shape[-1],
        steps=TEACHER_STEPS, teacher_forced_gap=f"{gap:.3e}",
        bound=TEACHER_RTOL, **fields_out,
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    del params
    torch.cuda.empty_cache()
    return failures


def run_serving() -> dict[str, int]:
    """Phase 5: every served model's f32 checks, then its bf16 serving
    run; raises after all lines are printed if a check failed. Returns
    the serving runs' launches."""
    total = dict.fromkeys(_read_counts(), 0)
    failures, secs = [], {}
    for arch, b, prompt, gen, fields in SERVE_MODELS:
        t0 = time.perf_counter()
        failures += check_serving_f32(arch, b, prompt, fields)
        counts, served = serve_published(arch, b, prompt, gen)
        failures += served
        for k, v in counts.items():
            total[k] += v
        secs[arch] = f"{time.perf_counter() - t0:.1f}"
    log("timing", phase5_by_model_s=secs)
    if failures:
        raise AssertionError("phase 5: " + "; ".join(failures))
    return total


# ---------------------------------------------------------------------------
# phase 6: sharded execution
# ---------------------------------------------------------------------------

# the shards of a one-card mesh: four on the one card (the contract's
# count is 1), which hand their blocks to each other without a copy
SHARD_DEVICES = ("cuda:0",) * 4
# (a) the reference bench's parity leg (benchmarks/run.py:498-513, its
# smoke fleet): D-PSGD, W = 8, a sparse ring, 30 fused rounds over 4
# shards against the unsharded run: final accuracy within 1e-3
SHARD_PARITY_CFG = FedHPConfig(num_workers=8, tau_init=8, tau_max=30,
                               lr=0.15, lr_decay=0.993, batch_size=32,
                               seed=5, base_topology="ring", gossip="sparse")
SHARD_PARITY_ROUNDS = 30
SHARD_PARITY_ACC = 1e-3
# and FedHP with and without churn at the paper's fleet, 10 rounds over 2
# shards on both engines, within the reference's DEVICE_TOL
# (tests/test_sharded_engine.py), over the sparse edge list as there
SHARD_FEDHP_CFG = replace(PAPER_CFG, gossip="sparse")
SHARD_CHURN = dict(churn_rate=0.1)
SHARD_FEDHP_ROUNDS = 10
SHARD_DEVICE_TOL = {"accuracy": 1e-6, "loss": 1e-4, "consensus": 1e-4}
# and D-PSGD at the paper's fleet under each codec, 10 fused rounds over
# 2 shards: the codec kernels on each shard's own rows, within the
# reference's SHARDED_COMPRESSED_TOL (int8's buckets turn the sums'
# order noise into whole quanta)
SHARD_CODECS = ("int8", "topk:0.1", "randk:0.1")
SHARD_COMPRESSED_TOL = {"accuracy": 5e-3, "loss": 1e-2, "consensus": 1e-2}
# (b) the reference bench's big leg at full size (benchmarks/run.py:
# 515-570): a W = 4,096 sparse ring, run only sharded, over 4 shards; its
# gates: at most 120 s a round and a final accuracy of at least 0.5
SHARD_BIG_CFG = FedHPConfig(num_workers=4096, rounds=3, tau_init=2,
                            tau_max=4, lr=0.1, batch_size=16, seed=5,
                            base_topology="ring", gossip="sparse")
SHARD_BIG_KW = dict(non_iid_p=0.1, num_samples=32 * 4096)
SHARD_BIG_ROUNDS = 3
SHARD_BIG_ROUND_S = 120.0
SHARD_BIG_ACC = 0.5
# and the final accuracy the leg reaches at these seeds, the same on the
# card and on the CPU (PERF.md), held within the parity leg's 1e-3
SHARD_BIG_ACC_SEEN = 0.946586
# (c) the dense registry path as published (LM_BF16_MODEL, W = 8): FedHP
# over 2 shards against the unsharded run over phase 4's erdos:0.5 base,
# within phase 4's bf16 bounds
SHARD_LM_ROUNDS = 2


def _shard_mesh(shards: int):
    return make_worker_mesh(shards, devices=SHARD_DEVICES[:shards])


def _edges_launched(name: str, counts: dict, rows: int) -> dict[str, int]:
    """A sharded run's launches: gossip_edges one a (shard, offset) a
    communicating round — all of the instance a block of ``rows`` rows
    takes —, never gossip_mix (sharded gossip is always the edge form);
    -> the gossip_edges launches by instance."""
    inst = {k.split(":")[1]: v for k, v in ops.INSTANCE_LAUNCHES.items()
            if k.startswith("gossip_edges:")}
    if counts["gossip_mix"] or not counts["gossip_edges"] or \
            inst[ops.edges_instance(rows)] != counts["gossip_edges"]:
        raise AssertionError(f"{name}: launched {counts}, gossip_edges "
                             f"instances {inst}")
    return inst


def _base_edge_launches(cfg: FedHPConfig, mesh) -> int:
    """The gossip_edges launches of one D-PSGD round over ``cfg``'s base
    topology, routed over ``mesh``: one a shard and offset with edges."""
    plan = shardexec.WorkerShardPlan(mesh, cfg.num_workers)
    adj = topo.make_base_topology(cfg.num_workers, cfg.base_topology,
                                  cfg.seed)
    (routed,) = plan.route([engine.round_edge_list(adj, "uniform")])
    return routed.launches()


@contextlib.contextmanager
def _edges_held():
    """Hold every ``ops.gossip_edges`` call to its plain version as it
    runs: bit-equal on the same (x, t, CSR) (``_require_equal``); yields
    the list of the calls' (instance, x's shape, whether t is x). Each
    call launches and counts as it does unheld."""
    held, orig = [], ops.gossip_edges

    def holding(x, t, *csr):
        y = orig(x, t, *csr)
        inst = ops.edges_instance(x.shape[0])
        _require_equal("gossip_edges", f"{inst}{tuple(x.shape)}",
                       [(y, ref.gossip_edges_ref(x, t, *csr))])
        held.append((inst, tuple(x.shape), t is x))
        return y

    ops.gossip_edges = holding
    try:
        yield held
    finally:
        ops.gossip_edges = orig


def _held_summary(held) -> dict[str, int]:
    """The held gossip_edges calls counted by instance, shape and wire."""
    out: dict[str, int] = {}
    for inst, shape, t_is_x in held:
        key = f"{inst}{list(shape)}:{'t=x' if t_is_x else 't=recv'}"
        out[key] = out.get(key, 0) + 1
    return out


def _hold_sharded(name: str, ha, hb, tol: dict) -> dict:
    """Host fields of the unsharded run ``ha`` and the sharded ``hb``
    equal, each device metric within ``tol`` (a ``(atol, rtol)`` pair);
    -> history_gaps."""
    a, b = ha.as_arrays(), hb.as_arrays()
    for k in EXACT:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{name}: host field {k} differs: "
                                 f"{a[k]} vs {b[k]}")
    for k, (atol, rtol) in tol.items():
        np.testing.assert_allclose(b[k], a[k], atol=atol, rtol=rtol,
                                   err_msg=f"{name}: {k}")
    return history_gaps(ha, hb)


def run_sharded(data) -> dict[str, int]:
    """Phase 6: (a) the sharded engines against the unsharded ones on the
    card, (b) the W = 4,096 ring at full size, (c) the registry path as
    published over 2 shards. Returns the sharded runs' launches, each
    counted from zero just before the run."""
    total = dict.fromkeys(_read_counts(), 0)

    def sharded(fn, hold: bool = True):
        """Run ``fn`` with the counts zeroed, every gossip_edges call held
        to its plain version unless ``hold`` is False -> (its result, its
        seconds, its launches, the held calls' summary)."""
        torch.cuda.synchronize()
        _zero_counts()
        with _edges_held() if hold else contextlib.nullcontext() as held:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = _read_counts()
        if hold and len(held) != counts["gossip_edges"]:
            raise AssertionError(f"{len(held)} gossip_edges calls held of "
                                 f"{counts['gossip_edges']} launched")
        for k, v in counts.items():
            total[k] += v
        return out, secs, counts, _held_summary(held or [])

    # (a) D-PSGD's parity leg, every round a ring over 4 shards
    mesh = _shard_mesh(4)
    cfg = SHARD_PARITY_CFG
    kw = dict(PAPER_KW, rounds=SHARD_PARITY_ROUNDS, fused=True)
    h_o = run_algorithm("dpsgd", cfg, **kw)
    h_s, secs, counts, held = sharded(
        lambda: run_algorithm("dpsgd", cfg, mesh=mesh, **kw))
    name = "dpsgd/ring/W=8/shards=4"
    per_round = _base_edge_launches(cfg, mesh)
    inst = _edges_launched(name, counts, cfg.num_workers // 4)
    if counts["gossip_edges"] != SHARD_PARITY_ROUNDS * per_round:
        raise AssertionError(f"{name}: {counts['gossip_edges']} "
                             f"gossip_edges, not {SHARD_PARITY_ROUNDS} x "
                             f"{per_round}")
    drift = abs(h_s.final_accuracy - h_o.final_accuracy)
    if drift > SHARD_PARITY_ACC:
        raise AssertionError(f"{name}: final accuracy drifts {drift}")
    gaps = _hold_sharded(name, h_o, h_s, {})
    log("phase6", path=name, rounds=SHARD_PARITY_ROUNDS,
        final_accuracy=[h_o.final_accuracy, h_s.final_accuracy],
        acc_drift=drift, bound=SHARD_PARITY_ACC, host_fields_equal=True,
        loss_max_rel_diff=gaps["loss"], param_max_abs_diff=gaps["params"],
        edges_per_round=per_round, edges_instances=inst, edges_held=held,
        sharded_s=f"{secs:.3f}")

    # (a) FedHP with and without churn at the paper's fleet, both engines
    mesh = _shard_mesh(2)
    tol = {k: (v, v) for k, v in SHARD_DEVICE_TOL.items()}
    for churn in ({}, SHARD_CHURN):
        cfg = replace(SHARD_FEDHP_CFG, **churn)
        for fused_engine in (False, True):
            kw = dict(PAPER_KW, rounds=SHARD_FEDHP_ROUNDS,
                      fused=fused_engine)
            h_o = run_algorithm("fedhp", cfg, **kw)
            h_s, secs, counts, held = sharded(lambda: run_algorithm(
                "fedhp", cfg, mesh=mesh, **kw))
            name = ("fedhp/W=30/shards=2" + ("/churn" if churn else "")
                    + ("/fused" if fused_engine else "/reference"))
            inst = _edges_launched(name, counts, 15)
            gaps = _hold_sharded(name, h_o, h_s, tol)
            log("phase6", path=name, rounds=SHARD_FEDHP_ROUNDS,
                host_fields_equal=True, acc_max_abs_diff=gaps["acc"],
                loss_max_rel_diff=gaps["loss"],
                consensus_max_rel_diff=gaps["consensus"],
                param_max_abs_diff=gaps["params"], tol=SHARD_DEVICE_TOL,
                edges_instances=inst, edges_held=held,
                sharded_s=f"{secs:.3f}", num_links=h_s.as_arrays()["num_links"].tolist())

    # (a) D-PSGD under each codec at the paper's fleet, fused
    tol = {k: (v, v) for k, v in SHARD_COMPRESSED_TOL.items()}
    for codec in SHARD_CODECS:
        cfg = replace(SHARD_FEDHP_CFG, compress=codec)
        kw = dict(PAPER_KW, rounds=SHARD_FEDHP_ROUNDS, fused=True)
        h_o = run_algorithm("dpsgd", cfg, **kw)
        h_s, secs, counts, held = sharded(lambda: run_algorithm(
            "dpsgd", cfg, mesh=mesh, **kw))
        name = f"dpsgd/W=30/shards=2/{codec}"
        inst = _edges_launched(name, counts, 15)
        # the codec kernels once a shard, gossip_edges once a shard and
        # offset, each communicating round (every round: a full base)
        per_round = {k: len(mesh.devices) * v for k, v in _codec_launches(
            cfg, modelspec.adapter_for(cfg)).items()}
        per_round["gossip_edges"] = _base_edge_launches(cfg, mesh)
        want = {k: SHARD_FEDHP_ROUNDS * per_round.get(k, 0)
                for k in ops.LAUNCHES}
        if dict(ops.LAUNCHES) != want:
            raise AssertionError(f"{name}: launched {dict(ops.LAUNCHES)}, "
                                 f"the path must launch {want}")
        gaps = _hold_sharded(name, h_o, h_s, tol)
        log("phase6", path=name, rounds=SHARD_FEDHP_ROUNDS,
            host_fields_equal=True, acc_max_abs_diff=gaps["acc"],
            loss_max_rel_diff=gaps["loss"],
            consensus_max_rel_diff=gaps["consensus"],
            param_max_abs_diff=gaps["params"], tol=SHARD_COMPRESSED_TOL,
            launches={k: v for k, v in want.items() if v},
            edges_instances=inst, edges_held=held, sharded_s=f"{secs:.3f}")

    # (b) the W = 4,096 ring at full size, only sharded: once with every
    # gossip_edges call held to its plain version, once unheld for the
    # rounds/s and the peak memory
    mesh = _shard_mesh(4)
    cfg = SHARD_BIG_CFG
    name = "dpsgd/ring/W=4096/shards=4"
    plan = shardexec.WorkerShardPlan(mesh, cfg.num_workers)
    per_round = _base_edge_launches(cfg, mesh)
    runs = []
    for hold in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        h, wall, counts, held = sharded(lambda: run_algorithm(
            "dpsgd", cfg, rounds=SHARD_BIG_ROUNDS, fused=True, mesh=mesh,
            **SHARD_BIG_KW), hold=hold)
        inst = _edges_launched(name, counts, plan.rows)
        if counts["gossip_edges"] != SHARD_BIG_ROUNDS * per_round:
            raise AssertionError(f"{name}: {counts['gossip_edges']} "
                                 f"gossip_edges, not {SHARD_BIG_ROUNDS} x "
                                 f"{per_round}")
        _check_history(name, cfg, SHARD_BIG_ROUNDS, h)
        runs.append((h.as_arrays()["accuracy"], held))
        del h
    acc, held = runs[0]
    log("phase6", path=name, rounds=SHARD_BIG_ROUNDS,
        rounds_per_s=f"{SHARD_BIG_ROUNDS / wall:.4f}",
        seconds_per_round=f"{wall / SHARD_BIG_ROUNDS:.3f}",
        seconds=f"{wall:.3f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        block_bytes=plan.rows * PAPER_MLP_P * 4,
        whole_bytes=cfg.num_workers * PAPER_MLP_P * 4,
        final_accuracy=f"{acc[-1]:.6f}",
        accuracy=[f"{a:.6f}" for a in acc],
        timed_run_accuracy=[f"{a:.6f}" for a in runs[1][0]],
        seen=SHARD_BIG_ACC_SEEN, edges_per_shard_round=per_round /
        plan.n_shards, edges_instances=inst, edges_held=held)
    if wall / SHARD_BIG_ROUNDS > SHARD_BIG_ROUND_S:
        raise AssertionError(f"{name}: {wall / SHARD_BIG_ROUNDS:.1f} s a "
                             f"round > {SHARD_BIG_ROUND_S}")
    for a, _ in runs:
        if a[-1] < SHARD_BIG_ACC or \
                abs(a[-1] - SHARD_BIG_ACC_SEEN) > SHARD_PARITY_ACC:
            raise AssertionError(
                f"{name}: final accuracy {a[-1]} < {SHARD_BIG_ACC} or "
                f"more than {SHARD_PARITY_ACC} from {SHARD_BIG_ACC_SEEN}")

    # (c) the registry path as published, over 2 shards
    mesh = _shard_mesh(2)
    adapter = lm_adapter(LM_BF16_MODEL)
    torch.cuda.empty_cache()
    h_o, _ = _lm_run(adapter, data, "fedhp", SHARD_LM_ROUNDS,
                     fused_engine=True, **LM_PARITY_FIELDS)
    (h_s, _), secs, counts, held = sharded(lambda: _lm_run(
        adapter, data, "fedhp", SHARD_LM_ROUNDS, fused_engine=True,
        mesh=mesh, **LM_PARITY_FIELDS))
    name = "fedhp/smollm-360m-4l/bf16/remat=block/erdos:0.5/shards=2"
    inst = _edges_launched(name, counts, LM_CFG.num_workers // 2)
    if counts["flash_attention:bf16"] != counts["flash_attention"] or \
            not counts["flash_attention"]:
        raise AssertionError(f"{name}: flash launches {counts}")
    gaps = _hold_sharded(name, h_o, h_s, {
        "accuracy": (ACC_ATOL, 0.0), "loss": (0.0, BF16_LOSS_RTOL),
        "consensus": (CONSENSUS_ATOL, BF16_CONSENSUS_RTOL)})
    log("phase6", path=name, rounds=SHARD_LM_ROUNDS, P=adapter.param_count,
        host_fields_equal=True, acc_max_abs_diff=gaps["acc"],
        loss_max_rel_diff=gaps["loss"],
        consensus_max_rel_diff=gaps["consensus"],
        param_max_abs_diff=gaps["params"],
        bounds=dict(loss=BF16_LOSS_RTOL, consensus=BF16_CONSENSUS_RTOL),
        launches={k: v for k, v in counts.items() if v},
        edges_instances=inst, edges_held=held, sharded_s=f"{secs:.3f}",
        seconds_per_round=f"{secs / SHARD_LM_ROUNDS:.3f}")
    return total


# ---------------------------------------------------------------------------
# phase 7: the production trainer
# ---------------------------------------------------------------------------

# ``launch/train.py``'s round loop at smollm-360m as published (32 layers,
# d 960, vocabulary 49,152, bf16, remat "block") with the flash kernel,
# on a (4, 1) mesh of 4 slots of the one card (REPRO_DEVICES=4, the
# model axis of size 1), train_4k's S = 4,096, tau_max 2 over a complete
# base with the controller on. The cut: a global batch of 8 sequences (2
# a worker) instead of train_4k's 256, which one card cannot hold
TRAIN_ARCH = "smollm-360m"
TRAIN_WORKERS = 4
TRAIN_SHAPE = InputShape("train_4k", seq_len=4096, global_batch=8,
                         kind="train")
# P of smollm-360m (its tied embedding once)
TRAIN_P = 361_821_120
TRAIN_TAU = 2
TRAIN_LR = 0.01
TRAIN_SEED = 0
# 1 timed round: the room (f)-(j) need (PERF.md §4)
TRAIN_TIMED_ROUNDS = 1
# the CPU tests' bf16 bounds (tests/test_torch_train_bf16.py): the round
# with the flash kernel against the round with the plain attention
TRAIN_LOSS_RTOL, TRAIN_DIST_RTOL = 2e-3, 2e-2
# columns a held gossip_mix call's plain version takes at a time
HOLD_COLS = 1 << 24
# (d) the model axis in dp: the same model over (data, model) = (4, 2), 8
# slots of the one card (REPRO_DEVICES=8, --workers 4): each slot the
# whole replica and 1 of its worker's 2 sequences; a held round from (a)'s
# init and first batch, then a timed round
MODEL_DP_SLOTS = 8
# (d)-(j) against their model extent of 1, the CPU tests' bf16 trainer
# bounds: loss relative, the parameters relative in norm; (d)'s distances
# relative (over sqrt(2)), (e)-(j)'s each by its own bound (ModelCase)
MODEL_LOSS_RTOL, MODEL_DIST_RTOL, MODEL_PARAM_RTOL = 2e-3, 2e-2, 1e-3


class ModelCase(NamedTuple):
    """A phase-7 model-axis case at published widths (bf16, remat
    "block"), W = 2 over (2, 2) then (2, 1): its depth (whisper's encoder
    and decoder alike), its global batch and S, lr, and the bound of its
    (2, 2) distances against the reference's rule on the (2, 1) rows
    (relative): twice the largest gap of a (2, 1) round from a start
    nudged one bf16 ulp (several nudges, both signs), which the rule
    counting a whole leaf once exceeds (tools/model_axis_witness.py,
    PERF.md section 2)."""

    label: str
    arch: str
    layers: int
    batch: int
    seq: int
    lr: float
    dist_rtol: float


# (e)-(g) tp, (h) tp on the xlstm family, (i), (j) dp; each depth from the
# dry run's peak estimate under 60 GB ((e)-(h) at (2, 1), (i), (j) at
# (2, 2), where each slot holds the whole replica). (e) internlm2-20b (d
# 6,144, 48 / 8 heads of 128, d_ff 16,384, vocabulary 92,544) depth 2 of
# 48, 51.4 GB at (2, 2) and 72.1 at (2, 1) (at a batch of 4, 63.5 / 99.5);
# (f) olmoe-1b-7b (d 2,048, 16 / 16 heads of 128, 64 experts of d_ff
# 1,024, 8 a token, vocabulary 50,304; its experts over the model axis, 32
# a slot) depth 2 of 16, 28.9 / 41.0 GB; (g) zamba2-7b (d 3,584, 32 heads
# of 112, d_ff 14,336, ssm_state 64, vocabulary 32,000; Mamba2's
# projections split) one group of 6 Mamba2 blocks and the shared blocks of
# 81, 30.6 / 34.6 GB; (h) xlstm-1.3b (d 2,048, 4 heads, vocabulary 50,304;
# the mLSTM's and sLSTM's projections split, 2 heads a slot) one group of
# 7 mLSTM and 1 sLSTM block of 48 at S = 512, the largest power of two
# under 60 GB (its sLSTM token loop holds about 68 MB a token for the
# backward; the dry run's estimates: 42.0 GB at S = 512, 76.7 at 1,024,
# 284 at 4,096), its family's lr; (i) whisper-large-v3 (d 1,280, 20
# heads of 64, d_ff 5,120, vocabulary 51,866) 16 + 16 layers of 32 + 32,
# 59.8 GB; (j)
# qwen2-vl-2b (d 1,536, 12 / 2 heads of 128, d_ff 8,960, vocabulary
# 151,936) depth 22 of 28, 59.7 GB. (i) and (j) take a global batch of 4:
# 2 would leave each worker 1 sequence for 2 slots, dp's sequence
# fallback (ROADMAP.md item 4.4)
# The distance bounds: twice the nudges' largest gap on the card (NVIDIA
# H100 80GB HBM3, 700.00 W; tools/model_axis_witness.py e f g h i j):
# (e) 6.53e-3, (f) 7.68e-3, (g) 7.45e-2, (h) 6.33e-3, (i) 6.60e-3, (j)
# 4.53e-3; a sum over the model axis left out (slot 0's partial alone)
# parts from the rule by 0.27-0.39 on every case, the rule counting a
# whole leaf once by 0.08-0.41 on (f), (h), (i), (j) and 2.2e-4 / 1.9e-2
# on (e) / (g), whose whole leaves hold little of the distance.
MODEL_PIECE_CASES = (
    ModelCase("e", "internlm2-20b", 2, 2, 4096, 0.01, 1.31e-2),
    ModelCase("f", "olmoe-1b-7b", 2, 2, 4096, 0.01, 1.54e-2),
    ModelCase("g", "zamba2-7b", 6, 2, 4096, 0.01, 0.149),
    ModelCase("h", "xlstm-1.3b", 8, 2, 512, 5e-4, 1.27e-2),
    ModelCase("i", "whisper-large-v3", 16, 4, 4096, 0.01, 1.32e-2),
    ModelCase("j", "qwen2-vl-2b", 22, 4, 4096, 0.01, 9.07e-3))
# the (2, 2) round's distances against the reference's rule on its own
# slots' inputs (each slot's d^2 in f64, summed): f32 partials
MODEL_RULE_RTOL = 1e-5
TP_WORKERS = 2


def case_depth(case: ModelCase) -> dict:
    """The config fields that set ``case``'s depth."""
    if get_config(case.arch).family == "encdec":
        return dict(num_layers=case.layers, encoder_layers=case.layers,
                    decoder_layers=case.layers)
    return dict(num_layers=case.layers)


def case_shape(case: ModelCase) -> InputShape:
    """``case``'s cell: train_4k at its global batch and S."""
    return InputShape("train_4k", seq_len=case.seq, global_batch=case.batch,
                      kind="train")


class _TrainHolds:
    """Hold every call of the trainer's kernels to its plain version as
    it runs, while ``active``: gossip_mix (both forms), quantize_block
    and dequantize_block bit-equal on their own inputs (gossip_mix's
    plain version a column chunk at a time: its columns are
    independent), consensus_dist within 1e-6 relative, flash_attention
    within one bf16 ulp (``_bf16_bound``, phase 5's rule). The first
    gossip_mix and consensus_dist call is also timed on its own inputs.
    ``start(names)`` holds only the kernels named. Each call
    launches and counts as it does unheld; the checks and timings run
    outside any dispatch mode (a FLOP count of the round sees the path's
    work only), and ``seconds`` adds up their wall time (the card synced
    before and after each), which a held round's net time leaves out."""

    NAMES = ("gossip_mix", "quantize_block", "dequantize_block",
             "consensus_dist", "flash_attention")

    def __init__(self, cycles_per_ms: float, arch: str = TRAIN_ARCH):
        self.cycles = cycles_per_ms
        self.arch = arch
        self.orig = {n: getattr(ops, n) for n in self.NAMES}
        self.held = dict.fromkeys(self.NAMES, 0)
        self.worst = dict.fromkeys(self.NAMES, 0.0)
        self.flash = []
        self.timed = {}
        self.seconds = 0.0

    @contextlib.contextmanager
    def _checking(self):
        """A check or timing outside any dispatch mode, its wall time
        added to ``seconds``."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with _disable_current_modes():
                yield
            torch.cuda.synchronize()
        finally:
            self.seconds += time.perf_counter() - t0

    def _time(self, name: str, fn, nbytes: int, flops: int) -> None:
        """Time ``fn`` once a kernel; its launches are not the path's, nor
        is their work (``ops.WORK``)."""
        if name in self.timed:
            return
        counts = (dict(ops.LAUNCHES), dict(ops.INSTANCE_LAUNCHES),
                  dict(ops.WORK))
        ms = time_ms(fn, self.cycles, batch=1, reps=5)
        ops.LAUNCHES.update(counts[0])
        ops.INSTANCE_LAUNCHES.update(counts[1])
        ops.WORK.update(counts[2])
        bound_ms, bound_by = _bound(nbytes, flops)
        self.timed[name] = dict(ms=f"{ms:.4f}", bound_ms=f"{bound_ms:.4f}",
                                bound_by=bound_by)

    def gossip_mix(self, x, u, w, *, centre=None, round_bf16=False):
        y = self.orig["gossip_mix"](x, u, w, centre=centre,
                                    round_bf16=round_bf16)
        with self._checking():
            self._hold_mix(x, u, w, y, centre, round_bf16)
        return y

    def _hold_mix(self, x, u, w, y, centre, round_bf16):
        for c0 in range(0, x.shape[1], HOLD_COLS):
            cols = slice(c0, c0 + HOLD_COLS)
            want = ref.gossip_mix_ref(
                x[:, cols].contiguous(), u[:, cols].contiguous(), w,
                centre=None if centre is None
                else centre[:, cols].contiguous(), round_bf16=round_bf16)
            self.worst["gossip_mix"] = max(
                self.worst["gossip_mix"], _require_equal(
                    "gossip_mix", f"trainer{tuple(x.shape)}K={w.shape[1]}",
                    [(y[:, cols], want)]))
        self.held["gossip_mix"] += 1
        b, k, length = x.shape[0], w.shape[1], x.shape[1]
        self._time("gossip_mix" + (":bf16round" if round_bf16 else ""),
                   lambda: self.orig["gossip_mix"](x, u, w, centre=centre,
                                                   round_bf16=round_bf16),
                   _mix_bytes(x, u, w, centre),
                   (5 if round_bf16 else 3) * b * k * length)

    def quantize_block(self, x):
        q, s = self.orig["quantize_block"](x)
        with self._checking():
            _require_equal("quantize_block", f"trainer{tuple(x.shape)}",
                           zip((q, s), ref.quantize_block_ref(x)))
        self.held["quantize_block"] += 1
        return q, s

    def dequantize_block(self, q, s, n):
        y = self.orig["dequantize_block"](q, s, n)
        with self._checking():
            _require_equal("dequantize_block", f"trainer[{q.shape[0]}, {n}]",
                           [(y, ref.dequantize_block_ref(q, s, n))])
        self.held["dequantize_block"] += 1
        return y

    def consensus_dist(self, x, u):
        d = self.orig["consensus_dist"](x, u)
        with self._checking():
            self._hold_dist(x, u, d)
        return d

    def _hold_dist(self, x, u, d):
        d_ref = ref.consensus_dist_ref(x, u)
        rel = float(((d - d_ref).abs() / d_ref.clamp_min(1e-30)).max())
        if rel > CONSENSUS_RTOL:
            raise AssertionError(f"consensus_dist[trainer{tuple(u.shape)}]: "
                                 f"relative difference {rel}")
        self.worst["consensus_dist"] = max(self.worst["consensus_dist"], rel)
        self.held["consensus_dist"] += 1
        k, length = u.shape
        self._time("consensus_dist",
                   lambda: self.orig["consensus_dist"](x, u),
                   ((k + 1) * length + k) * 4, 3 * k * length)

    def flash_attention(self, q, k, v, **kw):
        out = self.orig["flash_attention"](q, k, v, **kw)
        with torch.no_grad(), self._checking():
            self.flash.append(_flash_call_err(q.detach(), k.detach(),
                                              v.detach(), kw, out.detach(),
                                              _bf16_bound))
        self.held["flash_attention"] += 1
        return out

    def start(self, names=NAMES) -> None:
        for n in names:
            setattr(ops, n, getattr(self, n))

    def stop(self) -> None:
        for n in self.NAMES:
            setattr(ops, n, self.orig[n])

    def failures(self) -> list[str]:
        return _held_failures(self.arch, self.flash)


def _mix_bytes(x, u, w, centre) -> int:
    """The bytes a gossip_mix call must move: each distinct operand read
    once (u and the centre are x's rows on the uncompressed path, the
    payload's on the compressed one), y written once."""
    c = x if centre is None else centre
    rows = x.shape[0] * (1 if c.data_ptr() == x.data_ptr() else 2)
    if u.data_ptr() not in (x.data_ptr(), c.data_ptr()):
        rows += u.shape[0]
    return ((rows + x.shape[0]) * x.shape[1] + w.numel()) * 4


def _distinct_rows_gap(x: torch.Tensor, w: torch.Tensor, adj: np.ndarray,
                       gen: torch.Generator) -> dict[str, float]:
    """The round's own gossip_mix weights ``w`` (what the step passed the
    kernel) on rows made distinct, where a wrong weight or a mix that does
    nothing shows: the round's first ``HOLD_COLS`` input columns plus
    N(0, 0.02) a worker, rounded to bf16, mixed by both forms against the
    dense mix ``mixing_matrix_uniform(adj) @ x`` in f64 -> each form's
    largest gap over its bound (bf16-rounded (2 M + 1) 2^-8 max |x| a
    column, ``_dense_mix_gap``'s; f32 (2 M + 1) 2^-22 max |x|), and the
    same ratio of the rows left unmixed (the check's witness: it must
    trip). Its launches are not the path's."""
    m = len(topo.matching_decomposition(adj))
    cols = min(HOLD_COLS, x.shape[1])
    xd = (x[:, :cols] + 0.02 * torch.randn(x.shape[0], cols, generator=gen,
                                           device=x.device)) \
        .to(torch.bfloat16).float()
    counts = dict(ops.LAUNCHES), dict(ops.INSTANCE_LAUNCHES)
    y_b = ops.gossip_mix(xd, xd, w, round_bf16=True)
    y_f = ops.gossip_mix(xd, xd, w)
    ops.LAUNCHES.update(counts[0])
    ops.INSTANCE_LAUNCHES.update(counts[1])
    mix = torch.as_tensor(topo.mixing_matrix_uniform(adj),
                          dtype=torch.float64, device=x.device)
    dense = mix @ xd.double()
    amax = (2 * m + 1) * xd.abs().amax(dim=0).double().clamp_min(2.0 ** -126)

    def ratio(y, ulp):
        return float(((y.double() - dense).abs() / (ulp * amax)).max())

    return dict(bf16=ratio(y_b, 2.0 ** -8), f32=ratio(y_f, 2.0 ** -22),
                unmixed=ratio(xd, 2.0 ** -8))


def _dense_mix_gap(x: torch.Tensor, y: torch.Tensor,
                   adj: np.ndarray) -> tuple[float, float]:
    """The round's gossip result y against the dense mix
    ``mixing_matrix_uniform(adj) @ x`` of its input rows x, in f32 ->
    (max |y - dense| over the bound, the largest |y - dense|). The bound
    of the matching-major bf16-rounded mix: each of the M matchings
    rounds its term and its sum to bf16, half a bf16 ulp each (at most
    2^-8 of the value) of a value no larger than the column's largest
    |x| (a partial sum is a convex combination of the rows, a term at
    most w 2 max |x| with w <= 1/2), and f32's own roundings add under
    2^-8 more: (2 M + 1) 2^-8 max_i |x_i| a column."""
    m = len(topo.matching_decomposition(adj))
    mix = torch.as_tensor(topo.mixing_matrix_uniform(adj),
                          dtype=torch.float32, device=x.device)
    worst_ratio = worst = 0.0
    for c0 in range(0, x.shape[1], HOLD_COLS):
        cols = slice(c0, c0 + HOLD_COLS)
        xc = x[:, cols]
        gap = (y[:, cols] - mix @ xc).abs()
        bound = (2 * m + 1) * 2.0 ** -8 * xc.abs().amax(dim=0)
        worst = max(worst, float(gap.max()))
        worst_ratio = max(worst_ratio, float(
            (gap / bound.clamp_min(2.0 ** -126)).max()))
    return worst_ratio, worst


def _phase7_dry_run(cfg, mesh, adj: np.ndarray, pass_workers: int,
                    slots: int = 1):
    """Phase 7's cell counted by the dry run on the ``meta`` device (no
    card: ``launch/dryrun.run_cell``) as its held round runs: the round's
    adj, tau_max and measured distances, the flash kernel on, on
    ``mesh`` (its model axis of ``slots`` slots in dp: each runs the
    replica on its share of the batch). Also one flash call's plain
    backward at the path's shapes (the custom VJP's recompute through the
    plain composition, ROADMAP.md queue 2 item 11), and the calls a round
    makes of it. Returns (the record, the backward's line)."""
    t0 = time.perf_counter()
    rec = dryrun.run_cell(
        TRAIN_ARCH, TRAIN_SHAPE, mesh=mesh, verbose=False,
        cfg_overrides={"use_flash_kernel": True},
        train_kw=dict(tau_max=TRAIN_TAU, adj=adj, measure_distances=True))
    trace_s = time.perf_counter() - t0
    b = pass_workers * (TRAIN_SHAPE.global_batch // TRAIN_WORKERS // slots)
    hd, dt = cfg.resolved_head_dim, getattr(torch, cfg.dtype)
    q, k, v = (torch.empty(b, TRAIN_SHAPE.seq_len, h, hd, dtype=dt,
                           device="meta", requires_grad=True)
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    out = ops.flash_attention(q, k, v)
    bwd = dryrun.count(lambda: torch.autograd.grad(out, (q, k, v),
                                                   torch.empty_like(out)))
    calls = registry.attention_calls(cfg) * \
        -(-TRAIN_WORKERS // pass_workers) * TRAIN_TAU * slots
    backward = dict(shape=[b, TRAIN_SHAPE.seq_len, cfg.num_heads, hd],
                    calls_a_round=calls, flops_a_call=bwd.flops,
                    bytes_a_call=bwd.bytes,
                    round_flops=calls * bwd.flops,
                    round_bytes=calls * bwd.bytes,
                    share_of_round_flops=f"{calls * bwd.flops / rec['hlo_flops']:.4f}",
                    share_of_round_bytes=f"{calls * bwd.bytes / rec['hlo_bytes']:.4f}")
    log("phase7", dry_run=f"{TRAIN_ARCH}/W={TRAIN_WORKERS}/S=4096/"
        f"tau={TRAIN_TAU}/flash", mesh=rec["mesh"], chips=rec["chips"],
        args_gb=f"{rec['bytes_per_device'] / 1e9:.3f}",
        trace_s=f"{trace_s:.1f}", hlo_flops=rec["hlo_flops"],
        hlo_bytes=rec["hlo_bytes"], collective_bytes=rec["collective_bytes"],
        compute_ms=f"{rec['compute_s'] * 1e3:.3f}",
        memory_ms=f"{rec['memory_s'] * 1e3:.3f}",
        collective_ms=f"{rec['collective_s'] * 1e3:.3f}",
        dominant=rec["dominant"], model_flops=rec["model_flops"],
        useful_fraction=f"{rec['useful_fraction']:.4f}",
        peak_gb=f"{rec['peak_bytes_per_device'] / 1e9:.3f}",
        constants=dict(peak_flops=rl.PEAK_FLOPS, hbm_bw=rl.HBM_BW,
                       link_bw=rl.LINK_BW),
        flash_plain_backward=backward)
    return rec, backward


class _FirstStepCount:
    """Count the first call of the first train step ``steps.make_train_step``
    builds while active (launch/train's held round): its FLOPs under
    ``dryrun.FlopCount`` plus the kernels' own (``ops.WORK``), as the dry
    run counts them."""

    def __init__(self):
        self.flops = None
        self.make = steps.make_train_step

    def _build(self, *args, **kw):
        bundle = self.make(*args, **kw)
        fn = bundle.fn

        def counted(*step_args):
            if self.flops is not None:
                return fn(*step_args)
            work = ops.WORK["flops"]
            with dryrun.FlopCount() as mode:
                out = fn(*step_args)
            self.flops = mode.flops + ops.WORK["flops"] - work
            return out

        bundle.fn = counted
        return bundle

    def __enter__(self):
        steps.make_train_step = self._build
        return self

    def __exit__(self, *exc):
        steps.make_train_step = self.make


def _train_run(cfg, mesh, p1, batches, rounds: int, shape=TRAIN_SHAPE,
               lr: float = TRAIN_LR, **kw):
    """``launch/train.train`` from the one-worker start ``p1`` on
    ``batches``, its round lines printed under phase 7 -> (run, the
    launches it made, counted from zero, peak GB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    run = trainer.train(cfg, shape, mesh, steps_total=rounds,
                        tau_max=TRAIN_TAU, lr=lr, seed=TRAIN_SEED,
                        init_params=p1, batches=iter(batches[:rounds]),
                        log=lambda line: log("phase7", line=repr(line)),
                        **kw)
    torch.cuda.synchronize()
    return run, _read_counts(), torch.cuda.max_memory_allocated() / 1e9


def _trainer_mesh(workers: int, slots: int, model: int):
    """``build_mesh(workers)`` over ``slots`` slots of the one card
    (``REPRO_DEVICES=slots``), required to be (workers, model) there."""
    was = os.environ.get("REPRO_DEVICES")
    os.environ["REPRO_DEVICES"] = str(slots)
    try:
        mesh = trainer.build_mesh(workers, device="cuda")
    finally:
        if was is None:
            os.environ.pop("REPRO_DEVICES")
        else:
            os.environ["REPRO_DEVICES"] = was
    if mesh.shape != {"data": workers, "model": model} or \
            set(mesh.devices) != {torch.device("cuda", 0)}:
        raise AssertionError(f"phase 7 mesh {mesh}: not ({workers}, "
                             f"{model}) on the card")
    return mesh


def _trainer_setup():
    """Phase 7's config (published, the flash kernel on), its mesh
    (``build_mesh`` with ``REPRO_DEVICES=4``: 4 slots of the one card),
    the one-worker start and the rounds' batches, both drawn on the card
    from seeds, and the flat layout."""
    cfg = replace(get_config(TRAIN_ARCH), use_flash_kernel=True)
    mesh = _trainer_mesh(TRAIN_WORKERS, TRAIN_WORKERS, 1)
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    p1 = registry.init_params(cfg, gen)
    stream = trainer.random_batches(cfg, TRAIN_SHAPE, TRAIN_SEED + 1, "cuda")
    batches = [next(stream) for _ in range(1 + TRAIN_TIMED_ROUNDS)]
    layout = steps.train_layout(cfg, TRAIN_SHAPE)
    if layout.param_count != TRAIN_P:
        raise AssertionError("phase 7: smollm-360m's P is not TRAIN_P")
    return cfg, mesh, p1, batches, layout


def trace_trainer_round() -> None:
    """One traced round of phase 7's trainer (after a warm-up round):
    wall and device-busy seconds, the top kernels, the port's own."""
    from torch.profiler import ProfilerActivity, profile
    cfg, mesh, p1, batches, _ = _trainer_setup()
    _train_run(cfg, mesh, p1, batches, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _train_run(cfg, mesh, p1, batches, 1)
        wall = time.perf_counter() - t0
    _log_trace(prof, f"trainer/{TRAIN_ARCH}/W={TRAIN_WORKERS}/S=4096", wall)


def run_trainer() -> dict[str, int]:
    """Phase 7: ``launch/train.py``'s loop at smollm-360m as published
    (``TRAIN_*``): (a) 1 + ``TRAIN_TIMED_ROUNDS`` rounds with the flash
    kernel — the first with every kernel call held (``_TrainHolds``), the
    others timed unheld, every round's gossip result held to the dense mix
    (``_dense_mix_gap``) and its weights on distinct rows
    (``_distinct_rows_gap``); (b) its first round with the plain attention composition
    (``use_flash_kernel=False``) from the same start and batch, its loss
    and distances within the CPU tests' bf16 bounds of (a)'s; (c) that
    round under ``--compressed`` (int8 a leaf), every codec call held.
    Each run's launches counted from zero and held to what the path
    launches. Returns the runs' launches."""
    total = dict.fromkeys(_read_counts(), 0)
    cycles = _sleep_cycles_per_ms()
    cfg, mesh, p1, batches, layout = _trainer_setup()
    b_w = TRAIN_SHAPE.global_batch // TRAIN_WORKERS
    # flash launches a step: the forward and remat's recompute of every
    # attention layer, once a pass of workers_per_pass workers
    pass_workers = layout.workers_per_pass(torch.empty(
        TRAIN_WORKERS, b_w, TRAIN_SHAPE.seq_len, device="meta"))
    passes = -(-TRAIN_WORKERS // pass_workers)
    flash_step = 2 * registry.attention_calls(cfg) * passes
    tokens_round = TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len

    # the dry run of the held round's cell: the trainer's base topology
    base = topo.make_base_topology(TRAIN_WORKERS, "full", TRAIN_SEED)
    dry, _ = _phase7_dry_run(cfg, mesh, base, pass_workers)

    os.environ["REPRO_DEVICES"] = str(TRAIN_WORKERS)

    # (a) the flash run: a held round, then the timed rounds; every
    # round's gossip input kept for its dense-mix check after the round
    mix_in, mix = {}, ops.gossip_mix

    def recording(x, u, w, **kw):
        mix_in.update(x=x, w=w)
        return mix(x, u, w, **kw)

    dense, distinct = [], []
    noise = torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 2)

    round0 = {}

    def after_round(h, params, rlog):
        if h == 0:
            holds.stop()
            round0["params"] = params.clone()          # (d)'s reference
        x, w = mix_in.pop("x"), mix_in.pop("w")
        dense.append(_dense_mix_gap(x, params, rlog.adj))
        distinct.append(_distinct_rows_gap(x, w, rlog.adj, noise))

    ops.gossip_mix = recording
    holds = _TrainHolds(cycles)
    holds.start()
    try:
        with _FirstStepCount() as held_count:
            run, counts, peak = _train_run(cfg, mesh, p1, batches,
                                           1 + TRAIN_TIMED_ROUNDS,
                                           on_round=after_round)
    finally:
        holds.stop()
        ops.gossip_mix = mix
    name = f"{TRAIN_ARCH}/bf16/remat=block/W={TRAIN_WORKERS}/S=4096/flash"
    rounds = len(run.rounds)
    caps = [int(max(r.taus.max(), 1)) for r in run.rounds]
    want_flash = flash_step * sum(caps)
    if counts["gossip_mix"] != rounds or \
            ops.INSTANCE_LAUNCHES["gossip_mix:bf16round"] != rounds or \
            counts["consensus_dist"] != rounds or \
            counts["flash_attention"] != want_flash or \
            counts["flash_attention:bf16"] != want_flash or \
            counts["flash_attention:bf16_tile"] != want_flash or \
            counts["quantize_block"] or counts["gossip_edges"]:
        raise AssertionError(f"{name}: launched {counts}; the path launches "
                             f"gossip_mix (bf16round) and consensus_dist "
                             f"once a round, flash {want_flash} times "
                             f"(the bf16 tile instance)")
    failures = holds.failures()
    if holds.held["flash_attention"] != flash_step * caps[0]:
        failures.append(f"held {holds.held['flash_attention']} flash calls")
    if max(r for r, _ in dense) > 1.0:
        failures.append(f"gossip against the dense mix: {dense} (of its "
                        "bound, max |diff|)")
    if max(max(d["bf16"], d["f32"]) for d in distinct) > 1.0 or \
            min(d["unmixed"] for d in distinct) <= 1.0:
        failures.append(f"the rounds' weights on distinct rows against the "
                        f"dense mix: {distinct} (of the bounds)")
    a0 = run.rounds[0]
    if not (np.array_equal(a0.adj, base) and caps[0] == TRAIN_TAU):
        failures.append("the held round is not the dry run's cell: "
                        f"links {int(a0.adj.sum()) // 2}, tau cap {caps[0]}")
    if held_count.flops != dry["hlo_flops"]:
        failures.append(f"the held round counted {held_count.flops} FLOPs "
                        f"on the card, the dry run {dry['hlo_flops']:.0f}")
    timed = run.rounds[1:]
    secs = sum(r.seconds for r in timed)
    tokens = sum(tokens_round * int(max(r.taus.max(), 1)) for r in timed)
    # the measured round against the roofline: MFU (tau_max local steps'
    # model FLOPs over the round's seconds at the card's bf16 peak) and
    # the dry run's bound over the seconds of the rounds of its tau_max
    mf = rl.model_flops_train(cfg, TRAIN_SHAPE)
    bound_s = max(dry["compute_s"], dry["memory_s"], dry["collective_s"])
    same_tau = [r.seconds for r, c in zip(timed, caps[1:])
                if c == TRAIN_TAU]
    log("phase7", roofline=name, timed_tau_caps=caps[1:],
        mfu=f"{sum(mf * c for c in caps[1:]) / (secs * rl.PEAK_FLOPS):.5f}",
        bound_ms=f"{bound_s * 1e3:.3f}", bound_by=dry["dominant"],
        share_of_bound=f"{bound_s / statistics.mean(same_tau):.5f}"
        if same_tau else "not measured",
        held_round_flops=held_count.flops,
        dry_run_flops=f"{dry['hlo_flops']:.0f}",
        peak_gb=f"{peak:.3f}",
        dry_run_peak_gb=f"{dry['peak_bytes_per_device'] / 1e9:.3f}")
    log("phase7", run=name, P=run.layout.param_count,
        mesh=mesh.shape, slots=[str(d) for d in mesh.devices],
        rounds=rounds, timed_rounds=len(timed),
        seconds_per_round=f"{secs / len(timed):.3f}",
        tokens_per_s=f"{tokens / secs:.1f}",
        round_s=[f"{r.seconds:.3f}" for r in run.rounds],
        held_round_s=f"{run.rounds[0].seconds:.3f}", peak_gb=f"{peak:.3f}",
        loss=[f"{r.loss:.6f}" for r in run.rounds],
        dists=[[float(f"{d:.6g}") for d in r.dists] for r in run.rounds],
        links=[int(r.adj.sum()) // 2 for r in run.rounds],
        tau_caps=caps, worker_passes_a_step=passes,
        launches={k: v for k, v in counts.items() if v},
        held=holds.held, held_worst=holds.worst,
        flash_instances=sorted({f[0] for f in holds.flash}),
        flash_call_max_abs_err=max((f[2] for f in holds.flash),
                                   default=0.0),
        dense_mix_max_abs=[g for _, g in dense],
        dense_mix_of_bound=[f"{r:.4f}" for r, _ in dense],
        distinct_rows_of_bound=[{k: f"{v:.4g}" for k, v in d.items()}
                                for d in distinct],
        path_kernel_times=holds.timed)
    for k, v in counts.items():
        total[k] += v

    # (b) the first round with the plain attention composition
    plain_cfg = replace(cfg, use_flash_kernel=False)
    run_b, counts, peak = _train_run(plain_cfg, mesh, p1, batches, 1)
    b0 = run_b.rounds[0]
    loss_gap = abs(b0.loss - a0.loss) / abs(a0.loss)
    dist_gap = float(np.max(np.abs(b0.dists - a0.dists)
                            / np.maximum(np.abs(a0.dists), 1e-30)))
    if counts["flash_attention"] or counts["gossip_mix"] != 1:
        raise AssertionError(f"plain round: launched {counts}")
    log("phase7", run=name.replace("flash", "plain"), round_s=
        f"{b0.seconds:.3f}", peak_gb=f"{peak:.3f}", loss=f"{b0.loss:.6f}",
        flash_loss=f"{a0.loss:.6f}", loss_rel_gap=f"{loss_gap:.3e}",
        dists=b0.dists.tolist(), flash_dists=a0.dists.tolist(),
        dist_rel_gap=f"{dist_gap:.3e}",
        bounds=dict(loss=TRAIN_LOSS_RTOL, dists=TRAIN_DIST_RTOL))
    if not (loss_gap <= TRAIN_LOSS_RTOL and dist_gap <= TRAIN_DIST_RTOL):
        failures.append(f"flash round against plain: loss {loss_gap:.3e}, "
                        f"distances {dist_gap:.3e}")
    for k, v in counts.items():
        total[k] += v

    # (c) the first round under --compressed, every codec call held
    codec_holds = _TrainHolds(cycles)
    codec_holds.start(("gossip_mix", "quantize_block", "dequantize_block"))
    try:
        run_c, counts, peak = _train_run(cfg, mesh, p1, batches, 1,
                                         compressed=True)
    finally:
        codec_holds.stop()
    leaves = len(run_c.layout.leaf_offsets())
    if counts["quantize_block"] != leaves or \
            counts["dequantize_block"] != leaves or \
            counts["gossip_mix"] != 1 or counts["consensus_dist"] or \
            ops.INSTANCE_LAUNCHES["gossip_mix:bf16round"] != 1:
        raise AssertionError(f"compressed round: launched {counts}, one "
                             f"quantize and dequantize a leaf ({leaves})")
    failures += codec_holds.failures()
    c0 = run_c.rounds[0]
    log("phase7", run=name + "/compressed=int8", round_s=f"{c0.seconds:.3f}",
        peak_gb=f"{peak:.3f}", loss=f"{c0.loss:.6f}",
        loss_rel_gap_to_flash=f"{abs(c0.loss - a0.loss) / a0.loss:.3e}",
        leaves=leaves, launches={k: v for k, v in counts.items() if v},
        held=codec_holds.held, held_worst=codec_holds.worst,
        path_kernel_times=codec_holds.timed)
    for k, v in counts.items():
        total[k] += v
    del run, run_b, run_c
    torch.cuda.empty_cache()

    # (d) and (e): the model axis
    t0 = time.perf_counter()
    counts, fails = run_model_dp(cfg, p1, batches, a0, round0.pop("params"),
                                 cycles)
    log("timing", phase7d_s=f"{time.perf_counter() - t0:.3f}")
    failures += fails
    for k, v in counts.items():
        total[k] += v
    del p1, batches
    torch.cuda.empty_cache()
    for case in MODEL_PIECE_CASES:
        t0 = time.perf_counter()
        counts, fails = run_model_pieces(case, cycles)
        log("timing", **{f"phase7{case.label}_s":
                         f"{time.perf_counter() - t0:.3f}"})
        failures += fails
        for k, v in counts.items():
            total[k] += v
    if failures:
        raise AssertionError("phase 7: " + "; ".join(failures))
    return total


def _rel_norm(pairs) -> float:
    """||a - b|| / ||b|| over the (a, b) pairs, summed in f64 a column
    chunk at a time."""
    num = den = 0.0
    for a, b in pairs:
        a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        for c0 in range(0, a2.shape[1], HOLD_COLS):
            ca = a2[:, c0:c0 + HOLD_COLS].double()
            cb = b2[:, c0:c0 + HOLD_COLS].double()
            num += float((ca - cb).square().sum())
            den += float(cb.square().sum())
    return math.sqrt(num / den)


def _mix_forms(layout) -> int:
    """gossip_mix launches a slot a round: the bf16-rounded form alone
    where every leaf is bf16, else both forms (``collectives.
    matching_mix``: the moe family's f32 router, hybrid's f32 decays, dt
    biases and skips)."""
    narrow = sum(b - a for a, b, _ in layout.narrow_spans())
    return 1 if narrow == layout.param_count else 2


def _launch_check(name: str, counts: dict, mix: int, flash: int,
                  forms: int = 1) -> None:
    """A model-axis run launches gossip_mix and consensus_dist ``mix``
    times (a slot a round; gossip_mix in ``forms`` forms, the
    bf16-rounded one always), flash ``flash`` times (the bf16 tile), no
    codec or edge kernel."""
    if counts["gossip_mix"] != mix * forms or \
            ops.INSTANCE_LAUNCHES["gossip_mix:bf16round"] != mix or \
            counts["consensus_dist"] != mix or \
            counts["flash_attention"] != flash or \
            counts["flash_attention:bf16_tile"] != flash or \
            counts["quantize_block"] or counts["gossip_edges"]:
        raise AssertionError(f"{name}: launched {counts}; the path launches "
                             f"gossip_mix ({forms} forms) and "
                             f"consensus_dist {mix} times, flash {flash}")


def run_model_dp(cfg, p1, batches, a0, round0: torch.Tensor,
                 cycles: float) -> tuple[dict[str, int], list[str]]:
    """Phase 7 (d): smollm-360m as published over (data, model) = (4, 2),
    8 slots of the one card (``within_worker="dp"``: each slot the whole
    replica and 1 sequence of its worker's 2): a held round from (a)'s
    init and first batch — every kernel call held as in (a), its FLOPs on
    the card equal to the dry run's of this cell — against (a)'s first
    round at (4, 1) (loss, distances over sqrt(2): the reference counts a
    whole leaf once a slot, and the parameters), the two slots' replicas
    bit-equal; its seconds net of its checks (no timed round: the room
    (h)-(j) need) -> (launches, failures)."""
    mesh = _trainer_mesh(TRAIN_WORKERS, MODEL_DP_SLOTS, 2)
    layout = steps.train_layout(cfg, TRAIN_SHAPE, mesh)
    b_slot = TRAIN_SHAPE.global_batch // TRAIN_WORKERS // layout.model
    pass_workers = layout.workers_per_pass(torch.empty(
        TRAIN_WORKERS, b_slot, TRAIN_SHAPE.seq_len, device="meta"))
    flash_step = 2 * registry.attention_calls(cfg) * layout.model * \
        -(-TRAIN_WORKERS // pass_workers)
    base = topo.make_base_topology(TRAIN_WORKERS, "full", TRAIN_SEED)
    dry, _ = _phase7_dry_run(cfg, mesh, base, pass_workers, layout.model)
    holds = _TrainHolds(cycles)
    held = {}

    def after_round(h, params, rlog):
        if h:
            return
        holds.stop()
        held["replicas_equal"] = all(torch.equal(params[0], q)
                                     for q in params[1:])
        held["params"] = _rel_norm([(params[0], round0)])

    holds.start()
    try:
        with _FirstStepCount() as held_count:
            run, counts, peak = _train_run(cfg, mesh, p1, batches, 1,
                                           on_round=after_round)
    finally:
        holds.stop()
    name = f"{TRAIN_ARCH}/bf16/W={TRAIN_WORKERS}/model=2/dp/S=4096/flash"
    caps = [int(max(r.taus.max(), 1)) for r in run.rounds]
    _launch_check(name, counts, layout.model, flash_step * sum(caps))
    (d0,) = run.rounds
    net_s = d0.seconds - holds.seconds
    gaps = dict(loss=abs(d0.loss - a0.loss) / abs(a0.loss),
                dists=float(np.max(np.abs(d0.dists / math.sqrt(2.0)
                                          - a0.dists) / np.abs(a0.dists))),
                params=held["params"])
    failures = holds.failures()
    if holds.held["flash_attention"] != flash_step * caps[0]:
        failures.append(f"(d) held {holds.held['flash_attention']} flash "
                        "calls")
    if held_count.flops != dry["hlo_flops"]:
        failures.append(f"(d) the held round counted {held_count.flops} "
                        f"FLOPs on the card, the dry run "
                        f"{dry['hlo_flops']:.0f}")
    if not (np.array_equal(d0.adj, base) and caps[0] == TRAIN_TAU):
        failures.append("(d) the held round is not the dry run's cell")
    if not held["replicas_equal"]:
        failures.append("(d) the slots' replicas differ after a round")
    if not (gaps["loss"] <= MODEL_LOSS_RTOL and gaps["dists"] <=
            MODEL_DIST_RTOL and gaps["params"] <= MODEL_PARAM_RTOL):
        failures.append(f"(d) against (a)'s first round: {gaps}")
    tokens = TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len * caps[0]
    log("phase7", run=name, P=layout.param_count, mesh=mesh.shape,
        slots=len(mesh.devices), worker_passes_a_slot=-(-TRAIN_WORKERS //
                                                        pass_workers),
        held_round_s=f"{d0.seconds:.3f}", net_round_s=f"{net_s:.3f}",
        tokens_per_s=f"{tokens / net_s:.1f}",
        peak_gb_card=f"{peak:.3f}",
        peak_gb_a_slot=f"{peak / len(mesh.devices):.3f}",
        dry_run_peak_gb=f"{dry['peak_bytes_per_device'] / 1e9:.3f}",
        dry_run_args_gb=f"{dry['bytes_per_device'] / 1e9:.3f}",
        held_round_flops=held_count.flops,
        dry_run_flops=f"{dry['hlo_flops']:.0f}",
        loss=f"{d0.loss:.6f}", a_loss=f"{a0.loss:.6f}",
        dists=d0.dists.tolist(), a_dists=a0.dists.tolist(),
        gaps={k: f"{v:.3e}" for k, v in gaps.items()},
        bounds=dict(loss=MODEL_LOSS_RTOL, dists=MODEL_DIST_RTOL,
                    params=MODEL_PARAM_RTOL),
        launches={k: v for k, v in counts.items() if v}, held=holds.held,
        held_worst=holds.worst,
        flash_call_max_abs_err=max((f[2] for f in holds.flash), default=0.0),
        path_kernel_times=holds.timed)
    del run
    torch.cuda.empty_cache()
    return counts, failures


def _span_d2(x: torch.Tensor, u: torch.Tensor, spans) -> torch.Tensor:
    """||x - u_k||^2 [K] over the column spans of x [L] and u [K, L], in
    f64 a column chunk at a time."""
    out = torch.zeros(u.shape[0], dtype=torch.float64, device=u.device)
    for a, b in spans:
        for c0 in range(a, b, HOLD_COLS):
            c1 = min(b, c0 + HOLD_COLS)
            out += (x[c0:c1].double() - u[:, c0:c1].double()).square() \
                .sum(dim=1)
    return out


def run_model_pieces(case: ModelCase, cycles: float
                     ) -> tuple[dict[str, int], list[str]]:
    """Phase 7 (e)-(j): ``case.arch`` at its published widths, depth
    ``case.layers``, over (data, model) = (2, 2) (``within_worker="tp"``:
    each slot its pieces by the spec rules — (e) internlm2-20b 24 / 4
    heads a slot, (f) olmoe-1b-7b 8 heads and 32 experts a slot, (g)
    zamba2-7b 16 heads, Mamba2's in_proj columns, conv_w channels and
    out_proj rows, (h) xlstm-1.3b 2 heads and the mLSTM's and sLSTM's
    projections' pieces; ``"dp"``: (i) whisper-large-v3 and (j)
    qwen2-vl-2b, each slot the whole replica and 1 of its worker's 2
    sequences), one held round (every kernel call held as in (a), its
    FLOPs on the card equal to the dry run's of this cell, its distances
    within ``MODEL_RULE_RTOL`` of the reference's rule on its slots' own
    inputs and the leaves every slot holds whole equal on every slot),
    then the same round at (2, 1) from the same init and batch: loss, the
    parameters (relative in norm) and the distances against the
    reference's rule on the (2, 1) rows, sqrt(d^2 + d^2 of the leaves
    every slot holds whole) (sqrt(2) d in dp), as each slot counts those
    once, within ``case.dist_rtol`` -> (launches, failures)."""
    cfg = replace(get_config(case.arch), use_flash_kernel=True,
                  **case_depth(case))
    # (e)'s (2, 1) round's gradients are 15.3 GB blocks: its peak (the dry
    # run's 72.1 GB) fits the card only where the allocator can grow a
    # segment in place of leaving reserved blocks it cannot join
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        return _model_pieces(case, cfg, cycles)
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")


def _model_pieces(case: ModelCase, cfg, cycles: float
                  ) -> tuple[dict[str, int], list[str]]:
    """``run_model_pieces``' runs and checks."""
    label, arch, shape = case.label, case.arch, case_shape(case)
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    p1 = registry.init_params(cfg, gen)
    batches = [next(trainer.random_batches(cfg, shape, TRAIN_SEED + 1,
                                           "cuda"))]
    base = topo.make_base_topology(TP_WORKERS, "full", TRAIN_SEED)
    runs, total, failures = {}, None, []
    orig_dist = ops.consensus_dist
    tag = f"({label}) {arch}"
    for model in (2, 1):
        mesh = _trainer_mesh(TP_WORKERS, TP_WORKERS * model, model)
        layout = steps.train_layout(cfg, shape, mesh)
        b_slot = shape.global_batch // TP_WORKERS // \
            (model if cfg.within_worker == "dp" else 1)
        pass_workers = layout.workers_per_pass(torch.empty(
            TP_WORKERS, b_slot, shape.seq_len, device="meta"))
        flash_step = 2 * registry.attention_calls(cfg) * model * \
            -(-TP_WORKERS // pass_workers)
        holds = _TrainHolds(cycles, arch)
        whole, slot_d2 = [], []
        if model == 2:
            t0 = time.perf_counter()
            dry = dryrun.run_cell(
                arch, shape, mesh=mesh, verbose=False,
                cfg_overrides={**case_depth(case), "use_flash_kernel": True},
                train_kw=dict(tau_max=TRAIN_TAU, adj=base,
                              measure_distances=True))
            trace_s = time.perf_counter() - t0
            holds.start()
            whole_names = {l.name for l in layout.leaf_offsets()
                           if layout.splits.get(l.name) is None}
            # each slot's squared distance over its split and its whole
            # leaves, from the inputs its consensus_dist call takes
            parts = [[(l.start, l.stop) for l in layout.leaf_offsets()
                      if (l.name in whole_names) == w] for w in (False, True)]
            held_dist = ops.consensus_dist

            def spy(x, u):
                d = held_dist(x, u)
                with holds._checking():
                    slot_d2.append([_span_d2(x, u, sp) for sp in parts])
                return d

            ops.consensus_dist = spy
        else:
            # the (2, 1) rows' squared distance over the leaves the (2, 2)
            # slots hold whole
            spans = [(l.start, l.stop) for l in layout.leaf_offsets()
                     if l.name in whole_names]

            def spy(x, u):
                with _disable_current_modes():
                    whole.append(_span_d2(x, u, spans))
                return orig_dist(x, u)

            ops.consensus_dist = spy
        held_count = _FirstStepCount()
        try:
            with held_count if model == 2 else contextlib.nullcontext():
                run, counts, peak = _train_run(cfg, mesh, p1, batches, 1,
                                               shape=shape, lr=case.lr)
        finally:
            holds.stop()
            ops.consensus_dist = orig_dist
        r0 = run.rounds[0]
        cap = int(max(r0.taus.max(), 1))
        _launch_check(f"{arch}/model={model}", counts, model,
                      flash_step * TRAIN_TAU, _mix_forms(layout))
        failures += holds.failures()
        if not (np.array_equal(r0.adj, base) and cap == TRAIN_TAU):
            failures.append(f"{tag} at model={model}: tau cap {cap} or "
                            "the topology is not the dry run's cell's")
        # the held round's time without its checks' (the holds')
        net_s = r0.seconds - holds.seconds
        extra = {}
        if model == 2:
            if holds.held["flash_attention"] != flash_step * TRAIN_TAU:
                failures.append(f"{tag} held {holds.held['flash_attention']}"
                                " flash calls")
            if held_count.flops != dry["hlo_flops"]:
                failures.append(f"{tag}: the held round counted "
                                f"{held_count.flops} FLOPs on the card, the "
                                f"dry run {dry['hlo_flops']:.0f}")
            bound_s = max(dry["compute_s"], dry["memory_s"],
                          dry["collective_s"])
            if len(slot_d2) != model:
                raise AssertionError(f"{tag}: {len(slot_d2)} distance calls "
                                     f"in the held round, not {model}")
            rule = torch.stack([a + b for a, b in slot_d2]).sum(0).sqrt() \
                .cpu().numpy()
            rule_gap = float(np.max(np.abs(r0.dists - rule) / rule))
            if rule_gap > MODEL_RULE_RTOL:
                failures.append(f"{tag}: distances {rule_gap:.3e} from the "
                                "rule on the slots' inputs")
            if not all(torch.equal(slot_d2[0][1], d2[1])
                       for d2 in slot_d2[1:]):
                failures.append(f"{tag}: the whole leaves' distances "
                                "differ between the slots")
            extra = dict(
                rule_dists=rule.tolist(), rule_gap=f"{rule_gap:.3e}",
                held_round_flops=held_count.flops,
                dry_run_flops=f"{dry['hlo_flops']:.0f}",
                dry_run_trace_s=f"{trace_s:.1f}",
                dry_run_bound_ms=f"{bound_s * 1e3:.3f}",
                dry_run_bound_by=dry["dominant"],
                share_of_bound=f"{bound_s / net_s:.5f}",
                dry_run_peak_gb=f"{dry['peak_bytes_per_device'] / 1e9:.3f}",
                dry_run_args_gb=f"{dry['bytes_per_device'] / 1e9:.3f}",
                holds_s=f"{holds.seconds:.3f}")
        runs[model] = dict(
            loss=r0.loss, dists=r0.dists, seconds=r0.seconds, peak=peak,
            layout=layout, whole=whole,
            params=tuple(q.cpu() for q in run.params) if model == 2
            else run.params)
        total = counts if total is None else \
            {k: total[k] + v for k, v in counts.items()}
        tokens = shape.global_batch * shape.seq_len * cap
        log("phase7", run=f"{arch}/bf16/layers={cfg.num_layers}/"
            f"W={TP_WORKERS}/B={shape.global_batch}/model={model}/"
            f"{cfg.within_worker}/S={shape.seq_len}/flash", case=label,
            P_a_slot=layout.param_count, mesh=mesh.shape,
            round_s=f"{r0.seconds:.3f}", net_round_s=f"{net_s:.3f}",
            tokens_per_s=f"{tokens / net_s:.1f}",
            peak_gb_card=f"{peak:.3f}", loss=f"{r0.loss:.6f}",
            dists=r0.dists.tolist(), tau_cap=cap,
            worker_passes=-(-TP_WORKERS // pass_workers),
            launches={k: v for k, v in counts.items() if v},
            held=holds.held, held_worst=holds.worst,
            flash_call_max_abs_err=max((f[2] for f in holds.flash),
                                       default=0.0),
            path_kernel_times=holds.timed, **extra)
        del run
        torch.cuda.empty_cache()
    t, o = runs[2], runs[1]
    want = np.sqrt(o["dists"].astype(np.float64) ** 2
                   + torch.stack(o["whole"]).sum(0).cpu().numpy())
    pairs = []
    for l in t["layout"].leaf_offsets():
        l1 = next(m for m in o["layout"].leaf_offsets() if m.name == l.name)
        one = o["params"][:, l1.start:l1.stop].view(TP_WORKERS, *l1.shape)
        pieces = sharding.cut_leaf(one, t["layout"].splits.get(l.name), 2,
                                   lead=1)
        for j, piece in enumerate(pieces):
            pairs.append((t["params"][j][:, l.start:l.stop].cuda()
                          .view(TP_WORKERS, *l.shape), piece))
    gaps = dict(loss=abs(t["loss"] - o["loss"]) / abs(o["loss"]),
                dists=float(np.max(np.abs(t["dists"] - want) / want)),
                params=_rel_norm(pairs))
    log("phase7", model_axis_against_one_slot=arch, case=label,
        dists=t["dists"].tolist(), one_slot_dists=o["dists"].tolist(),
        rule_dists=want.tolist(),
        gaps={k: f"{v:.3e}" for k, v in gaps.items()},
        bounds=dict(loss=MODEL_LOSS_RTOL, params=MODEL_PARAM_RTOL,
                    dists=case.dist_rtol))
    if not (gaps["loss"] <= MODEL_LOSS_RTOL and gaps["params"] <=
            MODEL_PARAM_RTOL and gaps["dists"] <= case.dist_rtol):
        failures.append(f"{tag} (2, 2) against (2, 1): {gaps}")
    del runs, pairs, p1
    torch.cuda.empty_cache()
    return total, failures


def trace_lm_rounds(adapter, data) -> None:
    """One traced round of each registry-path algorithm: the device's
    busy time (the sum of its kernels' times; one stream, so they do not
    overlap) against the round's wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    for algo in ("fedhp", "dpsgd"):
        _lm_run(adapter, data, algo, 1, fused_engine=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _lm_run(adapter, data, algo, 1, fused_engine=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _log_trace(prof, f"{algo}/smollm-360m-4l", wall)


def _log_trace(prof, path: str, wall: float) -> None:
    """A profiled round's device-busy time (the sum of its kernels'
    times; one stream, so they do not overlap) against its wall time,
    the top kernels, then the port's own wherever they rank."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    log("trace", path=path, rounds=1, wall_s=f"{wall:.4f}",
        device_busy_s=f"{busy_us / 1e6:.4f}",
        idle_share=f"{1 - busy_us / 1e6 / wall:.4f}", kernels=len(kernels))
    ours = [e for e in kernels if e not in top and any(
        f"{name}_kernel" in e.key or f"{name}_f32" in e.key
        for name in ("gossip_mix", "quantize", "dequantize", "sparsify",
                     "gossip_edges", "robust_gossip", "flash_fwd",
                     "flash_short", "flash_bf16", "consensus"))]
    for e in top + ours:
        log("trace", kernel=repr(e.key[:90]), calls=e.count,
            device_ms=f"{e.self_device_time_total / 1e3:.3f}",
            share=f"{e.self_device_time_total / busy_us:.4f}")


def bf16_tile_sass(lib: Path) -> dict[str, dict[str, int]]:
    """The bf16 tile instance's tensor-core instructions in the built
    library's SASS (``cuobjdump -sass``), per head width: its kernels
    must issue bf16 warpgroup products (HGMMA) and no TF32 ``mma.sync``
    (an HMMA on TF32 operands, the instance it replaced); raises
    otherwise -> {hd: {"HGMMA": n, "HMMA": n, "TF32": n}}."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
        "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_bf16_kernelILi(\d+)E", line)
            current = counts.setdefault(m.group(1), dict.fromkeys(
                ("HGMMA", "HMMA", "TF32"), 0)) if m else None
        elif current is not None:
            for op in ("HGMMA", "HMMA"):
                current[op] += bool(re.search(rf"\b{op}\b", line))
            current["TF32"] += "HMMA" in line and "TF32" in line
    if sorted(map(int, counts)) != sorted(ops.FLASH_HEAD_DIMS) or any(
            c["HGMMA"] == 0 or c["TF32"] for c in counts.values()):
        raise AssertionError(f"the bf16 tile instance's SASS: {counts}; "
                             "every head width must issue HGMMA and no "
                             "TF32 HMMA")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    lib, nvcc_log = ops.build()
    build_s = time.perf_counter() - t0
    if sys.argv[1:] == ["--trace"]:
        log("trace", card=repr(card), build_s=f"{build_s:.3f}")
        adapter = lm_adapter()
        data, _ = _lm_data()
        trace_lm_rounds(adapter, data)
        return 0
    if sys.argv[1:] == ["--serve"]:
        log("serve", card=repr(card), build_s=f"{build_s:.3f}")
        run_serving()
        return 0
    if sys.argv[1:] == ["--sharded"]:
        log("sharded", card=repr(card), build_s=f"{build_s:.3f}")
        t0 = time.perf_counter()
        run_sharded(_lm_data()[0])
        log("timing", phase6_s=f"{time.perf_counter() - t0:.3f}")
        return 0
    if sys.argv[1:] == ["--train", "--trace"]:
        log("trace", card=repr(card), build_s=f"{build_s:.3f}")
        trace_trainer_round()
        return 0
    if sys.argv[1:] == ["--train"]:
        log("train", card=repr(card), build_s=f"{build_s:.3f}")
        t0 = time.perf_counter()
        run_trainer()
        log("timing", phase7_s=f"{time.perf_counter() - t0:.3f}")
        return 0
    ptxas = [ln.strip() for ln in nvcc_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("phase1", card=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{build_s:.3f}",
        library=lib.name, ptxas=ptxas)
    log("phase1", bf16_tile_sass=bf16_tile_sass(lib))

    cycles_per_ms = _sleep_cycles_per_ms()
    marks = [("start", time.perf_counter())]
    kernels, phase2_s = [], {}
    checks = [(c.__name__, c) for c in (
        check_gossip_mix, check_gossip_mix_lanes, check_codecs,
        check_gossip_edges, check_robust_gossip, check_flash_attention)]
    checks += [("check_flash_attention_bf16", lambda c: check_flash_attention(
        c, torch.bfloat16)), ("check_consensus_dist", check_consensus_dist),
        ("check_gossip_mix_trainer", check_gossip_mix_trainer)]
    t0 = time.perf_counter()
    launch_floor(cycles_per_ms)
    phase2_s["launch_floor"] = f"{time.perf_counter() - t0:.1f}"
    for name, check in checks:
        t0 = time.perf_counter()
        out = check(cycles_per_ms)
        phase2_s[name] = f"{time.perf_counter() - t0:.1f}"
        kernels += out if isinstance(out, list) else [out]
    log("timing", phase2_by_check_s=phase2_s)
    marks.append(("phase2", time.perf_counter()))
    launches = dict.fromkeys(_read_counts(), 0)
    for k, v in run_main_path().items():
        launches[k] += v
    marks.append(("phase3_mlp", time.perf_counter()))
    adapter = lm_adapter()
    data, data_s = _lm_data()
    log("phase3", registry_corpus=LM_SPEC, setup_s=f"{data_s:.3f}",
        sequences=len(data[0].x) + len(data[1]))
    lm_launches, f32_fedhp = run_lm_path(adapter, data)
    for k, v in lm_launches.items():
        launches[k] += v
    marks.append(("phase3_registry", time.perf_counter()))
    for k, v in run_lm_bf16_path(data, f32_fedhp).items():
        launches[k] += v
    marks.append(("phase3_registry_bf16", time.perf_counter()))
    for k, v in run_family_paths(data).items():
        launches[k] += v
    marks.append(("phase3_families", time.perf_counter()))
    check_engines_agree()
    check_lanes_agree()
    marks.append(("phase4_mlp", time.perf_counter()))
    check_lm_engines_agree(adapter, data)
    marks.append(("phase4_registry", time.perf_counter()))
    check_lm_bf16_engines_agree(data)
    marks.append(("phase4_registry_bf16", time.perf_counter()))
    check_family_engines_agree(data)
    marks.append(("phase4_families", time.perf_counter()))
    for k, v in run_sharded(data).items():
        launches[k] += v
    marks.append(("phase6_sharded", time.perf_counter()))
    del adapter, data
    torch.cuda.empty_cache()
    for k, v in run_serving().items():
        launches[k] += v
    marks.append(("phase5_serving", time.perf_counter()))
    for k, v in run_trainer().items():
        launches[k] += v
    marks.append(("phase7_trainer", time.perf_counter()))
    for kernel in kernels:
        kernel["launches"] = launches[kernel.get("count_key",
                                                 kernel["name"])]
        if kernel["launches"] == 0:
            raise AssertionError(f"{kernel['name']} never launched on the "
                                 "main path")
    log("timing", build_s=f"{build_s:.3f}",
        **{f"{name}_s": f"{t - marks[i][1]:.3f}"
           for i, (name, t) in enumerate(marks[1:])})

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: kernel[k] for k in order}
                                  for kernel in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
