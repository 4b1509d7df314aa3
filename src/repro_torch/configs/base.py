"""Configs: the run configuration of the FedHP technique (Alg. 1-3) and
the model-architecture description of the registry models — field-for-
field copies of ``repro.configs.base.FedHPConfig`` and ``ModelConfig``
with the same defaults, so one config value drives either package. The
input-shape table (``SHAPES``) and ``RunConfig`` arrive with the launch
and serving slice (ROADMAP.md queue 1, item 10)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description shared by the whole model zoo.

    ``family`` selects the model implementation in
    ``repro_torch.models.registry``: dense | moe | encdec | hybrid |
    xlstm | vlm (only ``dense`` is ported)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # expert hidden dim (if != d_ff)
    num_shared_experts: int = 0
    # --- attention variants ---
    sliding_window: int = 0         # 0 -> full attention
    global_every: int = 0           # gemma3: 1 global layer every N (0 -> all global)
    rope_theta: float = 10_000.0
    mrope: bool = False             # qwen2-vl multimodal RoPE
    # --- activation ---
    act: str = "silu"               # silu | gelu | relu2 (squared relu)
    # --- SSM / recurrent ---
    ssm_state: int = 0              # mamba2 state dim
    ssm_every: int = 0              # hybrid: attn block every N mamba blocks
    slstm_every: int = 0            # xlstm: sLSTM block every N mLSTM blocks
    # --- enc-dec ---
    encoder_layers: int = 0
    decoder_layers: int = 0
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # --- distribution (per-arch defaults of the reference's meshes) ---
    worker_axes: tuple[str, ...] = ("pod", "data")   # mesh axes enumerating DFL workers
    fsdp_axes: tuple[str, ...] = ()                   # axes for FSDP param sharding within worker
    tp_axes: tuple[str, ...] = ("model",)             # tensor-parallel axes within worker
    within_worker: str = "tp"       # tp | dp
    # --- perf knobs (defaults = paper-faithful baseline) ---
    serve_seq_shard: bool = False   # sequence parallelism in serving
    moe_shard_groups: int = 0       # shard-local MoE dispatch groups
    use_flash_kernel: bool = False  # the hand-written flash-attention
    # kernel for the full-sequence paths (kernels/csrc/flash_attention.cu)
    remat: str = "block"            # none | block | full
    skip_shapes: tuple[str, ...] = ()                 # documented skips
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        """The attention head width: ``head_dim`` or d_model / heads."""
        return self.head_dim or self.d_model // self.num_heads


@dataclass(frozen=True)
class FedHPConfig:
    """Controls the paper's technique (Alg. 1-3)."""

    num_workers: int = 30
    rounds: int = 200
    tau_max: int = 50                # cap on local updating frequency
    tau_init: int = 10
    lr: float = 0.1
    lr_decay: float = 0.98
    batch_size: int = 32
    beta1: float = 0.5               # EMA for consensus-distance estimates (Eq. 39)
    beta2: float = 0.1               # EMA for D_max threshold (Eq. 43)
    epsilon: float = 1.0             # waiting-time budget (Eq. 12)
    base_topology: str = "full"      # full | ring | erdos:<p>
    algorithm: str = "fedhp"         # fedhp | dpsgd | adpsgd | ldsgd | pens
    seed: int = 0
    # what each worker trains (core/modelspec.py): "mlp" is the paper's
    # synthetic classifier; "<family>[:key=val,...]" (dense / moe /
    # hybrid / xlstm) trains a tiny registry LM from models/registry.py
    # on the Markov token corpus — e.g. "dense:layers=2,d=32". The
    # engines build the matching ModelAdapter via modelspec.adapter_for.
    model: str = "mlp"
    # fused engine (core/fused.py): adaptive strategies replan every this
    # many rounds; 1 == reference behavior (replan each round), larger
    # segments freeze (A^h, tau^h) between replans for throughput.
    # Static-plan strategies always fuse the whole horizon.
    replan_every: int = 1
    # compressed gossip (core/compression.py): "none" sends raw f32 params,
    # "int8" sends per-tile-scaled int8 round trips (ChocoSGD-style,
    # ~3.5-4x fewer wire bits), "topk:<k>" / "randk:<k>" send k-coordinate
    # sparsified payloads (k a fraction of P when < 1, an absolute count
    # otherwise; top-k ships value+index pairs, rand-k values + a shared
    # mask seed). Eq. 10 charges comm time / the codec's wire ratio.
    compress: str = "none"    # "none" | "int8" | "topk:<k>" | "randk:<k>"
    # gossip representation: "dense" mixes through the [W, W] matrix
    # (O(W^2 P) per round — fine to ~hundreds of workers), "sparse"
    # mixes over the round topology's edge list (O(E P):
    # jax.ops.segment_sum in the reference engine, the
    # kernels/gossip_edges.py gather-mix-scatter kernel in the fused
    # engine). Same host-side control plane either way; device
    # trajectories agree to summation-order float drift (<= 1e-5).
    gossip: str = "dense"     # "dense" | "sparse"
    # sharded execution (runtime/shardexec.py): split the flat [W, P]
    # worker matrix row-wise over the worker axis of a device mesh
    # (launch/mesh.make_worker_mesh by default, or run_dfl(mesh=...)).
    # Local SGD and the join blend run per-slice under shard_map; gossip
    # always takes the edge-list form, routed cross-shard by one
    # lax.ppermute per distinct shard offset. Host control plane (and so
    # every host-side record field) is identical to the single-device
    # path; device trajectories agree to summation-order float drift.
    # Excludes: pens, cfg.byzantine/robust, leafmap codecs, AD-PSGD,
    # batched fused seeds.
    sharded: bool = False
    # error feedback: carry the per-worker compression residual into the
    # next round's payload (keeps compressed mixing unbiased); False ==
    # naive compressed mixing (stalls at the int8 step floor / freezes
    # never-shipped top-k coordinates — test only)
    error_feedback: bool = True
    # compression-aware planner (FedHP): solve tau* / topology (Alg. 3)
    # against the learned effective link times beta / wire_ratio instead
    # of the raw beta — the planner then trades the cheaper wire against
    # the consensus budget like the engines actually pay it (docs/
    # PLANNER.md). False reproduces the compression-blind PR 3/4 planner.
    planner_wire_aware: bool = True
    # replan-cadence sparsity feedback (FedHP + sparse codecs only):
    # halve the codec's k whenever the tracked consensus distance has
    # halved since the last tightening (controller.SparsityScheduler),
    # never below sparse_k_floor * the initial k
    tighten_k: bool = False
    sparse_k_floor: float = 0.125
    # consensus step size for x̂-tracked top-k gossip (ChocoSGD gamma):
    # innovations mix damped, x' = x + gamma (W x̂ - x̂) — stable well
    # below ~0.3 for keep fractions >= 0.05 (rand-k / int8 ignore it)
    sparse_gamma: float = 0.25
    # LD-SGD alternation (baseline)
    ldsgd_i1: int = 4
    ldsgd_i2: int = 1
    # PENS neighbor selection (baseline)
    pens_top_m: int = 3
    pens_sample: int = 6
    # dynamic membership (ChurnSchedule; 0.0 disables churn)
    churn_rate: float = 0.0          # fraction of the fleet that departs
    churn_seed: int = 101            # schedule generator seed
    churn_min_alive: int = 2         # never drop below this many workers
    crash_timeout: float = 2.0       # failure-detection timeout (s) charged
    # to the round when a worker crashes (graceful leaves cost nothing)
    straggle_factor: float = 4.0     # mu multiplier during a straggler spike
    straggle_duration: int = 5       # spike length in rounds
    # Byzantine scenario axis (core/robust.py): workers in ``byzantine``
    # gossip corrupted rows — their LOCAL training is honest, only the
    # transmitted copy lies on the wire (``byzantine_attack``:
    # "signflip[:scale]" sends -scale*x, "largenorm[:scale]" sends
    # scale*x). ``robust`` picks the aggregation countermeasure:
    # "trimmed:<b>" drops the b largest + b smallest values per
    # coordinate before averaging the closed neighborhood (b a fraction
    # of the neighborhood when < 1, an absolute count otherwise),
    # "median" takes the coordinate-wise median — both replace the
    # weighted Eq. 5 mix with an unweighted robust average, run in the
    # reference engine AND the fused scan (kernels/robust_gossip.py),
    # and are synchronous-only. AD-PSGD instead takes "screen:<z>":
    # per-event accept/reject of the incoming pairwise payload against
    # z times the EMA of the receiver's own delta norms (reject keeps
    # the self-model; counts land in History.screen_rejects). No robust
    # or byzantine axis composes with cfg.compress or cfg.sharded.
    byzantine: tuple[int, ...] = ()  # worker ids that attack the wire
    byzantine_attack: str = "signflip"
    robust: str = "none"  # "none" | "trimmed:<b>" | "median" | "screen:<z>"
    # time-varying non-IID drift (data/partition.DriftingPartition):
    # every drift_every rounds the p-skew class -> worker-group pinning
    # rotates one worker over the fleet, so each worker's local label
    # distribution slowly cycles while the global distribution stays
    # fixed. 0 disables drift (the paper's static partition).
    drift_every: int = 0
