"""Configs: the run configuration of the FedHP technique (Alg. 1-3), the
model-architecture description of the registry models, the input-shape
table and the launcher's run configuration — field-for-field copies of
``repro.configs.base.FedHPConfig``, ``ModelConfig``, ``InputShape``,
``SHAPES`` and ``RunConfig`` with the same defaults (and
``ModelConfig``'s parameter counts), so one config value drives either
package."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class InputShape:
    """One input shape of the registry models' cells."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description shared by the whole model zoo.

    ``family`` selects the model implementation in
    ``repro_torch.models.registry``: dense | moe | encdec | hybrid |
    xlstm | vlm."""

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

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head): the
        reference's formula, which sizes the launcher's ``SimCluster``
        payload (32 bits a parameter)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + hd * self.num_heads * d
        if self.family == "xlstm":
            # mLSTM blocks: qkv + gates + out + up/down proj factor ~ 8 d^2
            blocks = L * 8 * d * d
            return emb + blocks
        if self.num_experts:
            ff_exp = self.num_experts * 3 * d * (self.moe_d_ff or self.d_ff)
            router = d * self.num_experts
            shared = self.num_shared_experts * 3 * d * (self.moe_d_ff
                                                        or self.d_ff)
            blocks = L * (attn + ff_exp + router + shared + 2 * d)
        else:
            n_ff = 3 if self.act in ("silu", "gelu") else 2  # gated vs plain
            blocks = L * (attn + n_ff * d * self.d_ff + 2 * d)
        if self.family == "hybrid":
            # mamba2 blocks: in_proj(2*d_in) + conv + dt/B/C + out_proj
            d_in = 2 * d
            blocks = L * (2 * d * d_in + d_in * (self.ssm_state * 2 + 4)
                          + d_in * d)
            # plus shared attention block(s)
            blocks += 2 * (attn + 3 * d * self.d_ff)
        if self.family == "encdec":
            # encoder + decoder with cross attention
            enc = self.encoder_layers * (attn + 2 * d * self.d_ff + 2 * d)
            dec = self.decoder_layers * (2 * attn + 2 * d * self.d_ff
                                         + 3 * d)
            blocks = enc + dec
        return emb + blocks

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.num_experts:
            return self.param_count()
        dense_like = dataclasses.replace(
            self, num_experts=0, experts_per_token=0, num_shared_experts=0)
        d_ffe = self.moe_d_ff or self.d_ff
        act_ff = self.num_layers * (
            (self.experts_per_token + self.num_shared_experts) * 3
            * self.d_model * d_ffe + self.d_model * self.num_experts)
        # dense_like.param_count() includes a dense FFN of d_ff; remove it
        base = dense_like.param_count() \
            - self.num_layers * 3 * self.d_model * self.d_ff
        return base + act_ff

    def shape_list(self) -> list[InputShape]:
        """The input shapes of ``SHAPES`` this architecture runs."""
        return [s for k, s in SHAPES.items() if k not in self.skip_shapes]


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
    # worker matrix row-wise over the shards of a worker mesh
    # (shardexec.default_worker_mesh, or run_dfl(mesh=...) with a
    # launch/mesh.make_worker_mesh mesh). Local SGD and the join blend run
    # per block; gossip always takes the edge-list form, routed
    # cross-shard by shard offset through the gossip_edges kernel. Host
    # control plane (and so every host-side record field) is identical to
    # the single-device path; device trajectories agree to
    # summation-order float drift.
    # Excludes: pens, cfg.byzantine/robust, leafmap codecs, AD-PSGD.
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


@dataclass(frozen=True)
class RunConfig:
    """One launcher run: architecture, input shape, mesh, step count,
    logging and checkpoint cadence, and the FedHP configuration."""

    arch: str = "smollm-360m"
    shape: str = "train_4k"
    multi_pod: bool = False
    steps: int = 100
    log_every: int = 10
    checkpoint_dir: str = ""
    checkpoint_every: int = 50
    fedhp: FedHPConfig = field(default_factory=FedHPConfig)
    extra: dict[str, Any] = field(default_factory=dict)
