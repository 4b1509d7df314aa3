"""The reference's trainer and matching collectives on a 4-device host
platform, run as a script in a subprocess (the device count must be set
before JAX starts, and the test process keeps one device):

    python tests/_torch_train_ref.py OUT_DIR CASE [CASE ...]

writes ``OUT_DIR/<case>.npz`` for each case:

- ``f32`` / ``bf16``: ``launch/train.py``'s round loop on the smollm-360m
  smoke config (``dtype`` as named), W = 4 on a ``(4, 1)`` ``("data",
  "model")`` mesh, 4 rounds, tau_max 2, S = 64, a global batch of 8, lr
  0.01: the init, every round's batch, (adj, taus) in and out, lr, loss,
  neighbour distances and parameters after the round. ``f32`` also saves
  checkpoints every 2 rounds under ``OUT_DIR/ckpt`` and then resumes
  from a copy of them to 6 rounds, as ``--resume`` does (``resume/...``
  keys; the copy, ``OUT_DIR/ckpt_resume``, takes the resumed run's).
- ``int8``: the same loop with ``--compressed`` (f32, 3 rounds);
  ``bf16_int8``: the same in bf16.
- ``whisper``, ``moe``, ``hybrid``, ``xlstm``, ``vlm``: the same loop on
  the smoke config of whisper-large-v3 (the encdec family: ``frames``,
  ``tokens`` and ``labels`` batches), olmoe-1b-7b, zamba2-7b, xlstm-1.3b
  and qwen2-vl-2b (``vision_embeds`` and ``mrope_positions`` besides the
  tokens), f32, 2 rounds, each at its ``FAMILY_CASES`` lr
  (``FAMILY@LR`` at another; ``FAMILY:nudge`` from the init moved one
  ulp a weight).
- ``model_dp``, ``model_tp``, ``model_tp_kv1``: the same loop on a
  ``(2, 2)`` ``("data", "model")`` mesh — W = 2 workers, each over 2
  model slots — f32, 2 rounds, tau_max 2, S = 64, a global batch of 8:
  smollm-360m's smoke config (``within_worker="dp"``: the worker's 4
  sequences split 2 a slot), internlm2-20b's (``"tp"``: every leaf
  split by the spec rules) and internlm2-20b's with ``num_kv_heads=1``
  (the kv heads do not divide the model axis: wk / wv replicate);
  ``model_tp_int8``: internlm2-20b's with ``--compressed`` (int8 a leaf
  shard: each slot codes its own pieces); ``model_moe``,
  ``model_moe_shared``, ``model_moe_int8`` and ``model_hybrid``: the same
  on olmoe-1b-7b's smoke config (its experts over the model axis; int8
  with ``--compressed``), kimi-k2-1t-a32b's (a shared expert besides)
  and zamba2-7b's (Mamba2's projections split; at its family lr,
  ``MODEL_LRS``); ``model_xlstm``, ``model_whisper`` and ``model_vlm``:
  the same on xlstm-1.3b's smoke config (``"tp"``: the mLSTM's and
  sLSTM's projections split), whisper-large-v3's and qwen2-vl-2b's
  (``"dp"``: each slot 2 of its worker's 4 sequences). ``CASE:nudge``
  runs a model-axis case from the init moved one ulp, ``CASE:nofma``
  with XLA's CPU code built without fused multiply-adds (a process of
  its own: the flag holds for the whole process), and ``CASE:fromTAG``
  one round step of the case's config from the state in
  ``OUT_DIR/CASE:fromTAG.in.npz`` (``step_from``).
- ``collectives``: ``gossip_fn`` (with and without distances, and on
  the tree cast to bf16), ``gossip_compressed_fn`` (int8, top-k, rand-k
  at two steps; int8 and rand-k also on the tree cast to bf16) and
  ``ring_allreduce_mean_fn`` on a random ``[4, 6,
  32]`` + ``[4, 40]`` tree over a full and a ring topology, their inputs
  and outputs; and ``launch/mesh.make_debug_mesh``'s shapes with
  ``shrink=True`` on the 4 devices (``mesh/...``).

Two departures from the reference's loop, each forced by a fault of the
reference on this host (ROADMAP.md queue 3): the parameters go back to
host arrays before each step call (fed its own ``data``-sharded output,
the jitted step raises from round 1), and under ``--compressed`` the
step's call ``gossip_c(params, err)`` gets the rand-k ``step`` argument
its builder requires (0; the int8 codec ignores it), without which the
step does not trace.
"""
from __future__ import annotations

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
# ``CASE:nofma`` (a model-axis case): XLA's CPU code generated for AVX, an
# instruction set without fused multiply-adds, so that no product and sum
# is contracted into one rounding (the whole process: the flag is read
# when JAX starts)
if any(c.endswith(":nofma") for c in sys.argv[2:]):
    os.environ["XLA_FLAGS"] += " --xla_cpu_max_isa=AVX"

import dataclasses  # noqa: E402
import shutil  # noqa: E402
import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager  # noqa: E402
from repro.checkpoint.store import elastic_reshard  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.configs.base import FedHPConfig, InputShape  # noqa: E402
from repro.core import topology as topo  # noqa: E402
from repro.core.consensus import ConsensusTracker  # noqa: E402
from repro.core.controller import AdaptiveController  # noqa: E402
from repro.core.topology import make_base_topology  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.runtime import collectives, sharding, steps  # noqa: E402
from repro.simulation.cluster import SimCluster  # noqa: E402

W, SEQ, TAU_MAX, LR, SEED = 4, 64, 2, 0.01, 0
ROUNDS = 4
# the model-axis cases: case -> (arch, config fields), each on a (2, 2)
# mesh for MODEL_ROUNDS rounds
MODEL_CASES = {"model_dp": ("smollm-360m", {}),
               "model_tp": ("internlm2-20b", {}),
               "model_tp_kv1": ("internlm2-20b", {"num_kv_heads": 1}),
               "model_tp_int8": ("internlm2-20b", {}),
               "model_moe": ("olmoe-1b-7b", {}),
               "model_moe_shared": ("kimi-k2-1t-a32b", {}),
               "model_moe_int8": ("olmoe-1b-7b", {}),
               "model_hybrid": ("zamba2-7b", {}),
               "model_xlstm": ("xlstm-1.3b", {}),
               "model_whisper": ("whisper-large-v3", {}),
               "model_vlm": ("qwen2-vl-2b", {})}
MODEL_MESH = (2, 2)
MODEL_ROUNDS = 2
# a model-axis case's lr where it is not LR: its family's (FAMILY_CASES)
MODEL_LRS = {"model_hybrid": 0.002}
# the families past the dense one: case -> (arch, lr), each run on its
# smoke config in f32 for FAMILY_ROUNDS rounds. ``CASE@LR`` runs it at
# another lr, ``CASE:nudge`` from the init moved one ulp (the witness of
# each lr, tests/test_torch_train_families.py): zamba2-7b's smoke config
# parts from itself in its parameters by 1.6e-4 at lr 0.01, by 3.6e-7 at
# 0.002 (tests/_torch_train_gaps.py)
FAMILY_CASES = {"whisper": ("whisper-large-v3", LR),
                "moe": ("olmoe-1b-7b", LR), "hybrid": ("zamba2-7b", 0.002),
                "xlstm": ("xlstm-1.3b", LR), "vlm": ("qwen2-vl-2b", LR)}
FAMILY_ROUNDS = 2
# make_debug_mesh(shape, shrink=True) on 4 devices: (shape, axes)
MESH_CASES = (((2, 2), ("data", "model")), ((8,), ("data",)),
              ((4, 4), ("data", "model")), ((3, 2), ("data", "model")),
              ((2, 3), ("data", "model")), ((6, 2), ("data", "model")),
              ((2, 2, 2), ("pod", "data", "model")),
              ((16, 16), ("data", "model")))
# XLA's CPU compiler at its cheapest (as tests/_torch_serving.py): every
# round's topology compiles a step of its own, and compiling dominates
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _with_step(build):
    def built(*args, **kw):
        fn = build(*args, **kw)
        return lambda x, err, step=jnp.int32(0): fn(x, err, step)
    return built


collectives.gossip_compressed_fn = _with_step(collectives.gossip_compressed_fn)


def _compile_on_first_call(jitted):
    """``jitted`` compiled with ``FAST_COMPILE`` for the arguments of its
    first call."""
    exe = []

    def call(*args):
        if not exe:
            exe.append(jitted.lower(*args).compile(
                compiler_options=FAST_COMPILE))
        return exe[0](*args)

    return call


def _flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v).astype(np.float32)
    return out


def _round_step(cfg, mesh, shape, compiled_cache: dict, params, batch,
                adj, taus, lr, *, compressed: bool):
    """One call of the reference's round step (``make_train_step``,
    compiled once a topology and tau cap into ``compiled_cache``) on host
    arrays: ``batch`` the global batch {name: [W b, ...]} -> (params,
    loss, aux)."""
    w = sharding.num_workers(cfg, mesh)
    tau_cap = int(max(taus.max(), 1))
    key = (tuple(map(tuple, adj)), tau_cap)
    if key not in compiled_cache:
        bundle = steps.make_train_step(
            cfg, mesh, shape, adj=adj, tau_max=tau_cap,
            compressed=compressed,
            measure_distances=not compressed and w > 1)
        compiled_cache[key] = _compile_on_first_call(jax.jit(
            bundle.fn, in_shardings=bundle.in_shardings,
            out_shardings=bundle.out_shardings))
    batch = jax.tree.map(
        lambda x: x.reshape((w, x.shape[0] // w) + x.shape[1:]), batch)
    if tau_cap > 1:
        batch = jax.tree.map(
            lambda x: jnp.broadcast_to(
                x[:, None], (w, tau_cap) + x.shape[1:]), batch)
    params = jax.tree.map(np.asarray, params)
    return compiled_cache[key](params, batch, jnp.asarray(taus, jnp.int32),
                               lr)


def _unflat(flat: dict) -> dict:
    """``_flat``'s inverse: {"a/b": array} -> {"a": {"b": array}}."""
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def step_from(cfg, z: dict, out: dict, *, compressed: bool) -> None:
    """One round step of ``cfg`` on the ``MODEL_MESH`` from a given state:
    ``z`` holds the worker-stacked ``params/<leaf>``, the round's
    ``adj``, ``taus``, ``lr`` and global ``batch/<name>``; ``out`` gets
    the step's ``loss`` and ``params/<leaf>``."""
    shape = InputShape("train_4k", seq_len=SEQ, global_batch=2 * W,
                       kind="train")
    mesh = jax.make_mesh(MODEL_MESH, ("data", "model"))
    params = _unflat({k[len("params/"):]: v for k, v in z.items()
                      if k.startswith("params/")})
    batch = {k[len("batch/"):]: jnp.asarray(v) for k, v in z.items()
             if k.startswith("batch/")}
    params, loss, _ = _round_step(
        cfg, mesh, shape, {}, params, batch, z["adj"], z["taus"],
        jnp.float32(z["lr"]), compressed=compressed)
    out["loss"] = np.float64(float(loss))
    out.update({f"params/{k}": v for k, v in _flat(params).items()})


def train_loop(cfg, rounds: int, out: dict, tag: str, *,
               lr: float = LR, compressed: bool = False, ckpt_dir: str = "",
               ckpt_every: int = 5, resume: bool = False,
               nudge: bool = False, mesh_shape=(W, 1)) -> None:
    """``launch/train.py``'s ``main`` after argument parsing, recording
    into ``out`` under ``tag``, on a ``mesh_shape`` ``("data", "model")``
    mesh. ``nudge``: every weight of the init moved one f32 ulp up
    (``np.nextafter``), the run the reference's gap from itself is
    measured on."""
    shape = InputShape("train_4k", seq_len=SEQ, global_batch=2 * W,
                       kind="train")
    mesh = jax.make_mesh(mesh_shape, ("data", "model"))
    w = sharding.num_workers(cfg, mesh)
    fcfg = FedHPConfig(num_workers=w, rounds=rounds, tau_max=TAU_MAX,
                       tau_init=TAU_MAX, lr=lr, seed=SEED)
    base = make_base_topology(w, "full" if w <= 8 else "erdos:0.3", SEED)
    controller = AdaptiveController(base, tau_max=fcfg.tau_max)
    tracker = ConsensusTracker(w, fcfg.beta1, fcfg.beta2)
    cluster = SimCluster(w, model_bits=32.0 * cfg.param_count(), seed=SEED)

    p1 = _compile_on_first_call(jax.jit(
        lambda key: registry.init_params(cfg, key)))(jax.random.PRNGKey(SEED))
    if nudge:
        p1 = jax.tree.map(lambda l: jnp.asarray(np.nextafter(
            np.asarray(l), np.asarray(np.inf, np.asarray(l).dtype))), p1)
    out.update({f"{tag}/init/{k}": v for k, v in _flat(p1).items()})
    params = jax.tree.map(
        lambda l: jnp.broadcast_to(l[None], (w,) + l.shape), p1)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_round = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        template = jax.tree.map(np.asarray, params)
        state, meta = ckpt.restore(template)
        params = jax.tree.map(jnp.asarray, elastic_reshard(state, w))
        start_round = int(meta["step"]) + 1
    out[f"{tag}/start_round"] = np.int64(start_round)
    out[f"{tag}/base_lr"] = np.float64(lr)

    adj = base
    taus = np.full(w, fcfg.tau_init, np.int64)
    mu, beta = cluster.sample_mu(), cluster.sample_beta()
    compiled_cache: dict = {}
    data_rng = jax.random.PRNGKey(SEED + 1)
    for h in range(start_round, rounds):
        r = f"{tag}/round{h}"
        out[f"{r}/adj"], out[f"{r}/taus"] = adj.copy(), taus.copy()
        lr = jnp.float32(fcfg.lr * (fcfg.lr_decay ** h))
        data_rng, k = jax.random.split(data_rng)
        batch = registry.make_batch(cfg, shape, k)
        out.update({f"{r}/batch/{n}": np.asarray(v)
                    for n, v in batch.items()})
        params, loss, aux = _round_step(
            cfg, mesh, shape, compiled_cache, params, batch, adj, taus, lr,
            compressed=compressed)
        loss = float(loss)
        out[f"{r}/lr"], out[f"{r}/loss"] = np.float32(lr), np.float64(loss)
        out.update({f"{r}/params/{k}": v for k, v in _flat(params).items()})

        mu, beta = cluster.sample_mu(), cluster.sample_beta()
        if "neighbor_dists" in aux:
            d = np.asarray(aux["neighbor_dists"])
            out[f"{r}/dists"] = d
            pair = np.zeros((w, w))
            for m, match in enumerate(topo.matching_decomposition(adj)):
                for (i, j) in match:
                    pair[i, j] = pair[j, i] = d[m]
            tracker.update(adj, pair, mean_update_norm=float(d.mean()))
        decision = controller.decide(
            mu, beta, tracker, f1=loss, smooth_l=1.0, sigma=1.0,
            eta=float(lr), rounds=rounds)
        adj, taus = decision.adj, decision.taus
        if ckpt and (h + 1) % ckpt_every == 0:
            ckpt.save(h, jax.tree.map(np.asarray, params),
                      meta={"arch": cfg.name, "loss": loss})
    if ckpt:
        ckpt.save(rounds - 1, jax.tree.map(np.asarray, params),
                  meta={"arch": cfg.name, "loss": loss})
    out[f"{tag}/final_adj"], out[f"{tag}/final_taus"] = adj, taus


def collectives_cases(out: dict) -> None:
    """The matching collectives on a random two-leaf tree, every output
    next to its inputs."""
    mesh = jax.make_mesh((W, 1), ("data", "model"))
    axes = ("data",)
    rng = np.random.default_rng(3)
    x = {"a": rng.normal(size=(W, 6, 32)).astype(np.float32),
         "b": (rng.normal(size=(W, 40)) * 3).astype(np.float32)}
    out.update({f"x/{k}": v for k, v in x.items()})
    spec = {"a": jax.sharding.PartitionSpec("data", None, None),
            "b": jax.sharding.PartitionSpec("data", None)}
    for name in ("full", "ring"):
        adj = make_base_topology(W, name, 0)
        mix = topo.mixing_matrix_uniform(adj)
        pairs = collectives.matchings_as_pairs(adj)
        wt = collectives.matching_weight_tables(adj, mix)
        out[f"{name}/adj"], out[f"{name}/mix"] = adj, mix
        out[f"{name}/pairs"] = np.asarray(pairs, np.int64)
        out[f"{name}/wt"] = wt
        g = collectives.gossip_fn(mesh, axes, pairs, wt, spec)
        gd = collectives.gossip_fn(mesh, axes, pairs, wt, spec,
                                   measure_distances=True)
        with mesh:
            y = jax.jit(g)(x)
            y2, d = jax.jit(gd)(x)
        out.update({f"{name}/gossip/{k}": np.asarray(v)
                    for k, v in y.items()})
        out.update({f"{name}/gossip_d/{k}": np.asarray(v)
                    for k, v in y2.items()})
        out[f"{name}/dists"] = np.asarray(d)
        xb = jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), x)
        with mesh:
            yb = jax.jit(g)(xb)
        out.update({f"{name}/gossip_bf16/{k}": np.asarray(v, np.float32)
                    for k, v in yb.items()})
        err0 = jax.tree.map(np.zeros_like, x)
        for mode, kw, err, stp in (
                ("int8", {}, err0, 0),
                ("topk", dict(mode="topk:0.25", gamma=0.5), x, 0),
                ("randk0", dict(mode="randk:0.25", seed=7), err0, 0),
                ("randk1", dict(mode="randk:0.25", seed=7), err0, 1)):
            gc = collectives.gossip_compressed_fn(mesh, axes, pairs, wt,
                                                  spec, **kw)
            with mesh:
                yc, ec = jax.jit(gc)(x, err, jnp.int32(stp))
            out.update({f"{name}/{mode}/y/{k}": np.asarray(v)
                        for k, v in yc.items()})
            out.update({f"{name}/{mode}/err/{k}": np.asarray(v)
                        for k, v in ec.items()})
            if mode in ("int8", "randk0"):
                # bf16 leaves: each matching's term and sum round to bf16
                with mesh:
                    yc, _ = jax.jit(gc)(xb, err, jnp.int32(stp))
                out.update({f"{name}/{mode}_bf16/y/{k}":
                            np.asarray(v, np.float32)
                            for k, v in yc.items()})
        # a top-k round from a public copy that lags x
        lag = jax.tree.map(lambda v: v * np.float32(0.5), x)
        gc = collectives.gossip_compressed_fn(mesh, axes, pairs, wt, spec,
                                              mode="topk:0.25", gamma=0.5)
        with mesh:
            yc, ec = jax.jit(gc)(x, lag, jnp.int32(0))
        out.update({f"{name}/topk_lag/y/{k}": np.asarray(v)
                    for k, v in yc.items()})
        out.update({f"{name}/topk_lag/err/{k}": np.asarray(v)
                    for k, v in ec.items()})
    ar = collectives.ring_allreduce_mean_fn(mesh, axes, spec)
    with mesh:
        y = jax.jit(ar)(x)
    out.update({f"allreduce/{k}": np.asarray(v) for k, v in y.items()})
    out["mesh/cases"] = np.int64(len(MESH_CASES))
    for i, (shape, mesh_axes) in enumerate(MESH_CASES):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = make_debug_mesh(shape, mesh_axes, shrink=True)
        out[f"mesh/{i}/in_shape"] = np.asarray(shape)
        out[f"mesh/{i}/axes"] = np.asarray(mesh_axes)
        out[f"mesh/{i}/shape"] = np.asarray(tuple(m.shape.values()))
        out[f"mesh/{i}/warning"] = np.asarray(
            [str(c.message) for c in caught] or [""])


def main(argv) -> int:
    out_dir, cases = argv[0], argv[1:]
    smoke = get_smoke_config("smollm-360m")
    for case in cases:
        out: dict = {}
        if case == "f32":
            ckpt = os.path.join(out_dir, "ckpt")
            shutil.rmtree(ckpt, ignore_errors=True)
            train_loop(smoke, ROUNDS, out, "run", ckpt_dir=ckpt,
                       ckpt_every=2)
            resumed = os.path.join(out_dir, "ckpt_resume")
            shutil.rmtree(resumed, ignore_errors=True)
            shutil.copytree(ckpt, resumed)
            train_loop(smoke, ROUNDS + 2, out, "resume", ckpt_dir=resumed,
                       ckpt_every=2, resume=True)
        elif case == "bf16":
            train_loop(dataclasses.replace(smoke, dtype="bfloat16"), ROUNDS,
                       out, "run")
        elif case == "int8":
            train_loop(smoke, ROUNDS - 1, out, "run", compressed=True)
        elif case == "bf16_int8":
            train_loop(dataclasses.replace(smoke, dtype="bfloat16"),
                       ROUNDS - 1, out, "run", compressed=True)
        elif case.partition(":")[0].partition("@")[0] in FAMILY_CASES:
            head, _, variant = case.partition(":")
            family, _, lr = head.partition("@")
            arch, base_lr = FAMILY_CASES[family]
            train_loop(get_smoke_config(arch), FAMILY_ROUNDS, out, "run",
                       lr=float(lr) if lr else base_lr,
                       nudge=variant == "nudge")
        elif case.partition(":")[0] in MODEL_CASES:
            head, _, variant = case.partition(":")
            arch, fields = MODEL_CASES[head]
            cfg = dataclasses.replace(get_smoke_config(arch), **fields)
            if variant.startswith("from"):
                with np.load(os.path.join(out_dir, f"{case}.in.npz")) as z:
                    step_from(cfg, dict(z), out,
                              compressed=head.endswith("int8"))
            else:
                train_loop(cfg, MODEL_ROUNDS, out, "run",
                           mesh_shape=MODEL_MESH, lr=MODEL_LRS.get(head, LR),
                           compressed=head.endswith("int8"),
                           nudge=variant == "nudge")
        elif case == "collectives":
            collectives_cases(out)
        else:
            raise SystemExit(f"unknown case {case!r}")
        np.savez(os.path.join(out_dir, f"{case}.npz"), **out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
