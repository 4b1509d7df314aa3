"""ModelAdapter: the bridge between the DFL engines and the model (the
port of ``repro.core.modelspec``: the synthetic MLP and the registry
LMs).

The engines keep the fleet's parameters as ONE flat ``[W, P]`` f32
matrix — the layout gossip runs on — and see the model only through an
adapter:

  - ``init(generator)``: one worker's parameter dict;
  - ``leaf_offsets()``: the (name, start, size, shape) table of the flat
    layout. Leaves are in the reference's ``jax.tree`` order — sorted
    dict keys level by level; a registry model's names are the nested
    paths joined by ``"/"``, whose sorted order is that order
    (``tests/test_torch_registry.py`` checks it) — so a row of the
    port's ``[W, P]`` matrix is bit-for-bit a row of the reference's;
  - ``views(flat)``: the leaf tensors ``[W, *shape]`` as views into the
    flat matrix (no copy; autograd through them lands in the flat
    gradient);
  - ``loss`` / ``accuracy``: per-worker values ``[W]`` on per-worker
    batches ``x`` ``[W, *batch, D]`` (features) or ``[W, *batch, S]``
    (tokens);
  - ``workers_per_pass(x)``: how many workers one autograd pass on ``x``
    may hold (the engines compute larger fleets' gradients in groups);
  - ``flatten`` / ``unflatten``: worker-stacked dict <-> ``[W, P]``;
  - ``param_count`` / ``model_bits``: the payload Eq. 10 charges.

Spec syntax (``FedHPConfig.model``): ``"mlp"`` / ``"mlp:<hidden>"``, or
``"<family>:key=val,..."`` for a registry model (``models/registry.py``;
token families dense / moe / hybrid / xlstm, of which dense is ported).
Keys: ``d`` (d_model), ``layers``, ``heads``, ``kv`` (kv heads), ``ff``
(d_ff), ``vocab``, ``seq`` (corpus sequence length), ``classes``
(document classes of the synthetic corpus), and the moe / hybrid /
xlstm keys. A spec's registry model runs the plain attention
(``use_flash_kernel`` off, as in the reference); an adapter built
straight from a ``ModelConfig`` with ``use_flash_kernel=True`` runs the
flash-attention kernel in every forward pass.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from math import prod

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic
from repro_torch.models import layers as _layers
from repro_torch.models import registry as _registry
from repro_torch.simulation import model as _mlp

FP32_BITS = 32

# token-stream families the DFL batch pipeline can feed ({"tokens",
# "labels"} built from an [N, S] int corpus); encdec needs audio frames
# and vlm patch embeddings — neither fits the engines' batch contract
DFL_FAMILIES = ("dense", "moe", "hybrid", "xlstm")

_SPEC_KEYS = {
    "d": "d_model", "d_model": "d_model",
    "layers": "num_layers", "l": "num_layers",
    "heads": "num_heads", "kv": "num_kv_heads",
    "ff": "d_ff", "d_ff": "d_ff",
    "vocab": "vocab_size",
    "experts": "num_experts",
    "experts_per_token": "experts_per_token",
    "slstm_every": "slstm_every",
    "ssm_every": "ssm_every",
    "ssm_state": "ssm_state",
}

# the activation memory one autograd pass of a registry model may hold
# (workers_per_pass): about 40% of an 80 GB card, leaving room for the
# engines' [W, P] matrices (parameters, previous round, three gradients)
ACTIVATION_BUDGET_BYTES = 32 * 2 ** 30


@dataclass(frozen=True)
class LeafInfo:
    """One leaf of the flat layout: ``flat[:, start:start+size]`` holds
    ``name``'s row-major values."""

    name: str
    start: int
    size: int
    shape: tuple[int, ...]

    @property
    def stop(self) -> int:
        """End offset (exclusive) of this leaf in the flat vector."""
        return self.start + self.size


class ModelAdapter:
    """Uniform model interface for the DFL engines (see module doc).
    Subclasses define ``leaf_shapes`` and the model math."""

    def __init__(self, spec: str):
        self.spec = spec

    def __repr__(self):
        return f"{type(self).__name__}({self.spec!r})"

    # --- model math (overridden per adapter family) ---
    def leaf_shapes(self) -> dict[str, tuple[int, ...]]:
        """Per-worker shape of every parameter leaf."""
        raise NotImplementedError

    def init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """One worker's parameter dict (on the CPU)."""
        raise NotImplementedError

    def loss(self, params, x, y) -> torch.Tensor:
        """Per-worker training loss [W]."""
        raise NotImplementedError

    def accuracy(self, params, x, y) -> torch.Tensor:
        """Per-worker [0, 1] quality metric [W]."""
        raise NotImplementedError

    def make_data(self, num_samples: int, *, seed: int = 0,
                  spread: float = 1.0) -> synthetic.Dataset:
        """The synthetic dataset family this model trains on."""
        raise NotImplementedError

    def workers_per_pass(self, x: torch.Tensor) -> int:
        """Workers one autograd pass on the batch ``x`` [W, ...] holds:
        all of them unless the model says otherwise."""
        return x.shape[0]

    # --- static layout (shared implementation) ---
    def leaf_offsets(self) -> tuple[LeafInfo, ...]:
        """The flat layout's leaf-offset table, in sorted-name order."""
        infos, off = [], 0
        for name, shape in sorted(self.leaf_shapes().items()):
            size = prod(shape)
            infos.append(LeafInfo(name, off, size, tuple(shape)))
            off += size
        return tuple(infos)

    @property
    def param_count(self) -> int:
        """P: exact number of scalar parameters (flat vector length)."""
        return sum(prod(s) for s in self.leaf_shapes().values())

    @property
    def model_bits(self) -> float:
        """Uncompressed wire payload of one model transfer (Eq. 10)."""
        return float(FP32_BITS * self.param_count)

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """[W, P] -> {name: [W, *shape]} views sharing ``flat``'s storage."""
        w = flat.shape[0]
        return {l.name: flat[:, l.start:l.stop].view(w, *l.shape)
                for l in self.leaf_offsets()}

    def flatten(self, stacked: dict[str, torch.Tensor]) -> torch.Tensor:
        """Worker-stacked dict {name: [W, *shape]} -> [W, P] f32."""
        leaves = self.leaf_offsets()
        if sorted(stacked) != [l.name for l in leaves]:
            raise ValueError(f"parameters {sorted(stacked)} do not match "
                             f"{self!r}'s leaves {[l.name for l in leaves]}")
        for l in leaves:
            if tuple(stacked[l.name].shape[1:]) != l.shape:
                raise ValueError(f"leaf {l.name}: expected [W, *{l.shape}], "
                                 f"got {tuple(stacked[l.name].shape)}")
        return torch.cat([stacked[l.name].reshape(-1, l.size)
                          .to(torch.float32) for l in leaves], dim=1)

    def unflatten(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Inverse of ``flatten``: contiguous copies of the leaf views."""
        return {k: v.contiguous() for k, v in self.views(flat).items()}


class MlpAdapter(ModelAdapter):
    """The synthetic 3-layer classifier (``simulation/model.py``)."""

    def __init__(self, dim: int, hidden: int, num_classes: int):
        super().__init__(f"mlp:dim={dim},hidden={hidden},"
                         f"classes={num_classes}")
        self.dim = dim
        self.hidden = hidden
        self.num_classes = num_classes

    def leaf_shapes(self) -> dict[str, tuple[int, ...]]:
        """w1/b1/w2/b2/w3/b3 of the D -> H -> H -> C classifier."""
        d, h, c = self.dim, self.hidden, self.num_classes
        return {"w1": (d, h), "b1": (h,), "w2": (h, h), "b2": (h,),
                "w3": (h, c), "b3": (c,)}

    def init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """One worker's classifier drawn from ``generator``."""
        return _mlp.init_classifier(generator, self.dim, self.hidden,
                                    self.num_classes)

    def loss(self, params, x, y) -> torch.Tensor:
        """Softmax cross-entropy of the classifier, per worker."""
        return _mlp.classifier_loss(params, x, y)

    def accuracy(self, params, x, y) -> torch.Tensor:
        """Top-1 classification accuracy, per worker."""
        return _mlp.accuracy(params, x, y)

    def make_data(self, num_samples: int, *, seed: int = 0,
                  spread: float = 1.0) -> synthetic.Dataset:
        """Gaussian-mixture blobs (``make_classification_data``)."""
        return synthetic.make_classification_data(
            num_samples=num_samples, dim=self.dim,
            num_classes=self.num_classes, spread=spread, seed=seed)


class RegistryAdapter(ModelAdapter):
    """A ``models/registry.py`` family behind the adapter interface.

    The engines' batch ``x`` is an int token block ``[W, *batch, S]``
    from the class-structured Markov corpus (``make_token_data``); the LM
    loss trains next-token prediction on ``x`` itself (``y`` — the
    document class — only drives the non-IID partition). ``accuracy`` is
    the bounded inverse per-token perplexity ``exp(-loss)``, so
    completion-time targets stay in [0, 1] across model families."""

    def __init__(self, cfg: ModelConfig, seq_len: int, num_classes: int,
                 spec: str):
        super().__init__(spec)
        _registry.get_model(cfg.family)        # raises for unported ones
        _layers.check_trainable(cfg)
        self.cfg = cfg
        self.seq_len = seq_len
        self.num_classes = num_classes

    def leaf_shapes(self) -> dict[str, tuple[int, ...]]:
        """The registry family's leaves by ``"/"``-joined path."""
        return _registry.leaf_shapes(self.cfg)

    def init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """One worker's parameters drawn from ``generator``."""
        return _registry.init_params(self.cfg, generator)

    def loss(self, params, x, y) -> torch.Tensor:
        """Next-token LM loss per worker: ``x[..., :-1]`` predicts
        ``x[..., 1:]``. Each worker's batch dims collapse to one
        ([W, ..., S] -> [W, B', S]): the engines' Alg. 1 measurements
        evaluate each worker on the full [W, 256, S] eval stack, and the
        mean token loss is invariant to the reshape."""
        tokens = x.reshape(x.shape[0], -1, x.shape[-1]).long()
        loss, _ = _registry.loss_fn(self.cfg, params,
                                    {"tokens": tokens[:, :, :-1],
                                     "labels": tokens[:, :, 1:]})
        return loss

    def accuracy(self, params, x, y) -> torch.Tensor:
        """Inverse per-token perplexity exp(-loss) in [0, 1]."""
        return torch.exp(-self.loss(params, x, y))

    def make_data(self, num_samples: int, *, seed: int = 0,
                  spread: float = 1.0) -> synthetic.Dataset:
        """Class-structured Markov-chain LM corpus (p-skew friendly)."""
        return synthetic.make_token_data(
            num_sequences=num_samples, seq_len=self.seq_len,
            vocab_size=self.cfg.vocab_size, num_classes=self.num_classes,
            seed=seed)

    def activation_bytes_per_token(self) -> int:
        """What one token's forward keeps for the backward pass, about:
        per layer the norms' inputs and outputs, q, k and v before and
        after RoPE, the attention output and the MLP's four [d_ff]
        intermediates; then the logits and their log-softmax (f32)."""
        c = self.cfg
        hd = c.resolved_head_dim
        qd, kvd = c.num_heads * hd, c.num_kv_heads * hd
        per_layer = 8 * c.d_model + 3 * qd + 3 * kvd + 4 * c.d_ff
        return 4 * (c.num_layers * per_layer + 2 * c.vocab_size)

    def workers_per_pass(self, x: torch.Tensor) -> int:
        """As many workers as keep one pass's activations within
        ``ACTIVATION_BUDGET_BYTES`` (at least one)."""
        tokens = x[0].numel() * (x.shape[-1] - 1) // x.shape[-1]
        need = max(tokens, 1) * self.activation_bytes_per_token()
        return max(1, min(x.shape[0], ACTIVATION_BUDGET_BYTES // need))


def _parse_kv(body: str) -> dict[str, int]:
    out = {}
    if not body:
        return out
    for item in body.split(","):
        key, sep, val = item.partition("=")
        if not sep:
            raise ValueError(f"model spec item {item!r} is not key=val")
        out[key.strip()] = int(val)
    return out


@lru_cache(maxsize=64)
def get_adapter(spec: str, *, dim: int = 32, hidden: int = 64,
                num_classes: int = 10) -> ModelAdapter:
    """Parse a ``cfg.model`` spec into a (cached) adapter.

    ``dim``/``hidden``/``num_classes`` apply to the MLP family only (its
    shapes come from the classification dataset); registry specs carry
    their own dims. Raises ValueError for non-token registry families
    (encdec / vlm), NotImplementedError for the token families not
    ported yet (moe / hybrid / xlstm)."""
    family, _, body = str(spec).partition(":")
    family = family.strip() or "mlp"
    if family == "mlp":
        if body:
            hidden = int(body)
        return MlpAdapter(dim, hidden, num_classes)
    if family not in DFL_FAMILIES:
        raise ValueError(
            f"model family {family!r} cannot train under DFL: supported "
            f"families are ('mlp',) + {DFL_FAMILIES} (encdec/vlm need "
            "modality inputs the engines' batch pipeline does not carry)")
    kv = _parse_kv(body)
    seq_len = kv.pop("seq", 16)
    n_classes = kv.pop("classes", 8)
    fields = {_SPEC_KEYS[k]: v for k, v in kv.items() if k in _SPEC_KEYS}
    unknown = [k for k in kv if k not in _SPEC_KEYS]
    if unknown:
        raise ValueError(f"unknown model spec keys {unknown}; "
                         f"known: {sorted(set(_SPEC_KEYS))} + seq, classes")
    base = dict(name=f"dfl-{family}", family=family, num_layers=2,
                d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                vocab_size=64, dtype="float32", remat="none")
    if family == "moe":
        base.update(num_experts=4, experts_per_token=2)
    if family == "hybrid":
        base.update(ssm_state=16, ssm_every=2)
    if family == "xlstm":
        base.update(slstm_every=2)
    base.update(fields)
    cfg = ModelConfig(**base)
    # canonical spec: sorted resolved fields, so equivalent key spellings
    # ("d=32" vs "d_model=32") name the same adapter
    canon = (f"{family}:" + ",".join(
        f"{k}={v}" for k, v in sorted(
            dataclasses.asdict(cfg).items())
        if not isinstance(v, (tuple, str)) and v)
        + f",seq={seq_len},classes={n_classes}")
    return RegistryAdapter(cfg, seq_len, n_classes, canon)


def adapter_for(cfg, data=None, hidden: int = 64) -> ModelAdapter:
    """The adapter a run's ``FedHPConfig`` names, with MLP shape dims
    taken from ``data`` (the engines' call pattern)."""
    spec = getattr(cfg, "model", "mlp")
    if data is not None and str(spec).partition(":")[0] in ("mlp", ""):
        return get_adapter(spec, dim=int(data.x.shape[-1]), hidden=hidden,
                           num_classes=int(data.num_classes))
    return get_adapter(spec, hidden=hidden)
