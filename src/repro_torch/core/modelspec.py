"""ModelAdapter: the bridge between the DFL engines and the model (the
port of ``repro.core.modelspec``: the synthetic MLP and the registry
LMs).

The engines keep the fleet's parameters as ONE flat ``[W, P]`` f32
matrix — the layout gossip runs on — and see the model only through an
adapter:

  - ``init(generator)``: one worker's parameter dict;
  - ``leaf_offsets()``: the (name, start, size, shape, dtype) table of
    the flat layout. Leaves are in the reference's ``jax.tree`` order —
    sorted dict keys level by level; a registry model's names are the
    nested paths joined by ``"/"``, whose sorted order is that order
    (``tests/test_torch_registry.py`` checks it) — so a row of the
    port's ``[W, P]`` matrix is bit-for-bit a row of the reference's;
  - ``views(flat)``: the leaf tensors ``[W, *shape]`` as f32 views into
    the flat matrix (no copy; autograd through them lands in the flat
    gradient). The model reads each leaf in its storage dtype
    (``LeafInfo.dtype``: a config's ``dtype``, bf16 for the published
    registry configs): ``loss`` casts the views, a copy for a bf16 leaf;
  - ``round_leaves(flat)``: the flat matrix with every non-f32 leaf's
    columns rounded to its dtype (``round_leaves_``: in place). The
    engines apply it after every write — each SGD step, gossip, join
    blend and AD-PSGD exchange — where the reference casts its f32
    results back to the leaf dtype, so the flat always holds values of
    the leaves' dtypes, as the reference's does;
  - ``loss`` / ``accuracy``: per-worker values ``[W]`` on per-worker
    batches ``x`` ``[W, *batch, D]`` (features) or ``[W, *batch, S]``
    (tokens);
  - ``workers_per_pass(x)``: how many workers one autograd pass on ``x``
    may hold (the engines compute larger fleets' gradients in groups);
  - ``flatten`` / ``unflatten``: worker-stacked dict <-> ``[W, P]``
    (f32 in, each leaf's storage dtype out);
  - ``param_count`` / ``model_bits``: the payload Eq. 10 charges.

Spec syntax (``FedHPConfig.model``): ``"mlp"`` / ``"mlp:<hidden>"``, or
``"<family>:key=val,..."`` for a registry model (``models/registry.py``;
token families dense / moe / hybrid / xlstm).
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
from repro_torch.runtime import sharding as _sharding
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
    ``name``'s row-major values (f32 on the wire; ``dtype`` is the
    leaf's storage dtype, by name as the reference's ``str(leaf.dtype)``,
    which ``unflatten`` casts back to)."""

    name: str
    start: int
    size: int
    shape: tuple[int, ...]
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        """``dtype`` as a torch dtype."""
        return _layers.dtype_of(self.dtype)

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

    def leaf_dtypes(self) -> dict[str, torch.dtype]:
        """Storage dtype of every parameter leaf: f32 unless the model
        says otherwise."""
        return {name: torch.float32 for name in self.leaf_shapes()}

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
        """The flat layout's leaf-offset table, in sorted-name order
        (computed once)."""
        if not hasattr(self, "_leaves"):
            infos, off = [], 0
            dtypes = self.leaf_dtypes()
            for name, shape in sorted(self.leaf_shapes().items()):
                size = prod(shape)
                infos.append(LeafInfo(name, off, size, tuple(shape),
                                      str(dtypes[name])
                                      .removeprefix("torch.")))
                off += size
            self._leaves = tuple(infos)
        return self._leaves

    def narrow_spans(self) -> tuple[tuple[int, int, torch.dtype], ...]:
        """The column spans (start, stop, dtype) of the leaves stored in
        another dtype than f32, adjacent leaves of one dtype merged: the
        columns ``round_leaves`` rounds (none for an all-f32 model)."""
        spans: list[list] = []
        for l in self.leaf_offsets():
            if l.dtype == "float32":
                continue
            if spans and spans[-1][1] == l.start and \
                    spans[-1][2] == l.torch_dtype:
                spans[-1][1] = l.stop
            else:
                spans.append([l.start, l.stop, l.torch_dtype])
        return tuple(tuple(s) for s in spans)

    def round_leaves(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` [..., P] with each non-f32 leaf's columns rounded to
        its storage dtype (round to nearest even) and back to f32: the
        reference's cast of an f32 result back to the leaf dtype. Returns
        ``flat`` itself for an all-f32 model, else a new tensor."""
        spans = self.narrow_spans()
        if not spans:
            return flat
        if len(spans) == 1 and spans[0][:2] == (0, flat.shape[-1]):
            return flat.to(spans[0][2]).to(torch.float32)
        return self.round_leaves_(flat.clone())

    def round_leaves_(self, flat: torch.Tensor) -> torch.Tensor:
        """``round_leaves`` in place, without the copy (a full-width fleet
        has no room for a second [W, P] matrix); returns ``flat``."""
        for start, stop, dt in self.narrow_spans():
            cols = flat[..., start:stop]
            cols.copy_(cols.to(dt))
        return flat

    def cast_params(self, params: dict) -> dict:
        """{name: tensor} -> each leaf in its storage dtype (f32 views
        pass through as they are)."""
        dtypes = {l.name: l.torch_dtype for l in self.leaf_offsets()}
        return {k: v.to(dtypes[k]) for k, v in params.items()}

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
        """Worker-stacked dict {name: [W, *shape]} -> [W, P] f32 (exact
        for leaves of a narrower dtype)."""
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
        """Inverse of ``flatten``: contiguous copies of the leaf views,
        each cast to its storage dtype (the reference's
        ``unflatten_one``)."""
        return {k: v.contiguous() for k, v in
                self.cast_params(self.views(flat)).items()}


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

    def leaf_dtypes(self) -> dict[str, torch.dtype]:
        """The config's ``dtype``, but for the leaves the family keeps in
        f32 (``registry.leaf_dtypes``)."""
        return _registry.leaf_dtypes(self.cfg)

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
        loss, _ = _registry.loss_fn(self.cfg, self.cast_params(params),
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
        the family's own count at the corpus's sequence length
        (``activation_floats`` of its model module: a dense layer's norms,
        projections and MLP; MoE's expert slots; the SSD and mLSTM
        recurrences' intra-chunk terms and chunk states; sLSTM's
        per-token state), then the logits and their log-softmax (f32)."""
        model = _registry.get_model(self.cfg.family)
        return 4 * (model.activation_floats(self.cfg, self.seq_len - 1)
                    + 2 * self.cfg.vocab_size)

    def workers_per_pass(self, x: torch.Tensor) -> int:
        """As many workers as keep one pass's activations within
        ``ACTIVATION_BUDGET_BYTES`` (at least one)."""
        tokens = x[0].numel() * (x.shape[-1] - 1) // x.shape[-1]
        need = max(tokens, 1) * self.activation_bytes_per_token()
        return max(1, min(x.shape[0], ACTIVATION_BUDGET_BYTES // need))


class SlotAdapter(RegistryAdapter):
    """A registry model's flat layout on each of the ``model`` slots of a
    worker's model axis (launch/train's round step): slot j's fleet
    matrix ``[W, P_slot]`` holds, worker by worker, slot j's piece of
    every leaf in the reference's leaf order. ``splits`` {name: dim or
    None} says which dim of one worker's leaf the model axis splits into
    ``model`` equal contiguous pieces (``runtime/sharding.leaf_splits``),
    None for a leaf every slot holds whole. The pieces of slot j have the
    same shapes on every slot, so one table (``leaf_offsets``,
    ``narrow_spans``, ``views``, ``round_leaves_``) serves each slot's
    matrix; with ``model`` 1 it is exactly ``RegistryAdapter``'s layout.
    ``cut`` / ``flatten_slots`` / ``join`` go between whole
    worker-stacked leaves and the slots' pieces."""

    def __init__(self, cfg: ModelConfig, seq_len: int, spec: str,
                 splits: dict | None = None, model: int = 1):
        super().__init__(cfg, seq_len, 0, spec)
        self.model = model
        self.splits = dict(splits or {})

    def whole_shapes(self) -> dict[str, tuple[int, ...]]:
        """One worker's whole leaf shapes."""
        return _registry.leaf_shapes(self.cfg)

    def leaf_shapes(self) -> dict[str, tuple[int, ...]]:
        """A slot's piece of each leaf."""
        return {k: _sharding.piece_shape(s, self.splits.get(k), self.model)
                for k, s in self.whole_shapes().items()}

    def whole_spans(self) -> tuple[tuple[int, int], ...]:
        """The column spans (start, stop) of the leaves every slot holds
        whole, adjacent ones merged (all of them with ``model`` 1)."""
        spans: list[list[int]] = []
        for l in self.leaf_offsets():
            if self.splits.get(l.name) is not None:
                continue
            if spans and spans[-1][1] == l.start:
                spans[-1][1] = l.stop
            else:
                spans.append([l.start, l.stop])
        return tuple(tuple(s) for s in spans)

    def cut(self, stacked: dict[str, torch.Tensor]) -> list[dict]:
        """Worker-stacked whole leaves {name: [W, *shape]} -> each slot's
        pieces {name: [W, *piece]} (views)."""
        out: list[dict] = [{} for _ in range(self.model)]
        for k, v in stacked.items():
            for j, piece in enumerate(_sharding.cut_leaf(
                    v, self.splits.get(k), self.model, lead=1)):
                out[j][k] = piece
        return out

    def flatten_slots(self, stacked: dict[str, torch.Tensor]
                      ) -> list[torch.Tensor]:
        """Worker-stacked whole leaves -> the slots' [W, P_slot] f32
        matrices (``flatten`` of each slot's pieces)."""
        return [self.flatten(p) for p in self.cut(stacked)]

    def join(self, slots) -> dict[str, torch.Tensor]:
        """The slots' matrices (one [W, P] matrix for ``model`` 1) ->
        whole worker-stacked leaves in their storage dtypes, on slot 0's
        device (the reference's on-disk format; a whole leaf from slot 0's
        copy)."""
        if isinstance(slots, torch.Tensor):
            return self.unflatten(slots)
        home = slots[0].device
        parts = [self.unflatten(s) for s in slots]
        return {k: _sharding.join_leaf([p[k].to(home) for p in parts],
                                       self.splits.get(k), lead=1)
                for k in parts[0]}


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
    their own dims, over the reference's defaults for the family (moe: 4
    experts, 2 a token; hybrid: ssm_state 16, a shared block every 2
    Mamba2 blocks; xlstm: an sLSTM block after every 2 mLSTM blocks).
    Raises ValueError for non-token registry families (encdec / vlm)."""
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
