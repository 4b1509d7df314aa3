"""ModelAdapter: the bridge between the DFL engines and the model (the
port of ``repro.core.modelspec`` for the synthetic MLP).

The engines keep the fleet's parameters as ONE flat ``[W, P]`` f32
matrix — the layout gossip runs on — and see the model only through an
adapter:

  - ``init(generator)``: one worker's parameter dict;
  - ``leaf_offsets()``: the (name, start, size, shape) table of the flat
    layout. Leaves are in the reference's ``jax.tree`` order — sorted
    dict keys, ``b1, b2, b3, w1, w2, w3`` — so a row of the port's
    ``[W, P]`` matrix is bit-for-bit a row of the reference's;
  - ``views(flat)``: the leaf tensors ``[W, *shape]`` as views into the
    flat matrix (no copy; autograd through them lands in the flat
    gradient);
  - ``loss`` / ``accuracy``: per-worker values ``[W]`` on per-worker
    batches ``x`` ``[W, *batch, D]``;
  - ``flatten`` / ``unflatten``: worker-stacked dict <-> ``[W, P]``;
  - ``param_count`` / ``model_bits``: the payload Eq. 10 charges.

Spec syntax (``FedHPConfig.model``): ``"mlp"`` or ``"mlp:<hidden>"``.
Registry LM families arrive with the registry slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from math import prod

import torch

from repro_torch.data import synthetic
from repro_torch.simulation import model as _mlp

FP32_BITS = 32


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


@lru_cache(maxsize=64)
def get_adapter(spec: str, *, dim: int = 32, hidden: int = 64,
                num_classes: int = 10) -> ModelAdapter:
    """Parse a ``cfg.model`` spec into a (cached) adapter. Only the MLP
    family is ported; registry specs raise ``NotImplementedError``."""
    family, _, body = str(spec).partition(":")
    family = family.strip() or "mlp"
    if family != "mlp":
        raise NotImplementedError(
            f"model family {family!r} is not ported yet: registry models "
            "arrive with ROADMAP.md queue 1, item 8")
    if body:
        hidden = int(body)
    return MlpAdapter(dim, hidden, num_classes)


def adapter_for(cfg, data=None, hidden: int = 64) -> ModelAdapter:
    """The adapter a run's ``FedHPConfig`` names, with MLP shape dims
    taken from ``data`` (the engines' call pattern)."""
    spec = getattr(cfg, "model", "mlp")
    if data is not None:
        return get_adapter(spec, dim=int(data.x.shape[-1]), hidden=hidden,
                           num_classes=int(data.num_classes))
    return get_adapter(spec, hidden=hidden)
