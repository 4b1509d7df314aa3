"""Parameter exchange with the reference JAX package, through numpy.

``params_from_jax`` turns a reference parameter pytree — a dict of leaf
arrays, as ``jax.device_get`` or ``np.asarray`` gives them, for one
worker or worker-stacked ``[W, ...]`` — into the port's dict of f32
tensors; ``params_to_numpy`` is its inverse. The leaf names and shapes
are the same in both packages, so the tests hand the reference's
``adapter.init(jax.random.PRNGKey(seed))`` to the port's engines
(``init_params=``) and compare trajectories from identical weights.
Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """{name: array-like} -> {name: f32 CPU tensor} (a copy)."""
    return {str(k): torch.tensor(np.asarray(v, np.float32))
            for k, v in tree.items()}


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """{name: tensor} -> {name: f32 numpy array on the host}."""
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in params.items()}
