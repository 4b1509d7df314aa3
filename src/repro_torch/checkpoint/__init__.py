"""DFL-aware checkpointing (the port of ``repro.checkpoint``): npz
entries per leaf, atomic writes, elastic restore."""
from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager,
    elastic_reshard,
    list_steps,
    load_checkpoint,
    save_checkpoint,
)
