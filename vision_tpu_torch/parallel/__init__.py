"""Meshes over torch.distributed — a port of vision_tpu/parallel/: one rank
a card, dp over the batch, tp over the weights (Megatron form), pp as a
GPipe loop. ``dryrun_multichip`` is the port of the JAX package's
multi-chip dry run (parallel/dryrun.py, imported at its call)."""

from .pipeline import pipeline_apply, stage_sharding
from .sharding import (
    DEFAULT_TP_RULES,
    SAM3_TP_RULES,
    batch_sharding,
    init_distributed,
    make_mesh,
    replicate,
    shard_params,
    sharded_forward,
    training_step,
)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """See :func:`vision_tpu_torch.parallel.dryrun.dryrun_multichip`."""
    from .dryrun import dryrun_multichip as run

    run(n_devices, device=device)


__all__ = [
    "DEFAULT_TP_RULES",
    "SAM3_TP_RULES",
    "batch_sharding",
    "dryrun_multichip",
    "init_distributed",
    "make_mesh",
    "pipeline_apply",
    "replicate",
    "shard_params",
    "sharded_forward",
    "stage_sharding",
    "training_step",
]
