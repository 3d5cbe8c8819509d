"""GPipe-style pipeline parallelism for stacked-layer trunks — a port of
vision_tpu/parallel/pipeline.py.

For trunks that are a sequence of IDENTICALLY-SHAPED stages, the pipeline
axis shards the LAYERS over cards (each holds n_layers/P of the trunk), so
it is the axis that scales models larger than one card's memory; the price
is the pipeline bubble (P-1 of M+P-1 steps) and one activation hand-off per
stage step.

Design (one loop on every rank of the pp group, as the JAX package's
``shard_map`` body):
  * stage weights are pytrees whose leaves carry a leading ``n_stages``
    axis; rank k of the pp axis uses only slice k (place them with
    :func:`stage_sharding`; whole tensors on every rank work too).
  * microbatches enter replicated; every rank runs the same loop of
    M + P - 1 steps. At step t, rank k runs its stage on the activation
    received from rank k-1 (stage 0 injects microbatch t);
    ``dist.batch_isend_irecv`` passes activations one stage forward. The
    last stage collects its outputs, and one broadcast over the pp group
    returns them to every rank.
  * warm-up / drain steps compute on zeros (the standard GPipe bubble);
    correctness never depends on them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["stage_sharding", "pipeline_apply"]


def stage_sharding(mesh, axis: str = "pp") -> list:
    """Placements of stage-stacked weights: the leading (stage) axis over ``axis``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    out[mesh.mesh_dim_names.index(axis)] = Shard(0)
    return out


def _stage_slice(leaf, k: int):
    from .tp import is_dtensor

    if is_dtensor(leaf):  # placed with stage_sharding: the local slice is (1, ...)
        loc = leaf.to_local()
        return loc[0] if loc.shape[0] == 1 and leaf.shape[0] != 1 else loc[k]
    return leaf[k]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_weights: Any,
    xs: torch.Tensor,
    mesh,
    axis: str = "pp",
):
    """Run ``xs`` (M microbatches, leading axis M) through ``n_stages``
    pipeline stages laid out over the mesh's ``axis``. Every rank of the
    mesh calls it with the same ``xs``.

    ``stage_fn(weights_slice, x) -> y`` must preserve the activation
    shape/dtype (y feeds the next stage). ``stage_weights`` is a pytree
    whose leaves carry a leading ``n_stages`` axis equal to the mesh axis
    size. Returns the (M, ...) outputs on every rank, equal to applying the
    stages sequentially per microbatch."""
    from .sharding import mesh_shape

    shape = mesh_shape(mesh)
    if axis not in shape:
        raise ValueError(f"mesh has no '{axis}' axis: {shape}")
    n_stages = shape[axis]
    bad = [
        tuple(leaf.shape)
        for leaf in tree_leaves(stage_weights)
        if leaf.ndim < 1 or leaf.shape[0] != n_stages
    ]
    if bad:
        raise ValueError(
            f"stage_weights leaves need a leading n_stages={n_stages} axis; got {bad[:3]}"
        )
    m = xs.shape[0]
    if m < 1:
        raise ValueError("xs needs at least one microbatch")

    k = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    w = tree_map(lambda leaf: _stage_slice(leaf, k), stage_weights)
    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    with torch.inference_mode():
        for t in range(m + n_stages - 1):
            # stage 0 injects microbatch t (clamped during drain steps)
            inp = xs[min(t, m - 1)] if k == 0 else buf
            y = stage_fn(w, inp)
            # at step t the LAST stage finishes microbatch t - (P-1)
            j = t - (n_stages - 1)
            if k == n_stages - 1 and j >= 0:
                outs[j] = y
            if n_stages > 1:
                nxt = torch.empty_like(y)
                ops = [
                    dist.P2POp(dist.isend, y.contiguous(), ranks[(k + 1) % n_stages], group),
                    dist.P2POp(dist.irecv, nxt, ranks[(k - 1) % n_stages], group),
                ]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
                buf = nxt
            else:
                buf = y
        # results exist on the last stage only; one broadcast returns them
        dist.broadcast(outs, src=ranks[n_stages - 1], group=group)
    return outs
