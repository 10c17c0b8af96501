"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (port of
``repro/distributed/pipeline.py``).

Layers (stacked along the leading dim) are split into S contiguous
stages, one per rank of the axis; microbatches stream through the stage
ring, each handoff one point-to-point transfer (``launch.mesh.
ring_shift``). After M + S - 1 ticks every microbatch has crossed every
stage; the bubble fraction is (S - 1) / (M + S - 1). The tick loop is
explicit, as JAX's, so its pattern of transfers is the schedule's.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.tree import tree_leaves, tree_map
from repro_torch.launch.mesh import all_gather, ring_shift


def pipeline_apply(
    layer_fn: Callable,
    stacked_params,
    x: torch.Tensor,
    *,
    mesh,
    num_microbatches: int,
    axis_name: str = "stage",
) -> torch.Tensor:
    """Run x (B, ...) through L stacked layers split over the ``stage``
    axis. ``layer_fn(params_one_layer, activations) -> activations``.

    Every rank passes the global x and parameters and gets the final
    activations (B, ...): the last stage's rows, gathered to every rank.
    Equal to the sequential loop over all L layers in fp32.
    """
    n_stages = mesh.shape[axis_name]
    b = x.shape[0]
    assert b % num_microbatches == 0, (b, num_microbatches)
    mb = b // num_microbatches
    xs = x.reshape((num_microbatches, mb) + tuple(x.shape[1:]))
    stage = mesh.coordinate(axis_name)

    def local(p):  # this stage's contiguous L / S layers
        n_layers = p.shape[0]
        assert n_layers % n_stages == 0, (n_layers, n_stages)
        per = n_layers // n_stages
        return p[stage * per:(stage + 1) * per]

    params_local = tree_map(local, stacked_params)
    per_stage = tree_leaves(params_local)[0].shape[0]

    def apply_stage(h):
        for i in range(per_stage):
            h = layer_fn(tree_map(lambda p: p[i], params_local), h)
        return h

    state = torch.zeros_like(xs[0])  # the activation handed to this stage
    outs = torch.zeros_like(xs)
    for t in range(num_microbatches + n_stages - 1):
        # stage 0 ingests microbatch t (clamped past the last one)
        h = xs[min(t, num_microbatches - 1)] if stage == 0 else state
        y = apply_stage(h)
        # the last stage commits microbatch t - (S - 1) once it is valid
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        (state,), wait = ring_shift([y], mesh, axis_name)
        wait()
    final = all_gather(outs[None], mesh, axis_name, 0)[-1]
    return final.reshape((b,) + tuple(x.shape[1:]))

