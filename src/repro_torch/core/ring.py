"""Ring-DIGC: the paper's GMM lifted to a ring of ranks (port of
``repro/core/ring.py``).

Co-node features are sharded across the ranks of a mesh axis. At each
hop every rank (a) posts the send of the co-node shard it holds to its
ring neighbour and the receive of the next one, and (b) merges the shard
it holds into its running top-(k*d) list, then waits for the transfer:
the link plays the role of the FPGA heap's input streams, the running
list plays the heap. After ``n`` hops every rank has seen every co-node
shard and holds the exact global top-(k*d) of its own nodes; no rank
computes against the whole co-node set.

SPMD over ``torch.distributed`` (``launch/mesh.py``): every rank calls
``ring_digc`` with the same global inputs, slices its node and co-node
shards (and, with ``batch_axis``, its batch rows) and returns the global
result gathered from the shards. An axis of size 1 issues no collective,
so a one-rank mesh runs the whole ring in-process (and inside a captured
CUDA graph).

Ties go by hop order, as in JAX: at hop h rank ``my`` holds the shard of
rank ``(my - h) mod n``, and the merge keeps the earlier position of
``[running, block]`` (``core.engine.merge_topk_xla``), so a tie goes to
the shard met first, not to the lowest global index.

It is a stateful builder: a ``DigcStateEntry`` carrying co-node squared
norms (``sq_y``) rides the frozen-gallery contract of the blocked tier.
An entry placed on the mesh (``state_entry(mesh=)``) holds only this
rank's column shard of the norms; each rank selects, per batch row,
between its carried shard (warm) and a fresh shard-local pass (cold), and
the norm shard rotates the ring with its feature shard. The hop is plain
PyTorch (a matmul and the merge), as JAX's is plain ``jnp``: the ring
launches no kernel of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.builder import (
    REUSE_KNOBS, DigcSpec, GraphBuilder, promote_batch, register,
)
from repro_torch.core.digc import BIG, dilate
from repro_torch.core.engine import live_mask, merge_topk_xla
from repro_torch.launch.mesh import all_gather, require_global, ring_shift


def _ring_hops(x_loc, y_loc, sq_loc, *, kd: int, mesh, axis_name: str):
    """The hop loop each rank runs on its shards.

    x_loc (b, n_loc, D) node shard; y_loc (b, m_loc, D) co-node shard;
    sq_loc (b, m_loc) the shard's co-node norms (selected warm/cold and
    BIG on padding: the loop never recomputes them, they rotate with
    their feature shard). Returns (dist, idx) of the global top-kd, idx
    in global co-node coordinates."""
    n_dev = mesh.shape[axis_name]
    my = mesh.coordinate(axis_name)
    b, n_loc, _ = x_loc.shape
    m_loc = y_loc.shape[-2]
    # Hoisted out of the hop loop: the query norms never rotate.
    sq_x = (x_loc * x_loc).sum(-1, keepdim=True)  # (b, n_loc, 1)
    cols = torch.arange(m_loc, dtype=torch.int32, device=x_loc.device)
    run_d = torch.full((b, n_loc, kd), BIG, dtype=torch.float32,
                       device=x_loc.device)
    run_i = torch.zeros((b, n_loc, kd), dtype=torch.int32,
                        device=x_loc.device)
    y_cur, sq_cur = y_loc, sq_loc
    for h in range(n_dev):
        last = h == n_dev - 1
        if not last:
            # Post the rotation first so the transfer overlaps the local
            # distance and merge below; the norm shard rides with it.
            (y_next, sq_next), wait = ring_shift([y_cur, sq_cur], mesh,
                                                 axis_name)
        off = ((my - h) % n_dev) * m_loc  # the held shard's first column
        inner = torch.matmul(x_loc, y_cur.transpose(-1, -2))
        d_blk = sq_x - 2.0 * inner + sq_cur[:, None, :]
        blk_i = (cols + off).expand(b, n_loc, m_loc)
        run_d, run_i = merge_topk_xla(run_d, run_i, d_blk, blk_i, kd)
        if not last:
            wait()
            y_cur, sq_cur = y_next, sq_next
    return run_d, run_i


def _local_norms(y_loc, sq_loc, valid_loc, *, m: int, my: int,
                 live_loc=None):
    """This rank's co-node norm shard: carried (warm rows) or a fresh
    shard-local pass (cold rows), BIG on device padding (global column
    >= m) and on caller-declared pad co-nodes (``live_loc`` False)."""
    m_loc = y_loc.shape[-2]
    gid = my * m_loc + torch.arange(m_loc, device=y_loc.device)
    fresh = (y_loc * y_loc).sum(-1)  # (b, m_loc)
    sq = fresh if sq_loc is None else torch.where(valid_loc[:, None],
                                                  sq_loc, fresh)
    big = torch.full_like(sq, BIG)
    if live_loc is not None:
        sq = torch.where(live_loc, sq, big)
    return torch.where((gid >= m)[None, :], big, sq)


def _ceil_to(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


def ring_digc(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    k: int,
    dilation: int = 1,
    mesh=None,
    axis_name: str = "data",
    batch_axis: Optional[str] = None,
    sq_y: Optional[torch.Tensor] = None,
    sq_valid=None,
    sq_y_sharded: bool = False,
    return_dists: bool = False,
    return_norms: bool = False,
    m_valid=None,
):
    """Distributed DIGC over a ring of ranks.

    Accepts (N, D) or (B, N, D) global values on every rank and returns
    the global (B, N, k) result on every rank; exact, with JAX's ring's
    tie order. ``batch_axis`` shards the batch rows along a second mesh
    axis (B must divide by it). A 2-D ``y`` next to a batched ``x`` is a
    shared gallery, broadcast across the batch.

    ``sq_y`` carries co-node squared norms (the frozen-gallery hook):
    the global (B, M), or with ``sq_y_sharded`` this rank's column shard
    (B, M / n) of a placed state entry. ``sq_valid`` (() or (B,) bool)
    selects carried against fresh norms per row. ``return_norms``
    appends the selected norms in the form ``sq_y`` came in (the global
    (B, M), or this rank's shard). ``m_valid`` ((M,) or (B, M) bool)
    marks live co-nodes: pad lanes take the BIG-norm mask of the ring's
    own padding.
    """
    if mesh is None:
        raise ValueError("ring_digc requires an explicit mesh")
    require_global(x, y, sq_y)
    if y is not None and y.ndim == 2 and x.ndim == 3:
        y = y[None].expand((x.shape[0],) + tuple(y.shape))
    x3, y3, _, squeeze = promote_batch(x, y)
    n_dev = mesh.shape[axis_name]
    b, n, _ = x3.shape
    m = y3.shape[1]
    kd = k * dilation
    if kd > m:
        raise ValueError(f"k*dilation={kd} exceeds number of co-nodes M={m}")
    n_rows = 1 if batch_axis is None else mesh.shape[batch_axis]
    if b % n_rows != 0:
        raise ValueError(
            f"batch {b} does not divide the {batch_axis!r} mesh axis "
            f"({n_rows} devices)"
        )
    my = mesh.coordinate(axis_name)
    n_pad, m_pad = _ceil_to(n, n_dev), _ceil_to(m, n_dev)
    n_loc, m_loc, b_loc = n_pad // n_dev, m_pad // n_dev, b // n_rows
    r0 = 0 if batch_axis is None else mesh.coordinate(batch_axis) * b_loc
    rows = slice(r0, r0 + b_loc)

    def shard(t, size):  # this rank's rows and column shard, zero-padded
        t = t[rows]
        lo, hi = my * size, min((my + 1) * size, t.shape[1])
        part = t[:, lo:hi] if lo < t.shape[1] else t[:, :0]
        fill = size - part.shape[1]
        if fill:
            part = torch.cat([part, part.new_zeros(
                (part.shape[0], fill) + tuple(part.shape[2:]))], dim=1)
        return part

    x_loc = shard(x3.float(), n_loc)
    # Padded co-nodes are zero rows masked through their norm (BIG), so a
    # pad lane can never displace a real neighbour.
    y_loc = shard(y3.float(), m_loc)
    sq_loc = valid_loc = None
    if sq_y is not None:
        sq_loc = (sq_y.float()[rows] if sq_y_sharded
                  else shard(sq_y.float(), m_loc))
        valid = torch.as_tensor(True if sq_valid is None else sq_valid,
                                device=x3.device)
        valid_loc = valid.expand(b)[rows]
    live_loc = None
    if m_valid is not None:
        live = live_mask(m_valid, x3.device)
        live = (live[None, :] if live.ndim == 1 else live).expand(b, m)
        live_loc = shard(live, m_loc)
    sq = _local_norms(y_loc, sq_loc, valid_loc, m=m, my=my,
                      live_loc=live_loc)
    run_d, run_i = _ring_hops(x_loc, y_loc, sq, kd=kd, mesh=mesh,
                              axis_name=axis_name)

    def gather(t, dim_ring):  # shards -> the global value on every rank
        t = all_gather(t, mesh, axis_name, dim_ring)
        return t if batch_axis is None else all_gather(t, mesh, batch_axis, 0)

    run_d = gather(run_d, 1)[:, :n]
    run_i = gather(run_i, 1)[:, :n]
    idx = dilate(run_i, dilation)
    dist = dilate(run_d, dilation)
    if squeeze:
        idx, dist = idx[0], dist[0]
    out = (idx, dist) if return_dists else (idx,)
    if return_norms:
        # The selected norms, device padding sliced off: what the next
        # warm call's entry should carry.
        if sq_y is None:
            norms = None
        elif sq_y_sharded:
            norms = (sq if batch_axis is None
                     else all_gather(sq, mesh, batch_axis, 0))
        else:
            norms = gather(sq, 1)[:, :m]
        out = out + (norms,)
    return out if len(out) > 1 else out[0]


# --------------------------------------------------------------------------
# Registry entry


def _build_ring(x, y, pos_bias, spec: DigcSpec, state_entry=None,
                m_valid=None):
    del pos_bias  # validated unsupported upstream
    common = dict(
        k=spec.k, dilation=spec.dilation, mesh=spec.mesh,
        axis_name=spec.axis_name if spec.axis_name is not None else "data",
        batch_axis=spec.batch_axis,
        return_dists=True,
        m_valid=m_valid,
    )
    if state_entry is None:
        return ring_digc(x, y, **common)
    # The frozen-gallery contract of the blocked tier: carried norms
    # engage only for explicit co-nodes of the entry's shape. Self-graph
    # calls (y=None: co-nodes are this call's features) advance the
    # counters but never carry norms. Warm/cold is per batch row when the
    # entry carries row_step.
    if (y is not None and state_entry.sq_y is not None
            and state_entry.sq_y_shape == tuple(y.shape[:-1])):
        valid = (state_entry.row_warm if state_entry.row_step is not None
                 else state_entry.warm)
        idx, dist, norms = ring_digc(
            x, y, sq_y=state_entry.sq_y, sq_valid=valid,
            sq_y_sharded=state_entry.sq_y_placement is not None,
            return_norms=True, **common,
        )
        return idx, dist, state_entry.bump(sq_y=norms)
    idx, dist = ring_digc(x, y, **common)
    return idx, dist, state_entry.bump()


register(GraphBuilder(
    name="ring",
    build=_build_ring,
    knobs=frozenset({"mesh", "axis_name", "batch_axis"}) | REUSE_KNOBS,
    exact=True,
    distributed=True,
    supports_state=True,  # sharded co-node norms via DigcState entries
    supports_pad=True,  # m_valid rides the same BIG-norm mask as rank pads
    doc="pod-level GMM: co-node shards rotate a ring of ranks "
        "(requires mesh= knob; batch_axis= shards rows data-parallel; "
        "stateful — carries sharded frozen-gallery norms)",
))
