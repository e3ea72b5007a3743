"""Replay buffer split over the ranks (``training.shard_replay_buffer``).

Port of ``alphazero_reversi_tpu/parallel/replay_sharded.py``. The
replicated buffer holds every position on every rank, and each insert
needs the whole batch gathered first. Here rank r holds a ring of its own,
``capacity / d`` rows on its card (``ShardedReplayBuffer``, host-integer
``cursor`` and ``size`` as ``replay.ReplayBuffer``):

* **Insert**: each rank inserts the positions of its own games
  (``replay.add`` on its ring; ``replay.reset`` empties it). No
  collective.
* **Sampling**: inside the DP steps (``dp.DPTrainer.steps``), every rank
  draws the same global index vector against its own ring's size and keeps
  its block: the replicated buffer's derivation, so ranks that held the
  same rows would train bit for bit as the replicated buffer does.
* **Checkpoints** store the canonical one-ring form
  (``canonicalize_host``: each rank's rows oldest first, rank after rank,
  compacted to the front, with a scalar cursor and size), so they restore
  into any number of ranks and into the replicated buffer
  (``shard_host`` deals the rows out again). They also keep each rank's
  cursor and size, so a restore at the same number of ranks rebuilds each
  rank's ring exactly (``restore_layout``) and a resumed run samples the
  rows the uninterrupted run would have.

``canonicalize_host`` and ``shard_host`` are pure numpy and give the JAX
package's arrays on the same rings.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import replay as replay_lib
from . import multihost as mh
from .mesh import Mesh


class ShardedReplayBuffer(NamedTuple):
    """This rank's ring of a sharded buffer; fields as
    ``replay.ReplayBuffer``, whose functions (``add``, ``sample``,
    ``gather``, ``reset``) take it as they are."""

    planes: torch.Tensor  # [C / d, 8, 8, 3] int8
    policy: torch.Tensor  # [C / d, 65] f32
    value: torch.Tensor  # [C / d] f32
    cursor: int
    size: int


def rounded_capacity(capacity: int, d: int) -> int:
    """Capacity rounded up to a multiple of the ranks (equal rings)."""
    return ((capacity + d - 1) // d) * d


def create(capacity: int, mesh: Mesh, board_size: int = 8,
           num_actions: int = 65) -> ShardedReplayBuffer:
    """This rank's empty ring of ``capacity / d`` rows on its device;
    ``capacity`` must divide over the ranks (``rounded_capacity``)."""
    if capacity % mesh.world:
        raise ValueError(f"capacity={capacity} not divisible over "
                         f"{mesh.world} ranks (use rounded_capacity)")
    return ShardedReplayBuffer(*replay_lib.create(
        capacity // mesh.world, board_size, num_actions, mesh.device))


def is_sharded(buffer: Any) -> bool:
    return isinstance(buffer, ShardedReplayBuffer)


def total_size(buffer: Any) -> int:
    """Filled rows over all rings (a sum over the ranks for a sharded
    buffer); the buffer's size otherwise."""
    return mh.global_sum(buffer.size) if is_sharded(buffer) else buffer.size


# -- the canonical one-ring form (checkpoints) ------------------------------

def canonicalize_host(host: replay_lib.ReplayBuffer
                      ) -> replay_lib.ReplayBuffer:
    """Gathered host rings (numpy leaves: ``[C, ...]`` rows rank after rank,
    ``cursor`` and ``size`` ``[d]``) -> the one-ring form of the same
    capacity: each ring's rows oldest first, ring after ring, compacted to
    the front; scalar ``cursor`` and ``size``. A buffer already in that
    form (scalar cursor) is returned as it is."""
    cursor = np.asarray(host.cursor)
    if cursor.ndim == 0:
        return host
    d = cursor.shape[0]
    size = np.asarray(host.size)
    c = np.asarray(host.value).shape[0]
    cl = c // d
    order = []
    for i in range(d):
        si, ci = int(size[i]), int(cursor[i])
        idx = np.arange(si) if si < cl else np.concatenate(
            [np.arange(ci, cl), np.arange(ci)])  # a wrapped ring
        order.append(i * cl + idx)
    order = np.concatenate(order).astype(np.int64) if order \
        else np.zeros((0,), np.int64)
    total = int(order.shape[0])

    def compact(x):
        x = np.asarray(x)
        out = np.zeros_like(x)
        out[:total] = x[order]
        return out

    return replay_lib.ReplayBuffer(
        planes=compact(host.planes), policy=compact(host.policy),
        value=compact(host.value), cursor=np.int32(total % c),
        size=np.int32(total))


def shard_host(canonical: replay_lib.ReplayBuffer, d: int
               ) -> replay_lib.ReplayBuffer:
    """A one-ring host buffer -> ``d`` rings (numpy, rings rank after rank,
    ``cursor`` and ``size`` ``[d]``): its rows oldest first, dealt to the
    rings in contiguous near-equal runs. Also takes a ring that has
    wrapped (an unsharded run's)."""
    cursor = int(np.asarray(canonical.cursor))
    size = int(np.asarray(canonical.size))
    c = np.asarray(canonical.value).shape[0]
    if c % d:
        raise ValueError(f"canonical capacity {c} not divisible over {d} "
                         f"ranks")
    cl = c // d
    order = np.arange(size) if size < c else np.concatenate(
        [np.arange(cursor, c), np.arange(cursor)])
    base, extra = size // d, size % d
    sizes = np.asarray([base + (i < extra) for i in range(d)], np.int32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    def deal(x):
        x = np.asarray(x)
        out = np.zeros((c, *x.shape[1:]), x.dtype)
        for i in range(d):
            rows = order[starts[i]:starts[i] + sizes[i]]
            out[i * cl:i * cl + sizes[i]] = x[rows]
        return out

    return replay_lib.ReplayBuffer(
        planes=deal(canonical.planes), policy=deal(canonical.policy),
        value=deal(canonical.value), cursor=(sizes % cl).astype(np.int32),
        size=sizes)


def restore_layout(canonical: replay_lib.ReplayBuffer,
                   cursors: Sequence[int], sizes: Sequence[int]
                   ) -> replay_lib.ReplayBuffer:
    """The inverse of ``canonicalize_host`` given the rings' ``cursors``
    and ``sizes``: each ring's rows back at the slots they held (rows no
    ring holds are zero)."""
    d = len(sizes)
    c = np.asarray(canonical.value).shape[0]
    cl = c // d
    dest, start = [], 0
    for i, (ci, si) in enumerate(zip(cursors, sizes)):
        idx = np.arange(si) if si < cl else np.concatenate(
            [np.arange(ci, cl), np.arange(ci)])
        dest.append(i * cl + idx)
        start += si
    dest = np.concatenate(dest).astype(np.int64)

    def place(x):
        x = np.asarray(x)
        out = np.zeros_like(x)
        out[dest] = x[:start]
        return out

    return replay_lib.ReplayBuffer(
        planes=place(canonical.planes), policy=place(canonical.policy),
        value=place(canonical.value),
        cursor=np.asarray(cursors, np.int32), size=np.asarray(sizes,
                                                              np.int32))


def checkpoint_tree(buffer: ShardedReplayBuffer,
                    timeout_s: Optional[float] = None) -> Dict[str, Any]:
    """The checkpoint's replay entry, on every rank: the rings gathered
    (a collective: call it on the loop's thread, on every rank) and put in
    the canonical form, as host tensors and integers, plus each ring's
    ``shard_cursor`` and ``shard_size``."""
    local = torch.tensor([buffer.cursor, buffer.size], dtype=torch.int64)
    gathered = mh.fetch_replicated(
        {"planes": buffer.planes, "policy": buffer.policy,
         "value": buffer.value, "layout": local[None]}, 0, timeout_s)
    layout = gathered["layout"].numpy()
    canon = canonicalize_host(replay_lib.ReplayBuffer(
        planes=gathered["planes"].numpy(),
        policy=gathered["policy"].numpy(),
        value=gathered["value"].numpy(), cursor=layout[:, 0],
        size=layout[:, 1]))
    return {"planes": torch.from_numpy(canon.planes),
            "policy": torch.from_numpy(canon.policy),
            "value": torch.from_numpy(canon.value),
            "cursor": int(canon.cursor), "size": int(canon.size),
            "shard_cursor": layout[:, 0].tolist(),
            "shard_size": layout[:, 1].tolist()}


def from_checkpoint(rep: Dict[str, Any], mesh: Mesh) -> ShardedReplayBuffer:
    """This rank's ring from a checkpoint's replay entry (either mode's):
    each ring's own slots when the entry records as many rings as there
    are ranks, else its rows dealt out afresh (``shard_host``)."""
    host = replay_lib.ReplayBuffer(
        planes=rep["planes"].numpy(), policy=rep["policy"].numpy(),
        value=rep["value"].numpy(), cursor=np.int32(rep["cursor"]),
        size=np.int32(rep["size"]))
    if len(rep.get("shard_size", ())) == mesh.world:
        rings = restore_layout(host, rep["shard_cursor"], rep["shard_size"])
    else:
        rings = shard_host(host, mesh.world)
    cl = host.value.shape[0] // mesh.world
    block = slice(mesh.rank * cl, (mesh.rank + 1) * cl)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x[block])).to(
        mesh.device)
    return ShardedReplayBuffer(
        planes=t(rings.planes), policy=t(rings.policy), value=t(rings.value),
        cursor=int(rings.cursor[mesh.rank]), size=int(rings.size[mesh.rank]))
