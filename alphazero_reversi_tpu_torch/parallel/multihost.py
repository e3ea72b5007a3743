"""What a data-parallel run of the pipeline needs beyond SGD: primary-only
writes, gathers, agreement.

Port of ``alphazero_reversi_tpu/parallel/multihost.py`` with
``torch.distributed`` collectives. Every rank runs the same program with the
same seed, so every host decision comes out alike on every rank; exactly
one rank (0, the *primary*) writes checkpoints, best weights, trajectories
and logs. Where a decision feeds a collective, it is made from values all
ranks share (global counts, broadcasts), never from a rank's own.

* **Gathers**: ``from_local_block`` is an ``all_gather`` of each rank's
  block along an axis, put back in global order; ``fetch_replicated`` is
  the same, copied to the host. ``gather_trajectory`` rebuilds a self-play
  batch ``[T, B]`` from the ranks' ``[T, B / d]`` blocks. The JAX
  ``local_block`` is ``mesh.local_rows``, and its
  ``fetch_replicated_local`` (a host copy with no collective, which a
  worker thread may take beside the loop's collectives) is
  ``checkpoint.to_host``, the background checkpoint worker's copy. The JAX
  ``canonical_tb_sharding`` has no counterpart: a rank's block is always
  its contiguous slice of the games axis.
* **Per-rank work**: ``relabel_sharded`` solves each rank's own games;
  ``aggregate_stats`` combines the ranks' stats (counts add up,
  ``seconds`` and ``max_empties_solved`` take the max);
  ``gather_unit_scores`` merges a sharded tournament's score rows
  (``score_gather``: over a gloo group that waits as long as play takes).
* **Agreement**: ``broadcast_from_primary`` (rank 0's value wins),
  ``barrier``, ``global_sum``.

Without a process group every helper is a no-op or the local value, so the
pipeline takes one path on one device and on ``d`` ranks. ``COLLECTIVES``
counts the collectives each helper issued, by kind.
"""
from __future__ import annotations

import datetime
import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import hostfetch
from .. import selfplay as selfplay_lib
from ..env import bitboard as env
from .mesh import is_initialized

# the longest a rank that has played its share waits at ``score_gather``'s
# gather for the others (a rank that dies closes its sockets and fails the
# wait at once; this bounds only a rank that hangs)
PLAY_TIMEOUT = datetime.timedelta(days=7)

# collectives issued since the last reset, by kind (all_gather, all_reduce,
# broadcast, barrier)
COLLECTIVES: Dict[str, int] = {}


def _count(kind: str) -> None:
    COLLECTIVES[kind] = COLLECTIVES.get(kind, 0) + 1


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the rank that owns all file writes and logging."""
    return process_index() == 0


def _comm_device(x: Optional[torch.Tensor] = None) -> torch.device:
    """Where the backend takes tensors: for NCCL ``x``'s card when it lies
    on one, else the current card (which ``initialize_distributed`` set,
    and ``hostfetch.guarded`` carries into its thread); the host for
    gloo."""
    if dist.get_backend() != "nccl":
        return torch.device("cpu")
    if x is not None and x.device.type == "cuda":
        return x.device
    return torch.device("cuda", torch.cuda.current_device())


def from_local_block(local: torch.Tensor, axis: int) -> torch.Tensor:
    """The global tensor from every rank's block along ``axis``, blocks in
    rank order (rank r's rows come r-th): an ``all_gather``. Returns on
    ``local``'s device and dtype."""
    if not is_initialized():
        return local
    comm = _comm_device(local)
    # the backends take no bool
    x = local.to(comm, torch.uint8 if local.dtype == torch.bool
                 else local.dtype).contiguous()
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x)
    _count("all_gather")
    return torch.cat(parts, axis).to(local.device, local.dtype)


def fetch_replicated(tree: Any, axis: int = 0,
                     timeout_s: Optional[float] = None) -> Any:
    """Host copy, on every rank, of the global value whose blocks along
    ``axis`` the ranks hold (``from_local_block`` per tensor), under the
    ``hostfetch`` watchdog."""
    return hostfetch.guarded(
        lambda: hostfetch.to_cpu(hostfetch.map_tensors(
            lambda x: from_local_block(x, axis), tree)),
        timeout_s, what="replicated fetch")


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (every rank receives the same sum), on
    ``x``'s device; may reduce ``x`` itself in place. ``x`` without a
    process group."""
    if not is_initialized():
        return x
    y = x.to(_comm_device(x))
    dist.all_reduce(y)
    _count("all_reduce")
    return y.to(x.device)


def global_sum(n: int) -> int:
    """An integer summed over the ranks."""
    return int(all_reduce_sum(torch.tensor([n], dtype=torch.int64)).item())


def gather_trajectory(traj: "selfplay_lib.Trajectory",
                      timeout_s: Optional[float] = None
                      ) -> "selfplay_lib.Trajectory":
    """The whole self-play batch from the ranks' blocks of games: every
    ``[T, B / d, ...]`` field gathered along the games axis and every
    final-state field along its batch axis, in global game order (so its
    flattening is the one-process order). On every rank, on the device."""
    def gather():
        t_fields = {name: from_local_block(getattr(traj, name), 1)
                    for name in ("planes", "policy", "value", "to_move",
                                 "valid", "actions")}
        final = env.EnvState(*(from_local_block(x, 0)
                               for x in traj.final_state))
        return traj._replace(final_state=final, **t_fields)

    return hostfetch.guarded(gather, timeout_s, what="trajectory gather")


def aggregate_stats(stats: Dict[str, float]) -> Dict[str, float]:
    """Combine the ranks' host stats: counts add up; ``seconds`` and
    ``max_empties_solved`` take the max (the JAX rule). The local stats
    without a process group."""
    if not is_initialized():
        return stats
    keys = sorted(stats)
    vec = torch.tensor([float(stats[k]) for k in keys], dtype=torch.float64)
    rows = from_local_block(vec[None], 0)
    return {k: float(rows[:, i].max()) if k in ("seconds",
                                                "max_empties_solved")
            else float(rows[:, i].sum()) for i, k in enumerate(keys)}


def relabel_sharded(traj: "selfplay_lib.Trajectory", max_empties: int,
                    compat: bool, budget_s: Optional[float],
                    fetch_timeout_s: Optional[float] = None):
    """``selfplay.relabel_exact_values_with_stats`` on this rank's own games
    (the solver work divides over the ranks; each rank's wall clock is held
    to ``budget_s``), with the stats combined over the ranks
    (``aggregate_stats``). Returns ``(traj, stats)``, ``traj`` still this
    rank's block: its relabelled value plane joins the global batch where
    the pipeline gathers the batch (``gather_trajectory``)."""
    traj, stats = selfplay_lib.relabel_exact_values_with_stats(
        traj, max_empties, compat=compat, budget_s=budget_s,
        fetch_timeout_s=fetch_timeout_s)
    return traj, aggregate_stats(stats)


def gather_unit_scores(scores: np.ndarray, owners: np.ndarray,
                       group=None) -> np.ndarray:
    """Merge a sharded tournament's ``[U, G]`` score rows
    (``arena.Arena.run_tournament``): gather every rank's rows and keep,
    for each unit, its owner's row. Over ``group`` (a gloo group, host
    rows) when given, else over the process group. The local rows without
    a process group."""
    if not is_initialized():
        return scores
    local = torch.from_numpy(np.ascontiguousarray(scores))
    if group is None:
        rows = from_local_block(local[None], 0)
    else:
        parts = [torch.empty_like(local) for _ in range(process_count())]
        dist.all_gather(parts, local, group=group)
        _count("all_gather")
        rows = torch.stack(parts)
    return rows.numpy()[owners, np.arange(scores.shape[0])]


def score_gather() -> Callable:
    """``gather_unit_scores`` for a gather that follows a long stretch of
    play: over a gloo group of its own whose collectives wait up to
    ``PLAY_TIMEOUT``, not the process group's ``mesh.TIMEOUT``, since one
    rank's share of a tournament may end hours before another's. A collective
    (it makes the group): every rank calls it at the same point, before
    play. ``gather_unit_scores`` itself without a process group."""
    if not is_initialized():
        return gather_unit_scores
    group = dist.new_group(backend="gloo", timeout=PLAY_TIMEOUT)
    return functools.partial(gather_unit_scores, group=group)


def broadcast_from_primary(value: Any) -> Any:
    """Rank 0's ``value`` on every rank (pickled; host objects only: a
    tensor would arrive on rank 0's device). The value itself without a
    process group."""
    if not is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    _count("broadcast")
    return box[0]


def barrier(name: str = "") -> None:
    """Wait until every rank gets here (``name`` documents where). No-op
    without a process group."""
    if is_initialized():
        dist.barrier()
        _count("barrier")
