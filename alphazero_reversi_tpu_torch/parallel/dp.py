"""Data-parallel self-play and SGD over the ranks of a process group.

Port of ``alphazero_reversi_tpu/parallel/dp.py``:

* **Sharded self-play** (``sharded_play_games``): each rank plays its
  contiguous block of the batch's games. Every draw (the Gumbel root draw,
  PUCT's log-gamma noise, the move sampling) is made at the whole batch's
  shape from a generator seeded alike on every rank, and the rank keeps its
  rows, so ``d`` ranks play the games one process plays from the same seed.
  No collective runs inside a batch.
* **DP SGD** (``DPTrainer``, the JAX ``_local_step_math``): every rank
  draws the same global index vector and keeps its contiguous block of
  ``batch_size / d`` rows, computes the loss and gradients on them, and one
  ``all_reduce`` of a flat buffer averages the gradients, the BatchNorm
  running averages each rank updated from its own rows, and the aux
  metrics (the JAX ``pmean``s). Then the clip, the reported ``grad_norm``
  and AdamW run alike on every rank. Each rank normalises by its own rows'
  batch statistics, as the JAX shards do (not ``SyncBatchNorm``); no
  ``DistributedDataParallel`` (its default ``broadcast_buffers`` would
  overwrite the running averages with rank 0's).

The symmetry and dropout draws are made at the global batch's shape from
the shared generator and each rank keeps its rows: the ranks' draws differ,
as the JAX package's ``fold_in(axis_index)`` makes them differ, and the
only generator state is the one shared stream, which the checkpoint holds.
At one rank every draw, and so every step, is the one-device learner's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import learner as learner_lib
from .. import selfplay as selfplay_lib
from ..config import TrainingConfig
from ..models import resnet
from . import multihost as mh
from .mesh import Mesh, is_initialized, make_mesh


def sharded_play_games(net, *, num_games: int, seed: int,
                       mesh: Optional[Mesh] = None, device=None,
                       **kwargs) -> selfplay_lib.Trajectory:
    """This rank's block of a self-play batch of ``num_games`` games from
    ``seed`` (``selfplay.play_games`` with ``global_games``): games ``[r n
    / d, (r + 1) n / d)``, the ``[T, n / d]`` trajectory. ``num_games`` must
    divide over the ranks. ``mesh`` defaults to ``make_mesh(device=...)``
    (CUDA unless ``device`` says otherwise); the net must be on its device.
    ``kwargs`` are ``play_games``' search and schedule parameters."""
    mesh = mesh or make_mesh(device=device)
    if num_games % mesh.world:
        raise ValueError(f"num_games={num_games} not divisible over "
                         f"{mesh.world} ranks")
    per = num_games // mesh.world
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    return selfplay_lib.play_games(
        net, num_games=per, first_game=mesh.rank * per,
        global_games=num_games, generator=gen, device=mesh.device,
        **kwargs)


def average_over_ranks(grads: List[torch.Tensor], net,
                       aux: Dict[str, torch.Tensor], world: int
                       ) -> Dict[str, torch.Tensor]:
    """The ``learner.train_step`` ``reduce`` hook: the gradients, ``net``'s
    BatchNorm running averages and the aux metrics, averaged over the ranks
    in place by one ``all_reduce`` of a flat float32 buffer (a sum, then a
    division by ``world``; exact at one rank). Returns the averaged aux.
    Without a process group it changes nothing."""
    if not is_initialized():
        return aux
    keys = sorted(aux)
    tensors = grads + list(resnet.batch_stats(net).values())
    flat = torch.cat([t.reshape(-1).float() for t in tensors]
                     + [torch.stack([aux[k].float() for k in keys])])
    flat = mh.all_reduce_sum(flat).div_(world)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    tail = flat[offset:].clone()  # the aux outlive the step, not the buffer
    return {k: tail[i] for i, k in enumerate(keys)}


class DPTrainer(learner_lib.Learner):
    """``learner.Learner`` over the ranks: same surface, DP steps (this
    rank's block of every batch, ``average_over_ranks`` between the
    backward pass and the clip). Every rank builds it from the same net,
    so the states start alike and stay alike. ``mesh`` defaults to
    ``make_mesh(device=...)`` (CUDA unless ``device`` says otherwise);
    without a process group it is the one-device ``Learner``."""

    def __init__(self, net, cfg: TrainingConfig, mesh: Optional[Mesh] = None,
                 device=None):
        self.mesh = mesh or make_mesh(device=device)
        super().__init__(net, cfg, device=self.mesh.device)

    def _reduce(self, grads, net, aux):
        return average_over_ranks(grads, net, aux, self.mesh.world)

    def _block(self, batch_size: int):
        d = self.mesh.world
        if batch_size % d:
            raise ValueError(f"batch_size={batch_size} not divisible over "
                             f"{d} ranks")
        per = batch_size // d
        return self.mesh.rank * per, per
