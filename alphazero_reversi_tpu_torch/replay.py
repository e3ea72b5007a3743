"""Replay buffer on the device.

Port of ``alphazero_reversi_tpu/replay.py``: a ring buffer over the last
``capacity`` training positions, kept on the card so that the host never
touches the data between self-play and SGD. Planes are stored as ``int8``
(they are 0/1 masks), four times smaller than float32, and cast on sample.
At the flagship's capacity of 200,000 the buffer holds about 91 MB (38.4 MB
planes, 52 MB policy, 0.8 MB value).

``cursor`` and ``size`` are host integers: ``add`` reads the number of
valid rows once (one sync per insert, which the caller needs anyway to
count new positions), and ``sample`` then draws indices on the device with
no sync.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .mcts.search import resolve_device


class ReplayBuffer(NamedTuple):
    """Ring buffer of training positions. Capacity = leading dim."""

    planes: torch.Tensor  # [C, 8, 8, 3] int8
    policy: torch.Tensor  # [C, 65] f32
    value: torch.Tensor  # [C] f32
    cursor: int  # next write slot
    size: int  # filled slots (<= C)


def create(capacity: int, board_size: int = 8, num_actions: int = 65,
           device=None) -> ReplayBuffer:
    """An empty buffer on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    return ReplayBuffer(
        planes=torch.zeros(capacity, board_size, board_size, 3,
                           dtype=torch.int8, device=dev),
        policy=torch.zeros(capacity, num_actions, device=dev),
        value=torch.zeros(capacity, device=dev),
        cursor=0, size=0)


def add(buffer: ReplayBuffer, planes: torch.Tensor, policy: torch.Tensor,
        value: torch.Tensor, valid: torch.Tensor) -> ReplayBuffer:
    """Ring-insert the ``valid`` rows of a flat batch, in order, from
    ``cursor``. The storage is written in place; the returned buffer holds
    the new ``cursor`` and ``size``.

    When one insert has more valid rows than the capacity, the later rows
    win: only the last ``capacity`` valid rows are written, each to the slot
    the ring gives it. (The JAX scatter has duplicate indices there and no
    defined order.)
    """
    capacity = buffer.value.shape[0]
    idx = torch.nonzero(valid.reshape(-1)).squeeze(1)  # syncs once
    n = idx.numel()
    skip = max(0, n - capacity)
    idx = idx[skip:]
    dest = (buffer.cursor + skip
            + torch.arange(idx.numel(), device=idx.device)) % capacity
    buffer.planes[dest] = planes.index_select(0, idx).to(torch.int8)
    buffer.policy[dest] = policy.index_select(0, idx)
    buffer.value[dest] = value.index_select(0, idx)
    return buffer._replace(cursor=(buffer.cursor + n) % capacity,
                           size=min(buffer.size + n, capacity))


def gather(buffer: ReplayBuffer, idx: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows ``idx`` of the buffer -> (planes f32, policy, value)."""
    return (buffer.planes.index_select(0, idx).float(),
            buffer.policy.index_select(0, idx),
            buffer.value.index_select(0, idx))


def sample_indices(buffer: ReplayBuffer,
                   generator: Optional[torch.Generator],
                   batch_size: int) -> torch.Tensor:
    """``batch_size`` row indices drawn uniformly, with replacement, from
    the filled rows, on the buffer's device from ``generator``."""
    return torch.randint(0, max(buffer.size, 1), (batch_size,),
                         generator=generator, device=buffer.value.device)


def sample(buffer: ReplayBuffer, generator: Optional[torch.Generator],
           batch_size: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform sample with replacement from the filled rows, drawn on the
    buffer's device from ``generator`` -> (planes f32, policy, value)."""
    return gather(buffer, sample_indices(buffer, generator, batch_size))


def reset(buffer: ReplayBuffer) -> ReplayBuffer:
    """Empty the buffer (used by ``train_on_latest_only``)."""
    return buffer._replace(cursor=0, size=0)
