"""Zobrist position hashing with dihedral-8 symmetry keys.

The port's copy of ``alphazero_reversi_tpu/zobrist.py``, with the same keys
(``KEYS64``/``TURN64`` from the same fixed-seed ``numpy.random.RandomState``),
so a position hashes to the same 64 bits in both packages. Two forms:

* batched (``hash_states`` / ``symmetry_hashes`` / ``canonical_hash``) over
  ``EnvState`` tensors on any device; a hash is one int64 holding the 64
  bits (``ops.u64``: the canonical key compares them unsigned);
* host (``hash_ints`` / ``transform_bits`` / ``symmetry_hashes_ints``) over
  Python ints, for ``env.game`` and ``mcts.transposition``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import symmetry
from .env import bitboard as env
from .ops import u64

_rng = np.random.RandomState(0x5EED0)
# KEYS64[p, sq]: p=0 black stone, p=1 white stone, square = row*8+col (the
# env's LSB-first order)
KEYS64 = _rng.randint(0, 2**64, size=(2, 64), dtype=np.uint64)
TURN64 = np.uint64(_rng.randint(0, 2**64, dtype=np.uint64))

_SIGN = u64.signed(1 << 63)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(keys [2, 64] int64, turn key int64, symmetry perms [8, 64] int64)
    on ``device``, one copy each."""
    keys = torch.from_numpy(KEYS64.view(np.int64).copy()).to(device)
    perms = torch.from_numpy(symmetry.PERMS).long().to(device)
    return keys, u64.signed(int(TURN64)), perms


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (a power of two long)."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] ^ x[..., half:]
    return x[..., 0]


def _hash_boards(black64: torch.Tensor, white64: torch.Tensor,
                 to_move: torch.Tensor) -> torch.Tensor:
    """Hash ``[..., 64]`` bool occupancy planes and the side to move."""
    keys, turn, _ = _tables(black64.device)
    h = _xor_reduce(torch.where(black64, keys[0], 0)
                    ^ torch.where(white64, keys[1], 0))
    return torch.where(to_move == env.WHITE, h ^ turn, h)


def _occupancy(states: env.EnvState):
    flat = lambda b: b.reshape(*b.shape[:-2], 64)  # noqa: E731
    return flat(u64.to_board(states.black)), flat(u64.to_board(states.white))


def hash_states(states: env.EnvState) -> torch.Tensor:
    """Zobrist hash of each state, int64 of the batch shape."""
    black64, white64 = _occupancy(states)
    return _hash_boards(black64, white64, states.to_move)


def symmetry_hashes(states: env.EnvState) -> torch.Tensor:
    """``[..., 8]`` int64: entry ``s`` hashes the position transformed by
    ``symmetry.PERMS[s]``."""
    black64, white64 = _occupancy(states)
    perms = _tables(black64.device)[2]
    return _hash_boards(black64[..., perms], white64[..., perms],
                        states.to_move[..., None])


def canonical_hash(states: env.EnvState) -> torch.Tensor:
    """The symmetry-invariant key: the least of the 8 symmetry hashes as
    unsigned 64-bit numbers (flipping the sign bit maps unsigned order onto
    int64 order)."""
    return (symmetry_hashes(states) ^ _SIGN).min(-1).values ^ _SIGN


# --------------------------------------------------------------- host form
_BIT = 1 << np.arange(64, dtype=np.uint64)


def hash_ints(black: int, white: int, to_move: int) -> int:
    """Zobrist hash of host bitboard ints (LSB-first square order)."""
    b = (np.uint64(black) & _BIT).astype(bool)
    w = (np.uint64(white) & _BIT).astype(bool)
    h = np.bitwise_xor.reduce(KEYS64[0][b]) if b.any() else np.uint64(0)
    h ^= np.bitwise_xor.reduce(KEYS64[1][w]) if w.any() else np.uint64(0)
    if to_move == env.WHITE:
        h ^= TURN64
    return int(h)


def transform_bits(bits: int, sym: int) -> int:
    """Dihedral transform of a 64-bit occupancy int: output square ``i``
    reads input square ``symmetry.PERMS[sym, i]``."""
    b = (np.uint64(bits) & _BIT).astype(bool)
    return int(_BIT[b[symmetry.PERMS[sym]]].sum(dtype=np.uint64))


def symmetry_hashes_ints(black: int, white: int, to_move: int) -> list:
    """All 8 dihedral hashes; index ``s`` hashes the ``PERMS[s]``-transformed
    position. ``min()`` of it is the canonical key."""
    return [hash_ints(transform_bits(black, s), transform_bits(white, s),
                      to_move)
            for s in range(symmetry.NUM_SYMS)]
