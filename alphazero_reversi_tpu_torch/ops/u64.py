"""64-bit bitboards as int64 tensors.

The JAX package keeps a bitboard as a pair of uint32 words
(``alphazero_reversi_tpu/ops/u64.py``) because the TPU has no 64-bit ALU.
PyTorch has int64 on both the CPU and CUDA, so here a bitboard is ONE int64
tensor holding the same 64 bits (bit ``i = row * 8 + col``, LSB-first).

Hazards of signed words, and how each helper handles them:

* ``>>`` on int64 is arithmetic (it copies the sign bit), so every right
  shift is followed by a mask that clears the bits shifted in
  (``low_mask``; the env folds it into its edge masks).
* Constants at or above 2**63 (``NOT_FILE_A``, ``FULL``) do not fit a signed
  int64 literal; ``signed`` maps them to the int64 with the same bits.
* ``<<`` and ``*`` wrap modulo 2**64, which is what bitboards want.
* There is no popcount op: ``popcount`` is the SWAR reduction, whose final
  multiply wraps and whose ``>> 56`` is masked.
"""
from __future__ import annotations

import torch

_U64 = 1 << 64


def signed(value: int) -> int:
    """The int64 value with the same 64 bits as the unsigned ``value``."""
    value &= _U64 - 1
    return value - _U64 if value >= 1 << 63 else value


def low_mask(bits: int) -> int:
    """int64 with the low ``bits`` bits set (0 <= bits <= 64)."""
    return signed((1 << bits) - 1)


def from_int(value: int, shape=(), device=None) -> torch.Tensor:
    return torch.full(shape, signed(value), dtype=torch.int64, device=device)


_M1 = signed(0x5555555555555555)
_M2 = signed(0x3333333333333333)
_M4 = signed(0x0F0F0F0F0F0F0F0F)
_H01 = signed(0x0101010101010101)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits, as int32 (SWAR)."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * _H01) >> 56).bitwise_and_(0xFF).to(torch.int32)


def bit_at(index: torch.Tensor) -> torch.Tensor:
    """Single set bit at position ``index`` in [0, 64)."""
    return torch.ones_like(index, dtype=torch.int64) << index.to(torch.int64)


def to_board(x: torch.Tensor) -> torch.Tensor:
    """Expand to an ``[..., 8, 8]`` bool board: ``out[..., r, c]`` = bit r*8+c."""
    shifts = torch.arange(64, device=x.device)
    return ((x.unsqueeze(-1) >> shifts) & 1).bool().reshape(*x.shape, 8, 8)


def split_words(x: torch.Tensor):
    """int64 -> (hi, lo) int32 words holding the same bits."""
    hi = (x >> 32).to(torch.int32)
    lo = ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    return hi, lo.to(torch.int32)


def join_words(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_words`."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
