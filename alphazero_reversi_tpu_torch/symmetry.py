"""Dihedral-8 board symmetries: training-data augmentation.

Port of ``alphazero_reversi_tpu/symmetry.py``. Each sampled position is
transformed by a random element of D4 (4 rotations x optional reflection),
a gather over ``[B, 64]`` index rows. Augmentation assumes the rules are
equivariant under D4, which holds for correct Othello but not for the
``compat`` rules, so it is opt-in (``TrainingConfig.augment_symmetries``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

NUM_SYMS = 8


def _build_perms() -> np.ndarray:
    """``PERMS[s, i] = j``: output cell ``i`` of symmetry ``s`` reads input
    cell ``j``. Cell index = row * 8 + col (the env's LSB-first order).
    Symmetries: s = 4 * flip + k == fliplr^flip then rot90^k applied to the
    8x8 index grid."""
    idx = np.arange(64).reshape(8, 8)
    mats = []
    for flip in (False, True):
        base = np.fliplr(idx) if flip else idx
        for k in range(4):
            mats.append(np.rot90(base, k))
    return np.stack([m.reshape(64) for m in mats]).astype(np.int32)


PERMS = _build_perms()  # [8, 64]

# INVERSE[s] = s' with perm[s'] o perm[s] == identity
INVERSE = np.asarray(
    [int(np.nonzero([np.array_equal(PERMS[t][PERMS[s]], np.arange(64))
                     for t in range(NUM_SYMS)])[0][0])
     for s in range(NUM_SYMS)], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _perms_on(device: torch.device) -> torch.Tensor:
    # one copy per device: a host-to-card copy per call would sync
    return torch.from_numpy(PERMS).long().to(device)


def _perm_rows(sym: torch.Tensor) -> torch.Tensor:
    return _perms_on(sym.device).index_select(0, sym.long())


def apply_to_planes(planes: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Transform NN input planes ``[B, 8, 8, C]`` by per-sample symmetry
    ``sym`` ``[B]`` in [0, 8)."""
    b, c = planes.shape[0], planes.shape[-1]
    perm = _perm_rows(sym)[..., None].expand(b, 64, c)
    return planes.reshape(b, 64, c).gather(1, perm).reshape(b, 8, 8, c)


def apply_to_policy(policy: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Transform a 65-way policy ``[B, 65]`` (64 squares + pass; pass is
    symmetry-invariant) by per-sample symmetry ``sym`` ``[B]``."""
    board = policy[:, :64].gather(1, _perm_rows(sym))
    return torch.cat([board, policy[:, 64:]], 1)


def apply_to_mask(mask: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Transform a boolean/int cell mask ``[B, 64]``."""
    return mask.gather(1, _perm_rows(sym))


def random_syms(generator: Optional[torch.Generator], batch: int,
                device=None) -> torch.Tensor:
    return torch.randint(0, NUM_SYMS, (batch,), generator=generator,
                         device=device, dtype=torch.int32)


def augment(generator: Optional[torch.Generator], planes: torch.Tensor,
            policy: torch.Tensor, sym: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random per-sample dihedral transform of (planes, policy targets);
    ``sym`` ``[B]`` replaces the draw from ``generator``."""
    if sym is None:
        sym = random_syms(generator, planes.shape[0], planes.device)
    return apply_to_planes(planes, sym), apply_to_policy(policy, sym)
