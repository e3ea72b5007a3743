"""The chip's peaks and the operation and byte counts the benchmark divides
by them.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 989e12 bf16 FLOP/s, 3.35e12
HBM bytes/s. A share is stated against them with the card's power limit
beside it.
"""
from __future__ import annotations

from reference.search import stage_levels

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def forward_flops(model: dict) -> int:
    """FLOPs of one position's forward pass (2 per multiply-add, the
    convolutions and dense layers; BatchNorm, activations and the softmax
    left out)."""
    n = model["board_size"]
    cells = n * n
    f = model["num_filters"]
    pc, vc = model["policy_head_channels"], model["value_head_channels"]
    hidden = model["value_head_hidden_size"]
    macs = cells * f * 3 * 9  # stem 3x3
    macs += model["num_res_blocks"] * 2 * cells * f * f * 9
    macs += cells * f * pc + pc * cells * (cells + 1)  # policy head
    macs += cells * f * vc + vc * cells * hidden + hidden  # value head
    return 2 * macs


def search_backup_bytes(games: int, simulations: int, leaf_batch: int,
                        max_depth: int, stages: int) -> int:
    """Least bytes that one search's backup launches (one a round) move:
    each round's path arrays read once, at 4 bytes a node, an action and a
    player for each of the ``leaf_batch * levels`` entries of a game; each
    lane's evaluated player, value, leaf node and leaf action (4 bytes
    each); a game's root player read and its visit count and value sum read
    and written. The rounds' ``levels`` are the search's depth stages. The
    edges that the paths touch are left out: how many there are depends on
    the paths, so the count is a floor."""
    rounds = simulations // leaf_batch
    cap = max(1, min(max_depth, simulations, 60))
    total = 0
    for start, end, levels in stage_levels(rounds, stages, cap):
        per_game = leaf_batch * levels * 12 + leaf_batch * 16 + 4 + 16
        total += (end - start) * games * per_game
    return total
