"""Packed array tree for batched MCTS.

Port of ``alphazero_reversi_tpu/mcts/tree.py`` with the layout kept cell for
cell, so trees compare exactly across the two packages:

* ``rows[B, N, K]`` f32: the sign-encoded prior (``prior`` where legal,
  ``-1`` where illegal), then the node's env state, then its raw NN value.
  The bitboards ride in the float row as bit-cast 32-bit words (hi, lo).
  Some words are NaN or denormal bit patterns, so every op applied to rows
  must be a pure copy (cat, index, gather, ``torch.where``), never arithmetic.
* ``stats[B, N * STRIDE]`` f32: per node ``PACK * visits + child_slot`` for
  each action, then the value sums. A visit adds ``PACK``; linking a child
  adds its slot once; so one backup+link call updates both.
* Static slot allocation: simulation ``i`` writes node slot ``i + 1``.

Values in ``vsum[n, a]`` are from the perspective of the player to move at
node ``n``. Unlike the JAX package, trees are updated in place where that
saves a copy (``init_root``, ``write_children_rows``, ``backup_and_link``,
``round_backup``, ``seed_root_stats``); each says so.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..env import bitboard as env
from ..env.bitboard import EnvState
from ..ops import u64
from . import cuda_backup

NUM_ACTIONS = env.NUM_ACTIONS
A = NUM_ACTIONS

PRIOR = slice(0, A)
S_BLACK_HI = A
S_BLACK_LO = A + 1
S_WHITE_HI = A + 2
S_WHITE_LO = A + 3
S_TO_MOVE = A + 4
S_PASSED = A + 5
S_DONE = A + 6
S_WINNER = A + 7
S_VALUE = A + 8
K = A + 9  # row width

STRIDE = cuda_backup.STRIDE
VISITS_OFF = cuda_backup.VISITS_OFF
VSUM_OFF = cuda_backup.VSUM_OFF
PACK = cuda_backup.PACK


def unpack_visits_child(packed: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """packed f32 -> (visits f32, child_slot f32), both integer-valued."""
    visits = torch.floor(packed * (1.0 / PACK))
    return visits, packed - visits * PACK


class Tree(NamedTuple):
    """Batched packed search tree: ``B`` games, ``N`` node slots."""

    rows: torch.Tensor  # [B, N, K] f32
    stats: torch.Tensor  # [B, N * STRIDE] f32
    root_visit: torch.Tensor  # [B] i32
    root_vsum: torch.Tensor  # [B] f32


def make_tree(batch: int, capacity: int, device=None) -> Tree:
    if capacity >= PACK:
        raise ValueError("node slots must pack below the visit base")
    z = torch.zeros
    return Tree(rows=z((batch, capacity, K), device=device),
                stats=z((batch, capacity * STRIDE), device=device),
                root_visit=z((batch,), dtype=torch.int32, device=device),
                root_vsum=z((batch,), device=device))


def pack_state(state: EnvState) -> torch.Tensor:
    """EnvState[...] -> [..., 8] f32 row segment (bitboards bit-cast)."""
    bh, bl = u64.split_words(state.black)
    wh, wl = u64.split_words(state.white)
    words = torch.stack([bh, bl, wh, wl], -1).view(torch.float32)
    small = torch.stack([state.to_move.float(), state.passed.float(),
                         state.done.float(), state.winner.float()], -1)
    return torch.cat([words, small], -1)


def unpack_state(cols: torch.Tensor) -> EnvState:
    """[..., 8] f32 row segment -> EnvState with [...]-shaped fields."""
    words = cols[..., :4].view(torch.int32)
    return EnvState(
        black=u64.join_words(words[..., 0], words[..., 1]),
        white=u64.join_words(words[..., 2], words[..., 3]),
        to_move=cols[..., 4].to(torch.int32),
        passed=cols[..., 5].to(torch.int32),
        done=cols[..., 6] > 0.5,
        winner=cols[..., 7].to(torch.int32),
    )


def make_row(state: EnvState, prior: torch.Tensor, legal: torch.Tensor,
             value: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed rows [..., K]: sign-encoded prior, env state, raw value."""
    signed = torch.where(legal, prior, -1.0)
    if value is None:
        value = torch.zeros(signed.shape[:-1], device=signed.device)
    return torch.cat([signed, pack_state(state), value.unsqueeze(-1)], -1)


def decode_prior_legal(row: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """row [..., K] -> (prior [..., A] f32, legal [..., A] bool)."""
    signed = row[..., PRIOR]
    return signed.clamp_min(0.0), signed >= 0.0


def init_root(tree: Tree, root_state: EnvState, prior: torch.Tensor,
              legal: torch.Tensor, value: Optional[torch.Tensor] = None
              ) -> Tree:
    """Install the root at slot 0 (in place)."""
    tree.rows[:, 0, :] = make_row(root_state, prior, legal, value)
    return tree


def write_children_rows(tree: Tree, slot: int, new_rows: torch.Tensor
                        ) -> Tree:
    """Write ``new_rows`` [B, L, K] at the shared slots ``slot .. slot+L-1``
    (in place)."""
    tree.rows[:, slot:slot + new_rows.shape[1], :] = new_rows
    return tree


def backup_and_link(tree: Tree, nodes: torch.Tensor, actions: torch.Tensor,
                    value_incs: torch.Tensor, link_nodes: torch.Tensor,
                    link_actions: torch.Tensor, link_slots: torch.Tensor,
                    do_link: torch.Tensor) -> Tree:
    """Whole-round backup plus child linking, in place on ``tree.stats``.

    ``nodes``/``actions``/``value_incs`` are ``[B, P]``: every path entry of
    the round's descents (``node < 0`` entries are skipped). Each entry adds
    ``PACK`` to its packed visits|child cell and ``value_inc`` to its vsum
    cell. ``link_*``/``do_link`` are ``[B, L]``: each freshly expanded leaf
    adds its slot once to its parent edge's packed cell (the caller dedups
    in-round duplicates). CUDA tensors go through the hand-written kernel
    (``cuda_backup``); CPU tensors through its plain version.
    """
    def c(t, dtype):
        return t.to(dtype).contiguous()

    cuda_backup.backup_and_link(
        tree.stats, c(nodes, torch.int32), c(actions, torch.int32),
        c(value_incs, torch.float32), c(link_nodes, torch.int32),
        c(link_actions, torch.int32), c(link_slots, torch.int32),
        c(do_link, torch.bool))
    return tree


def round_backup(tree: Tree, pn: torch.Tensor, pa: torch.Tensor,
                 pt: torch.Tensor, eval_tomove: torch.Tensor,
                 value: torch.Tensor, leaves: torch.Tensor,
                 leaf_acts: torch.Tensor, slot0: int,
                 root_to_move: torch.Tensor) -> Tree:
    """A simulation round's whole backup, in place on ``tree.stats``,
    ``tree.root_visit`` and ``tree.root_vsum``.

    ``pn``/``pa``/``pt`` are the ``[B, L*levels]`` lane-major path arrays
    (node int64 / action int64 / to-move f32 per level, ``node < 0`` on
    padding); ``eval_tomove`` (int32) and ``value`` (f32) are each lane's
    evaluated to-move and value, ``leaves``/``leaf_acts`` (int64) its leaf
    edge (``leaf_act < 0``: no expansion), all ``[B, L]``. Each path entry
    backs up ``±value`` (sign: its level's to-move against the evaluated
    one), each expanded lane ``l`` links slot ``slot0 + l`` unless an
    earlier lane picked the same edge, and the root counts ``L`` visits.
    CUDA tensors take one launch of the hand-written kernel
    (``cuda_backup.round_backup``); CPU tensors its plain version.
    """
    cuda_backup.round_backup(tree.stats, pn, pa, pt, eval_tomove, value,
                             leaves, leaf_acts, slot0, root_to_move,
                             tree.root_visit, tree.root_vsum)
    return tree


def gather_node(tree: Tree, node: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-game node fetch, ``node`` [B, ...] -> (rows [B, ..., K],
    stats rows [B, ..., STRIDE])."""
    b = tree.rows.shape[0]
    bidx = torch.arange(b, device=node.device).view(
        b, *([1] * (node.dim() - 1)))
    stats3 = tree.stats.view(b, -1, STRIDE)
    return tree.rows[bidx, node], stats3[bidx, node]


def _pick(x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    return x.gather(-1, action.long().unsqueeze(-1)).squeeze(-1)


def root_child_warm_stats(tree: Tree, action: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge statistics ``(visits [B, A], vsum [B, A])`` of the root's child
    reached by ``action``, child links stripped: the 1-level tree-reuse
    carry. Games whose played action has no expanded child get zeros."""
    child = unpack_visits_child(tree.stats[:, VISITS_OFF:VISITS_OFF + A])[1]
    c1 = _pick(child, action).to(torch.int64)
    _, srow = gather_node(tree, c1)
    visits = torch.floor(srow[:, VISITS_OFF:VISITS_OFF + A] * (1.0 / PACK))
    vsum = srow[:, VSUM_OFF:VSUM_OFF + A]
    ok = (c1 > 0).unsqueeze(-1)
    return torch.where(ok, visits, 0.0), torch.where(ok, vsum, 0.0)


def warm_stats_after(stats: torch.Tensor, a_self: torch.Tensor,
                     a_opp: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warm root-edge statistics ``(visits [n, A], vsum [n, A])`` after a
    1- or 2-ply descent from a finished search's ``stats`` [n, N * STRIDE]:
    the match-play (arena) form of ``root_child_warm_stats``.

    In alternating play a side's next search roots at the grandchild of its
    previous root: its own move ``a_self``, then the opponent's reply
    ``a_opp``. ``a_opp < 0`` (the opponent auto-passed) descends one level
    only. ``a_self < 0`` (no previous search, or an invalidated carry) and
    missing children give zeros: a cold search. Child links are stripped as
    in ``root_child_warm_stats``.
    """
    n = stats.shape[0]
    stats3 = stats.reshape(n, -1, STRIDE)
    rows = torch.arange(n, device=stats.device)

    def pick_child(packed_row: torch.Tensor, action: torch.Tensor
                   ) -> torch.Tensor:
        child = unpack_visits_child(packed_row)[1]
        return _pick(child, action.clamp_min(0)).to(torch.int64)

    c1 = pick_child(stats3[:, 0, VISITS_OFF:VISITS_OFF + A], a_self)
    c2 = pick_child(stats3[rows, c1, VISITS_OFF:VISITS_OFF + A], a_opp)
    use2 = a_opp >= 0
    rowc = stats3[rows, torch.where(use2, c2, c1)]
    visits = torch.floor(rowc[:, VISITS_OFF:VISITS_OFF + A] * (1.0 / PACK))
    vsum = rowc[:, VSUM_OFF:VSUM_OFF + A]
    ok = ((a_self >= 0) & (c1 > 0) & (~use2 | (c2 > 0))).unsqueeze(-1)
    return torch.where(ok, visits, 0.0), torch.where(ok, vsum, 0.0)


def discount_warm(warm_visits: torch.Tensor, warm_vsum: torch.Tensor,
                  discount: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale a warm pair's weight while preserving its per-edge Q; visits
    round to integers (the packed cell is exact only for integral counts)."""
    wv = warm_visits.clamp_min(0.0)
    scaled = torch.round(wv * discount)
    q = warm_vsum / wv.clamp_min(1.0)
    return scaled, q * scaled


def seed_root_stats(tree: Tree, warm_visits: torch.Tensor,
                    warm_vsum: torch.Tensor, legal: torch.Tensor) -> Tree:
    """Install warm edge statistics at the root's stats row (in place).
    Child-slot fields start at 0: warm edges look explored but unexpanded."""
    wv = torch.where(legal, warm_visits.clamp_min(0.0), 0.0)
    ws = torch.where(legal, warm_vsum, 0.0)
    tree.stats[:, VISITS_OFF:VISITS_OFF + A] = wv * PACK
    tree.stats[:, VSUM_OFF:VSUM_OFF + A] = ws
    return tree._replace(root_visit=wv.sum(-1).to(torch.int32),
                         root_vsum=ws.sum(-1))


def root_visit_counts(tree: Tree) -> torch.Tensor:
    """[B, A] int32 root child visit counts."""
    packed = tree.stats[:, VISITS_OFF:VISITS_OFF + A]
    return unpack_visits_child(packed)[0].to(torch.int32)


def root_value(tree: Tree) -> torch.Tensor:
    """[B] mean root value (root player's POV)."""
    return tree.root_vsum / tree.root_visit.clamp_min(1)


def _packed_plane(tree: Tree) -> torch.Tensor:
    b = tree.stats.shape[0]
    return tree.stats.view(b, -1, STRIDE)[:, :, VISITS_OFF:VISITS_OFF + A]


def children_index(tree: Tree) -> torch.Tensor:
    """[B, N, A] int32 child slot per edge (0 = no child)."""
    return unpack_visits_child(_packed_plane(tree))[1].to(torch.int32)


def visit_counts(tree: Tree) -> torch.Tensor:
    """[B, N, A] int32 per-edge visit counts."""
    return unpack_visits_child(_packed_plane(tree))[0].to(torch.int32)
