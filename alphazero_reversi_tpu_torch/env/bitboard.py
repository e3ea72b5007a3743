"""Batched 8x8 Reversi bitboard environment on tensors.

Port of ``alphazero_reversi_tpu/env/bitboard.py``: the same state, actions,
rules and outputs, in both rule modes. ``compat=False`` plays correct Othello
(edge-masked Dumb7Fill); ``compat=True`` replicates the reference engine's
three rule deviations bit for bit (edge-wrapping legal moves, flip-scan edge
masks keyed by ``abs(direction)``, zero-flip "valid" moves). Auto-pass and
double-pass termination, the pass action (64) and the invalid-action no-op
follow the JAX package exactly.

A bitboard is one int64 tensor (``ops.u64``). The eight ray directions are
processed together along a trailing axis of size 8, so a legal-move
generation costs about 36 tensor ops instead of 8x that: on the GPU each op
is a kernel launch, and launches, not bytes, bound this code at Reversi's
sizes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import u64

BOARD_SIZE = 8
NUM_SQUARES = 64
PASS_ACTION = 64
NUM_ACTIONS = 65

EMPTY = 0
BLACK = 1
WHITE = 2

INITIAL_BLACK = 0x0000000810000000
INITIAL_WHITE = 0x0000001008000000

NOT_FILE_A = 0xFEFEFEFEFEFEFEFE
NOT_FILE_H = 0x7F7F7F7F7F7F7F7F
FULL = 0xFFFFFFFFFFFFFFFF

# E=+1, W=-1, S=+8, N=-8, SE=+9, NW=-9, SW=+7, NE=-7 (bit = row*8 + col)
_DIRS = (1, -1, 8, -8, 9, -9, 7, -7)
_CORRECT_MASK = {1: NOT_FILE_A, -1: NOT_FILE_H, 8: FULL, -8: FULL,
                 9: NOT_FILE_A, -9: NOT_FILE_H, 7: NOT_FILE_H, -7: NOT_FILE_A}
# the reference's effective flip-scan masks (looked up by abs(direction))
_COMPAT_FLIP_MASK = {1: NOT_FILE_A, -1: NOT_FILE_A, 8: FULL, -8: FULL,
                     7: NOT_FILE_A, -7: NOT_FILE_A, 9: NOT_FILE_H,
                     -9: NOT_FILE_H}


class EnvState(NamedTuple):
    """Reversi game state; every field has the same batch shape."""

    black: torch.Tensor  # int64 bitboard
    white: torch.Tensor  # int64 bitboard
    to_move: torch.Tensor  # int32, BLACK (1) or WHITE (2)
    passed: torch.Tensor  # int32, consecutive passes
    done: torch.Tensor  # bool
    winner: torch.Tensor  # int32: 0 draw, BLACK, WHITE. Valid only when done.


class _Tables(NamedTuple):
    left: torch.Tensor  # [8] left-shift amount per direction (0 if right)
    right: torch.Tensor  # [8] right-shift amount per direction (0 if left)
    raw: torch.Tensor  # [8] clears the bits an arithmetic >> shifts in
    correct: torch.Tensor  # [8] raw & the direction's edge mask
    compat_flip: torch.Tensor  # [8] the reference's flip-scan masks


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
    right = [max(-d, 0) for d in _DIRS]
    raw = [u64.low_mask(64 - k) for k in right]
    t = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    return _Tables(
        left=t([max(d, 0) for d in _DIRS]),
        right=t(right),
        raw=t(raw),
        correct=t([u64.signed(_CORRECT_MASK[d]) & r
                   for d, r in zip(_DIRS, raw)]),
        compat_flip=t([u64.signed(_COMPAT_FLIP_MASK[d]) for d in _DIRS]),
    )


def _shift8(x: torch.Tensor, tb: _Tables, mask: torch.Tensor) -> torch.Tensor:
    """Shift ``x[..., j]`` along direction j (logically), then ``& mask[j]``."""
    return ((x << tb.left) >> tb.right) & mask


def _or8(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the trailing direction axis of size 8."""
    x = x[..., :4] | x[..., 4:]
    x = x[..., :2] | x[..., 2:]
    return x[..., 0] | x[..., 1]


def where_state(cond: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-game select between two states."""
    return EnvState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def initial_state(batch_shape: Tuple[int, ...] = (),
                  device=None) -> EnvState:
    """Fresh game(s) in the standard starting position."""
    return EnvState(
        black=u64.from_int(INITIAL_BLACK, batch_shape, device),
        white=u64.from_int(INITIAL_WHITE, batch_shape, device),
        to_move=torch.full(batch_shape, BLACK, dtype=torch.int32,
                           device=device),
        passed=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        done=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        winner=torch.zeros(batch_shape, dtype=torch.int32, device=device),
    )


def _player_boards(state: EnvState, player: torch.Tensor):
    is_black = player == BLACK
    mine = torch.where(is_black, state.black, state.white)
    theirs = torch.where(is_black, state.white, state.black)
    return mine, theirs


def _legal(mine: torch.Tensor, theirs: torch.Tensor, empty: torch.Tensor,
           compat: bool) -> torch.Tensor:
    """Legal-placement bitboard for the side owning ``mine``.

    ``compat=False``: masked Dumb7Fill. ``compat=True``: the reference's
    unmasked shift-propagate scan (1 seed + 5 propagate steps), which wraps
    across board edges."""
    tb = _tables(mine.device)
    mask = tb.raw if compat else tb.correct
    t8 = theirs.unsqueeze(-1)
    x = _shift8(mine.unsqueeze(-1), tb, mask) & t8
    for _ in range(5):
        x = x | (_shift8(x, tb, mask) & t8)
    return _or8(_shift8(x, tb, mask) & empty.unsqueeze(-1))


def legal_moves_bb(state: EnvState, player: Optional[torch.Tensor] = None,
                   compat: bool = False) -> torch.Tensor:
    """Bitboard of legal placements for ``player`` (default: side to move)."""
    if player is None:
        player = state.to_move
    mine, theirs = _player_boards(state, player)
    return _legal(mine, theirs, ~(state.black | state.white), compat)


def compute_flips(state: EnvState, move_bit: torch.Tensor,
                  player: Optional[torch.Tensor] = None,
                  compat: bool = False) -> torch.Tensor:
    """Bitboard of opponent stones flipped by playing ``move_bit``.

    ``compat=True`` replicates the reference's serial ray walk with its
    mis-keyed edge masks, including rays that wrap around the board."""
    if player is None:
        player = state.to_move
    mine, theirs = _player_boards(state, player)
    tb = _tables(move_bit.device)
    m8, t8 = mine.unsqueeze(-1), theirs.unsqueeze(-1)
    if not compat:
        x = _shift8(move_bit.unsqueeze(-1), tb, tb.correct) & t8
        for _ in range(5):
            x = x | (_shift8(x, tb, tb.correct) & t8)
        captures = (_shift8(x, tb, tb.correct) & m8) != 0
        return _or8(torch.where(captures, x, 0))
    # walk up to 7 raw shifts while landing on (opponent & emask); flip the
    # line iff the stopping square is (player & emask)
    emask = tb.compat_flip
    curr = move_bit.unsqueeze(-1).expand(*move_bit.shape, 8)
    line = torch.zeros_like(curr)
    stop = torch.zeros_like(curr)
    alive = torch.ones(curr.shape, dtype=torch.bool, device=curr.device)
    for _ in range(BOARD_SIZE - 1):
        curr = _shift8(curr, tb, tb.raw)
        on_opp = (curr & t8 & emask) != 0
        stop = torch.where(alive & ~on_opp, curr, stop)
        line = torch.where(alive & on_opp, line | curr, line)
        alive = alive & on_opp
    # a walk that never broke ended on an opponent stone: no capture
    stop = torch.where(alive, curr, stop)
    captures = (stop & m8 & emask) != 0
    return _or8(torch.where(captures, line, 0))


def _winner_from_counts(black: torch.Tensor, white: torch.Tensor
                        ) -> torch.Tensor:
    nb, nw = u64.popcount(black), u64.popcount(white)
    return (nb > nw).to(torch.int32) * BLACK + (nw > nb).to(torch.int32) * WHITE


def step(state: EnvState, action: torch.Tensor, compat: bool = False
         ) -> Tuple[EnvState, torch.Tensor]:
    """Apply ``action`` (0..63 = square, 64 = pass) for the side to move.

    Returns ``(new_state, valid)``. An invalid action (illegal square, pass
    while placements exist, or acting on a finished game) leaves the state
    unchanged and returns ``valid=False``.
    """
    action = action.to(torch.int32)
    player = state.to_move
    other = 3 - player
    legal_bb = legal_moves_bb(state, player, compat=compat)

    is_pass = action == PASS_ACTION
    move_bit = u64.bit_at(action.clamp(0, 63))
    on_legal = (move_bit & legal_bb) != 0
    valid = torch.where(is_pass, legal_bb == 0, on_legal) & ~state.done

    # placement branch
    flips = compute_flips(state, move_bit, player, compat=compat)
    placed = move_bit | flips
    is_black = player == BLACK
    new_black = torch.where(is_black, state.black ^ placed,
                            state.black ^ flips)
    new_white = torch.where(is_black, state.white ^ flips,
                            state.white ^ placed)
    # the opponent moves next; if they cannot, the turn passes back
    # (passed=1); if the mover cannot either, the game is over. Both
    # players' legal moves come from one stacked call.
    mine = torch.where(is_black, new_black, new_white)
    theirs = torch.where(is_black, new_white, new_black)
    has = _legal(torch.stack([theirs, mine]), torch.stack([mine, theirs]),
                 ~(new_black | new_white), compat) != 0
    opp_has, me_has = has[0], has[1]
    place_to_move = torch.where(opp_has, other, player)
    place_passed = (~opp_has).to(torch.int32)
    place_done = ~opp_has & ~me_has
    place_winner = torch.where(place_done,
                               _winner_from_counts(new_black, new_white), 0)

    # pass branch
    pass_passed = state.passed + 1
    pass_done = pass_passed >= 2
    pass_winner = torch.where(
        pass_done, _winner_from_counts(state.black, state.white), 0)

    new_state = EnvState(
        black=torch.where(is_pass, state.black, new_black),
        white=torch.where(is_pass, state.white, new_white),
        to_move=torch.where(is_pass, other, place_to_move).to(torch.int32),
        passed=torch.where(is_pass, pass_passed, place_passed).to(torch.int32),
        done=torch.where(is_pass, pass_done, place_done),
        winner=torch.where(is_pass, pass_winner, place_winner).to(torch.int32),
    )
    return where_state(valid, new_state, state), valid


def legal_action_mask(state: EnvState, compat: bool = False) -> torch.Tensor:
    """``[..., 65]`` bool mask over actions; pass (64) legal iff no placement."""
    bb = legal_moves_bb(state, compat=compat)
    board = u64.to_board(bb).reshape(*bb.shape, NUM_SQUARES)
    can_pass = ((bb == 0) & ~state.done).unsqueeze(-1)
    return torch.cat([board, can_pass], -1) & ~state.done.unsqueeze(-1)


def canonical_planes(state: EnvState, compat: bool = False) -> torch.Tensor:
    """NN input planes ``[..., 8, 8, 3]`` float32 (the JAX package's NHWC
    layout): mover's stones, opponent's stones, legal placements."""
    mine, theirs = _player_boards(state, state.to_move)
    legal = _legal(mine, theirs, ~(state.black | state.white), compat)
    planes = u64.to_board(torch.stack([mine, theirs, legal], -1)).float()
    return planes.movedim(-3, -1)


def score(state: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(black_count, white_count) as int32."""
    return u64.popcount(state.black), u64.popcount(state.white)


def terminal_value(state: EnvState, player: torch.Tensor) -> torch.Tensor:
    """Game outcome in [-1, 1] from ``player``'s perspective (0 if not done)."""
    decided = state.winner != 0
    win = (state.winner == player) & decided
    lose = (state.winner == 3 - player) & decided
    val = win.to(torch.float32) - lose.to(torch.float32)
    return torch.where(state.done, val, 0.0)
