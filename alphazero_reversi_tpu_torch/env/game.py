"""Host objects over the env: a mutable single-game ``Board`` and
``ReversiGame`` with move history.

Port of ``alphazero_reversi_tpu/env/game.py`` (the same methods, return
conventions and printed board). These are the user's mutable host state for
interactive play (``cli analyze`` and ``play``), not a search entry point:
the board is a batch-1 ``EnvState`` held on the CPU, which
``search.MCTS.get_action_probs`` takes as is and copies to its own device.
Bitboards are read and written as unsigned Python ints.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import u64
from . import bitboard as env

EMPTY = env.EMPTY
BLACK = env.BLACK
WHITE = env.WHITE
_MASK64 = (1 << 64) - 1


class Board:
    """Single mutable board. ``compat=True`` plays the reference engine's
    rule quirks; the default is correct Othello."""

    EMPTY = env.EMPTY
    BLACK = env.BLACK
    WHITE = env.WHITE

    def __init__(self, size: int = 8, compat: bool = False):
        if size != 8:
            raise ValueError("bitboard engine supports 8x8 only")
        self.size = size
        self.compat = compat
        self._state = env.initial_state((1,))
        self.current_player = BLACK

    # -- state views -------------------------------------------------------
    @property
    def state(self) -> env.EnvState:
        """The position as a batch-1 ``EnvState`` on the CPU."""
        return self._state

    @property
    def black(self) -> int:
        return int(self._state.black[0]) & _MASK64

    @black.setter
    def black(self, value: int) -> None:
        self._state = self._state._replace(black=u64.from_int(value, (1,)))

    @property
    def white(self) -> int:
        return int(self._state.white[0]) & _MASK64

    @white.setter
    def white(self, value: int) -> None:
        self._state = self._state._replace(white=u64.from_int(value, (1,)))

    @property
    def game_over(self) -> bool:
        return bool(self._state.done[0])

    @property
    def winner(self) -> Optional[int]:
        """BLACK/WHITE, 0 for a draw, None while the game runs."""
        if not self.game_over:
            return None
        return int(self._state.winner[0])

    def get_board_state(self) -> np.ndarray:
        """``[8, 8]`` int32 array of EMPTY/BLACK/WHITE."""
        b = u64.to_board(self._state.black[0])
        w = u64.to_board(self._state.white[0])
        return torch.where(b, BLACK, torch.where(w, WHITE, EMPTY)) \
            .to(torch.int32).numpy()

    def get_score(self) -> Tuple[int, int]:
        """(black_count, white_count)."""
        nb, nw = env.score(self._state)
        return int(nb[0]), int(nw[0])

    # -- rules -------------------------------------------------------------
    def get_valid_moves(self, player: Optional[int] = None
                        ) -> List[Tuple[int, int]]:
        """List of (row, col) placements for ``player`` (default: the side
        to move)."""
        p = torch.tensor([player if player is not None
                          else self.current_player], dtype=torch.int32)
        bits = int(env.legal_moves_bb(self._state, p, compat=self.compat)[0])
        return [(i // 8, i % 8) for i in range(64) if (bits >> i) & 1]

    def is_valid_move(self, row: int, col: int,
                      player: Optional[int] = None) -> bool:
        return (row, col) in self.get_valid_moves(player)

    def make_move(self, row: int, col: int,
                  player: Optional[int] = None) -> bool:
        """Apply a placement, or a pass with ``(row, col) == (-1, -1)``.
        Auto-pass and termination update ``current_player``, ``game_over``
        and ``winner``. Returns False on an illegal move, leaving the state
        unchanged."""
        p = player if player is not None else self.current_player
        if p != int(self._state.to_move[0]):
            return False
        action = env.PASS_ACTION if (row, col) == (-1, -1) else row * 8 + col
        new_state, valid = env.step(
            self._state, torch.tensor([action], dtype=torch.int32),
            compat=self.compat)
        if not bool(valid[0]):
            return False
        self._state = new_state
        self.current_player = int(new_state.to_move[0])
        return True

    def copy(self) -> "Board":
        """Deep copy (the state tensors are never written in place)."""
        b = Board(self.size, self.compat)
        b._state = self._state
        b.current_player = self.current_player
        return b

    def __str__(self) -> str:
        """ASCII board: X=black, O=white, .=empty, with a1-style axes."""
        grid = self.get_board_state()
        rows = ["  " + " ".join(chr(ord("a") + c) for c in range(self.size))]
        for r in range(self.size):
            cells = " ".join({1: "X", 2: "O", 0: "."}.get(int(v), "?")
                             for v in grid[r])
            rows.append(f"{r + 1} {cells}")
        nb, nw = self.get_score()
        mover = "black (X)" if self.current_player == 1 else "white (O)"
        rows.append(f"X {nb} - O {nw}, {mover} to move")
        return "\n".join(rows)


class ReversiGame:
    """Game flow with move history over a ``Board``."""

    def __init__(self, size: int = 8, compat: bool = False):
        self.size = size
        self.compat = compat
        self.board = Board(size, compat)
        self.move_history: List[Dict] = []

    @property
    def current_player(self) -> int:
        return self.board.current_player

    @property
    def game_over(self) -> bool:
        return self.board.game_over

    @property
    def winner(self) -> Optional[int]:
        return self.board.winner

    def reset(self) -> None:
        self.board = Board(self.size, self.compat)
        self.move_history = []

    def make_move(self, row: int, col: int) -> bool:
        """Play a move for the side to move, recording the boards before
        and after it in ``move_history``."""
        if self.game_over:
            return False
        before = self.board.copy()
        player = self.current_player
        if not self.board.make_move(row, col, player):
            return False
        self.move_history.append({
            "player": player,
            "move": (row, col),
            "board_before": before,
            "board_after": self.board.copy(),
        })
        return True

    def get_valid_moves(self) -> List[Tuple[int, int]]:
        return self.board.get_valid_moves()

    def is_game_over(self) -> bool:
        return self.game_over

    def get_winner(self) -> Optional[int]:
        return self.winner

    def get_score(self) -> Tuple[int, int]:
        return self.board.get_score()

    def get_board_state(self) -> np.ndarray:
        return self.board.get_board_state()

    def get_canonical_state(self) -> np.ndarray:
        """``[3, 8, 8]`` float32 planes from the side to move's view (own
        stones, opponent stones, legal moves), channels first."""
        planes = env.canonical_planes(self.board.state, compat=self.compat)
        return planes[0].permute(2, 0, 1).numpy()

    def copy(self) -> "ReversiGame":
        g = ReversiGame(self.size, self.compat)
        g.board = self.board.copy()
        g.move_history = list(self.move_history)
        return g

    def get_zobrist_hash(self) -> int:
        """The position's Zobrist hash (``zobrist.hash_ints``)."""
        from .. import zobrist

        return zobrist.hash_ints(self.board.black, self.board.white,
                                 self.current_player)

    def get_symmetry_hashes(self) -> List[int]:
        """Hashes of the 8 dihedral variants of the position."""
        from .. import zobrist

        return zobrist.symmetry_hashes_ints(self.board.black,
                                            self.board.white,
                                            self.current_player)
