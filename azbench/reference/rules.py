"""Plain 8x8 Othello rules on numpy ``uint64`` bitboards, vectorised over games.

The benchmark's own rules: they draw the start positions and judge every move
that self-play records. Bit ``r * 8 + c`` is square (r, c). A state is a dict
of arrays with one entry per game:

* ``black``, ``white``: ``uint64`` stones;
* ``to_move``: 1 (black) or 2 (white);
* ``passed``: 1 when the side now to move got the turn back because its
  opponent had no placement, else 0;
* ``done``: neither side can place; ``winner``: 0 (draw), 1 or 2 when done.

After a placement the opponent moves if it can place; otherwise the mover
moves again (``passed`` 1); if neither can, the game is over. Action 64
(pass) is legal only when the mover has no placement. Nothing here imports
the program.
"""
from __future__ import annotations

import numpy as np

U64 = np.uint64
PASS = 64
_FILE_A_CLEAR = U64(0xFEFEFEFEFEFEFEFE)  # no stone may arrive on column 0
_FILE_H_CLEAR = U64(0x7F7F7F7F7F7F7F7F)  # ... nor on column 7
_ALL = U64(0xFFFFFFFFFFFFFFFF)
# (shift, mask applied after it): a positive shift moves towards higher bits
_DIRECTIONS = ((1, _FILE_A_CLEAR), (-1, _FILE_H_CLEAR), (8, _ALL),
               (-8, _ALL), (9, _FILE_A_CLEAR), (-9, _FILE_H_CLEAR),
               (7, _FILE_H_CLEAR), (-7, _FILE_A_CLEAR))
INITIAL_BLACK = 0x0000000810000000
INITIAL_WHITE = 0x0000001008000000
_BITS = np.left_shift(U64(1), np.arange(64, dtype=np.uint64))


def _shift(x: np.ndarray, k: int, mask: np.uint64) -> np.ndarray:
    if k > 0:
        return np.left_shift(x, U64(k)) & mask
    return np.right_shift(x, U64(-k)) & mask


def placements(mine: np.ndarray, theirs: np.ndarray) -> np.ndarray:
    """Squares where the owner of ``mine`` may place."""
    empty = ~(mine | theirs)
    moves = np.zeros_like(mine)
    for k, mask in _DIRECTIONS:
        run = _shift(mine, k, mask) & theirs
        for _ in range(5):
            run |= _shift(run, k, mask) & theirs
        moves |= _shift(run, k, mask) & empty
    return moves


def flipped(mine: np.ndarray, theirs: np.ndarray, move: np.ndarray
            ) -> np.ndarray:
    """Opponent stones that placing the single-bit ``move`` turns over."""
    out = np.zeros_like(mine)
    for k, mask in _DIRECTIONS:
        run = _shift(move, k, mask) & theirs
        for _ in range(5):
            run |= _shift(run, k, mask) & theirs
        closed = (_shift(run, k, mask) & mine) != 0
        out |= np.where(closed, run, U64(0))
    return out


def popcount(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8)
                         .reshape(*x.shape, 8), axis=-1).sum(-1)


def bits_of(x: np.ndarray) -> np.ndarray:
    """``[..., 64]`` bool: square i of each bitboard."""
    return (x[..., None] & _BITS) != 0


def initial(n: int) -> dict:
    return dict(black=np.full(n, INITIAL_BLACK, U64),
                white=np.full(n, INITIAL_WHITE, U64),
                to_move=np.ones(n, np.int64), passed=np.zeros(n, np.int64),
                done=np.zeros(n, bool), winner=np.zeros(n, np.int64))


def sides(s: dict):
    black_moves = s["to_move"] == 1
    mine = np.where(black_moves, s["black"], s["white"])
    theirs = np.where(black_moves, s["white"], s["black"])
    return mine, theirs


def _count_winner(black, white):
    nb, nw = popcount(black), popcount(white)
    return np.where(nb > nw, 1, np.where(nw > nb, 2, 0))


def legal_mask(s: dict) -> np.ndarray:
    """``[n, 65]`` bool: legal actions of the side to move (none when done)."""
    mine, theirs = sides(s)
    moves = placements(mine, theirs)
    mask = np.concatenate([bits_of(moves), (moves == 0)[:, None]], -1)
    return mask & ~s["done"][:, None]


def step(s: dict, action: np.ndarray) -> dict:
    """The state after each game's ``action`` (which must be legal)."""
    action = np.asarray(action, np.int64)
    mover = s["to_move"]
    mine, theirs = sides(s)
    is_pass = action == PASS
    move = np.where(is_pass, U64(0),
                    np.left_shift(U64(1), np.clip(action, 0, 63)
                                  .astype(np.uint64)))
    flips = flipped(mine, theirs, move)
    mine2 = mine | move | flips
    theirs2 = theirs & ~flips
    opp_can = placements(theirs2, mine2) != 0
    me_can = placements(mine2, theirs2) != 0
    black2 = np.where(mover == 1, mine2, theirs2)
    white2 = np.where(mover == 1, theirs2, mine2)
    over = ~opp_can & ~me_can
    placed = dict(
        black=black2, white=white2,
        to_move=np.where(opp_can, 3 - mover, mover),
        passed=(~opp_can).astype(np.int64), done=over,
        winner=np.where(over, _count_winner(black2, white2), 0))
    passed = s["passed"] + 1
    pass_over = passed >= 2
    passing = dict(
        black=s["black"], white=s["white"], to_move=3 - mover, passed=passed,
        done=pass_over,
        winner=np.where(pass_over, _count_winner(s["black"], s["white"]), 0))
    return {k: np.where(is_pass, passing[k], placed[k]) for k in placed}


def planes(s: dict) -> np.ndarray:
    """``[n, 8, 8, 3]`` float32 net input: the mover's stones, the
    opponent's, the mover's placements."""
    mine, theirs = sides(s)
    stack = np.stack([mine, theirs, placements(mine, theirs)], -1)
    return bits_of(stack).reshape(-1, 3, 8, 8).transpose(0, 2, 3, 1) \
        .astype(np.float32)


def outcome(final: dict, to_move: np.ndarray) -> np.ndarray:
    """Result in {-1, 0, 1} for ``to_move`` from a final state; a game still
    live is scored by its stones."""
    winner = np.where(final["done"], final["winner"],
                      _count_winner(final["black"], final["white"]))
    return (winner == to_move).astype(np.float32) \
        - (winner == 3 - to_move).astype(np.float32)


def play_random(plies: np.ndarray, rng: np.random.Generator) -> dict:
    """Games played from the start by uniformly random legal placements,
    game i for ``plies[i]`` plies (fewer where it ended)."""
    n = len(plies)
    s = initial(n)
    for ply in range(int(plies.max(initial=0))):
        go = (ply < plies) & ~s["done"]
        if not go.any():
            break
        mask = legal_mask(s)[:, :64]
        pick = (rng.random(n) * np.maximum(mask.sum(-1), 1)).astype(np.int64)
        action = np.argmax(np.cumsum(mask, -1) > pick[:, None], -1)
        moved = step(s, action)
        s = {k: np.where(go, moved[k], s[k]) for k in s}
    return s


def symmetric(s: dict, k: int) -> dict:
    """The states under the k-th of the board's 8 symmetries (k // 2
    quarter turns, then a mirror when k is odd); the rules commute with
    them."""
    def turn(x):
        b = bits_of(x).reshape(-1, 8, 8)
        b = np.rot90(b, k // 2, axes=(1, 2))
        if k % 2:
            b = b[:, :, ::-1]
        return np.bitwise_or.reduce(
            np.where(b.reshape(-1, 64), _BITS, U64(0)), axis=-1)
    return dict(s, black=turn(s["black"]), white=turn(s["white"]))
