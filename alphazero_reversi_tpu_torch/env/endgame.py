"""Exact endgame solver binding (``native/solver.cpp``, host C++).

The port's copy of ``alphazero_reversi_tpu/env/endgame.py``: fail-soft
alpha-beta over the final disc differential with a shared lockless
transposition table, in both rule modes. The library is the port's own
build of its copy of the solver sources (``kernels.build.load_solver``:
host C++ compiler, ``kernels/_build/``); a missing compiler or a failed
build raises.

``solve_wdl_batch`` fans a batch of win/draw/loss probes out over a native
thread pool (ctypes releases the GIL); it is the exact-value relabel's
solver (``selfplay.relabel_packed_np``). Bitboards may be given as unsigned
or as the port's int64 words: only their 64 bits matter.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..kernels import build

MODE_CORRECT = 0
MODE_COMPAT = 1
PASS_ACTION = 64
_MASK64 = (1 << 64) - 1


class SolveResult(NamedTuple):
    """Exact solve outcome, from the MOVER's perspective.

    value: final disc differential (mover - opponent) under optimal play,
        in [-64, 64]; when solved with a narrowed (alpha, beta) window this
        is a fail-soft bound, exact only inside the window.
    best_move: optimal square 0..63, 64 when the mover must pass, -1 at a
        terminal position.
    nodes: solver nodes visited (for benchmarks/diagnostics).
    """

    value: int
    best_move: int
    nodes: int


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The solver library (built at first use) with its prototypes."""
    lib = build.load_solver()
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.solver_solve.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, u64p]
    lib.solver_solve.restype = ctypes.c_int32
    lib.solver_clear.argtypes = []
    lib.solver_clear.restype = None
    lib.solver_solve_batch.argtypes = [
        ctypes.c_int32, u64p, u64p, i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, i32p,
        ctypes.POINTER(ctypes.c_uint8), u64p]
    lib.solver_solve_batch.restype = ctypes.c_int32
    return lib


def count_empties(black: int, white: int) -> int:
    return 64 - bin((black | white) & _MASK64).count("1")


def _u64_array(x: np.ndarray) -> np.ndarray:
    """Contiguous uint64 words with the same bits (int64 is reinterpreted,
    not converted)."""
    x = np.ascontiguousarray(x)
    return x.view(np.uint64) if x.dtype == np.int64 else x.astype(np.uint64)


class EndgameSolver:
    """One rule mode per instance (the native transposition table keys
    entries by mode, so instances may share it safely)."""

    def __init__(self, compat: bool = False):
        self._lib = load_library()
        self.mode = MODE_COMPAT if compat else MODE_CORRECT

    def solve(self, black: int, white: int, to_move: int, *,
              alpha: int = -64, beta: int = 64,
              passed: int = 0) -> SolveResult:
        """Exact value + optimal move of the position for ``to_move``
        (1=black, 2=white). ``passed`` is whether the previous ply was a
        pass. A narrowed window solves faster but returns fail-soft bounds
        outside it (see ``solve_wdl``)."""
        best = ctypes.c_int32()
        nodes = ctypes.c_uint64()
        value = self._lib.solver_solve(
            ctypes.c_uint64(black & _MASK64),
            ctypes.c_uint64(white & _MASK64), to_move, self.mode, alpha,
            beta, passed, ctypes.byref(best), ctypes.byref(nodes))
        return SolveResult(int(value), int(best.value), int(nodes.value))

    def solve_wdl(self, black: int, white: int, to_move: int, *,
                  passed: int = 0) -> SolveResult:
        """Win/draw/loss probe: the (-1, 1) window answers the sign of the
        value at a fraction of a full solve's cost. ``value`` is then only
        meaningful as its sign."""
        return self.solve(black, white, to_move, alpha=-1, beta=1,
                          passed=passed)

    def solve_wdl_batch(self, black: np.ndarray, white: np.ndarray,
                        to_move: np.ndarray, *,
                        budget_s: Optional[float] = None,
                        num_threads: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Win/draw/loss-probe a batch of positions on a native thread pool
        (``num_threads`` 0 = all cores), sharing the lockless transposition
        table. Positions are claimed in array order, so passing them
        empties-ascending keeps the cheapest-first budget semantics: once
        ``budget_s`` wall-clock seconds elapse, the rest stay unsolved
        (``None`` = unlimited; ``0.0`` = the deadline has already passed).

        Returns ``(values, solved, nodes)``: int32 fail-soft values (sign =
        WDL, meaningful only where ``solved``), a bool solved mask, and the
        total node count. Recorded self-play positions always have a legal
        move for the mover (the env auto-passes), so no ``passed`` flag is
        needed; terminal and pass roots are still handled natively.
        """
        black, white = _u64_array(black), _u64_array(white)
        to_move = np.ascontiguousarray(to_move, np.int32)
        n = black.shape[0]
        if white.shape != (n,) or to_move.shape != (n,):
            raise ValueError("black, white and to_move must be 1-D arrays "
                             "of one length")
        values = np.zeros(n, np.int32)
        solved = np.zeros(n, np.uint8)
        nodes = ctypes.c_uint64()
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.solver_solve_batch(
            n, black.ctypes.data_as(u64p), white.ctypes.data_as(u64p),
            to_move.ctypes.data_as(i32p), self.mode, -1, 1,
            # None = unlimited (native: negative); 0.0 = deadline passed
            -1.0 if budget_s is None else float(budget_s),
            int(num_threads), values.ctypes.data_as(i32p),
            solved.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(nodes))
        return values, solved.astype(bool), int(nodes.value)

    def clear(self) -> None:
        """Clear the native transposition table (shared across instances)."""
        self._lib.solver_clear()
