"""Parity of the port's endgame solver (``alphazero_reversi_tpu_torch.env.
endgame``, its own build of its copy of ``native/solver.cpp``) with the JAX
package's ``EndgameSolver``: exactly equal values, moves and node counts on
random positions with at most 10 empty squares, in both rule modes."""
import numpy as np
import pytest

from alphazero_reversi_tpu.env import endgame as jendgame
from alphazero_reversi_tpu_torch.env import endgame as tendgame
from torch_parity import random_positions

MASK = (1 << 64) - 1


def _endgames(compat: bool, seed: int):
    """(black, white, to_move) of random-play positions with <= 10 empties,
    as Python ints (unsigned) and as the port's int64 words."""
    s = random_positions(48, seed, compat=compat,
                         plies=np.random.default_rng(seed).integers(50, 61,
                                                                    48))
    black, white = s.black.numpy(), s.white.numpy()
    to_move = s.to_move.numpy().astype(np.int32)
    empties = np.array([tendgame.count_empties(int(b), int(w))
                        for b, w in zip(black, white)])
    keep = empties <= 10
    assert keep.sum() >= 16
    return black[keep], white[keep], to_move[keep]


@pytest.fixture(scope="module", params=[False, True],
                ids=["correct", "compat"])
def case(request):
    compat = request.param
    return (compat, jendgame.EndgameSolver(compat=compat),
            tendgame.EndgameSolver(compat=compat),
            _endgames(compat, 5 + compat))


def test_modes_match_jax():
    from alphazero_reversi_tpu.env import oracle
    assert (tendgame.MODE_CORRECT, tendgame.MODE_COMPAT) == \
        (oracle.MODE_CORRECT, oracle.MODE_COMPAT)


def test_count_empties_matches_jax():
    s = random_positions(32, 1)
    for b, w in zip(s.black.tolist(), s.white.tolist()):
        assert tendgame.count_empties(b, w) == \
            jendgame.count_empties(b & MASK, w & MASK)


def test_solve_and_wdl_match_jax(case):
    """Full window and WDL window, each from a cleared table on both sides:
    value, best move and node count identical."""
    _, jsolver, tsolver, (black, white, to_move) = case
    for b, w, m in zip(black.tolist(), white.tolist(), to_move.tolist()):
        for passed in (0, 1):
            jsolver.clear()
            tsolver.clear()
            assert tsolver.solve(b, w, m, passed=passed) == \
                jsolver.solve(b & MASK, w & MASK, m, passed=passed)
        jsolver.clear()
        tsolver.clear()
        assert tsolver.solve_wdl(b, w, m) == \
            jsolver.solve_wdl(b & MASK, w & MASK, m)


@pytest.mark.parametrize("budget", [None, 0.0], ids=["unlimited", "zero"])
def test_solve_wdl_batch_matches_jax(case, budget):
    """The batch probe takes the port's int64 words; values and the solved
    mask equal JAX's (budget 0.0: nothing solved on either side)."""
    _, jsolver, tsolver, (black, white, to_move) = case
    jv, js, _ = jsolver.solve_wdl_batch(black.view(np.uint64),
                                        white.view(np.uint64), to_move,
                                        budget_s=budget, num_threads=2)
    tv, ts, _ = tsolver.solve_wdl_batch(black, white, to_move,
                                        budget_s=budget, num_threads=2)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tv[ts], jv[js])
    if budget is None:
        assert ts.all()
    else:
        assert not ts.any()


def test_solve_wdl_batch_refuses_ragged_input():
    solver = tendgame.EndgameSolver()
    with pytest.raises(ValueError):
        solver.solve_wdl_batch(np.zeros(3, np.int64), np.zeros(2, np.int64),
                               np.ones(3, np.int32))


def test_failed_solver_build_raises(tmp_path, monkeypatch):
    """A source that does not compile, or no host compiler, raises: the
    relabel never runs without its solver."""
    from alphazero_reversi_tpu_torch.kernels import build

    bad = tmp_path / "solver.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "SOLVER_SOURCES", (bad,))
    with pytest.raises(RuntimeError, match="build of solver failed"):
        build.build([], solver=True)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        build.build([], solver=True)
