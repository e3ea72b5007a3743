"""The port's benchmark module (``alphazero_reversi_tpu_torch.benchmarks``)
against the JAX package's (``alphazero_reversi_tpu/benchmarks.py``), on the
CPU at tiny sizes: the env stepping loop with JAX's draws injected, the
random endgame boards, the batch solver's positions and values, and every
subcommand's rows, whose keys are the JAX rows' keys plus ``device``."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu import benchmarks as jbench
from alphazero_reversi_tpu.env import bitboard as jenv
from alphazero_reversi_tpu.env import endgame as jendgame
from alphazero_reversi_tpu.env import oracle
from alphazero_reversi_tpu_torch import benchmarks as tbench
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.env import endgame as tendgame
from torch_configs import tiny_run_config
from torch_parity import assert_states_equal

MODES = pytest.mark.parametrize("compat", [False, True],
                                ids=["correct", "compat"])

# the JAX rows' keys (alphazero_reversi_tpu/benchmarks.py); the memory
# columns on the CPU are the host's alone, as in JAX without device stats
ENV_KEYS = ["batch", "steps", "seconds", "env_steps_per_s"]
MEMORY_KEYS = ["host_rss_bytes"]
MCTS_KEYS = ["batch", "num_simulations", "leaf_batch", "time_per_search_s",
             "moves_per_s", "nodes_per_s", *MEMORY_KEYS]
SUSTAINED_KEYS = ["batch", "num_simulations", "leaf_batch", "algorithm",
                  "moves_in_program", "time_per_move_s", "moves_per_s",
                  "nodes_per_s", *MEMORY_KEYS]
ROOFLINE_KEYS = ["net", "batch", "sims", "leaf_batch", "moves_per_s",
                 "nn_ms_per_round", "roofline_moves_per_s", "roofline_frac"]
SOLVER_KEYS = ["empties", "mode", "window", "positions", "avg_ms",
               "avg_nodes", "nodes_per_s"]
SOLVER_BATCH_KEYS = ["empties", "mode", "positions", "threads", "seconds",
                     "positions_per_s", "nodes_per_s", "speedup_vs_1thread"]
# the JAX profile command writes a trace and no row; the port's row
PROFILE_KEYS = ["trace", "batch", "num_simulations", "events",
                "kernel_events", "round_backup_kernels"]
# bench.py's points without the vs_baseline ratios, each with its
# operating point
HEADLINE_KEYS = ["env_steps_per_s", "mcts_moves_per_s",
                 "mcts_peak_moves_per_s", "gumbel_moves_per_s",
                 "gumbel_flagship_moves_per_s", "search_b1_s"]
POINTS = ["env", "mcts", "mcts_peak", "gumbel", "gumbel_flagship",
          "search_b1"]


def _jax_env_loop(batch, steps, compat, key):
    """``bench_env``'s stepping loop as alphazero_reversi_tpu/benchmarks.py
    writes it (:74-88), and the uniform draws it makes."""
    fresh = jenv.initial_state((batch,))

    @jax.jit
    def run(states, key):
        def body(s, k):
            legal = jenv.legal_action_mask(s, compat=compat)
            scores = jax.random.uniform(k, (batch, jenv.NUM_ACTIONS))
            action = jnp.argmax(jnp.where(legal, scores, -1.0),
                                axis=-1).astype(jnp.int32)
            ns, _ = jenv.step(s, action, compat=compat)
            ns = jax.tree_util.tree_map(
                lambda f, n: jnp.where(ns.done, f, n), fresh, ns)
            return ns, None

        final, _ = jax.lax.scan(body, states, jax.random.split(key, steps))
        return final

    keys = jax.random.split(key, steps)
    draws = jax.vmap(
        lambda k: jax.random.uniform(k, (batch, jenv.NUM_ACTIONS)))(keys)
    return run(fresh, key), np.array(draws)


@MODES
def test_env_loop_matches_jax(compat):
    """B=8 boards for 70 steps (longer than any game, so every board is
    reset at least once): the port's loop with JAX's draws injected ends
    in JAX's states, bit for bit."""
    jfinal, draws = _jax_env_loop(8, 70, compat, jax.random.PRNGKey(3))
    fresh = tenv.initial_state((8,))
    final = tbench.env_steps(fresh, fresh, 70, compat,
                             scores=torch.from_numpy(draws))
    assert_states_equal(jfinal, final)
    stones = tenv.score(final)[0] + tenv.score(final)[1]
    assert bool((stones < 4 + 70).all())  # reset: fewer stones than steps


@MODES
@pytest.mark.parametrize("empties", [8, 12])
def test_random_endgame_boards_match_jax(compat, empties):
    """The port's boards (its env, stepped in one batch) are the JAX
    bench's (its C oracle, one at a time) for the same seeds."""
    mode = oracle.MODE_COMPAT if compat else oracle.MODE_CORRECT
    seeds = [9000 + 31 * empties + i for i in range(3)] + \
        [40000 + i for i in range(5)]
    boards = tbench._random_endgame_boards(empties, compat, seeds)
    for i, seed in enumerate(seeds):
        b = jbench._random_endgame_board(empties, mode, seed)
        assert tbench._board_ints(boards, i) == (
            b.black, b.white, b.current_player, b.passed)
        assert bool(boards.done[i]) == b.game_over
    one = tbench._random_endgame_board(empties, compat, seeds[-1])
    assert tbench._board_ints(one) == tbench._board_ints(boards, 7)


@MODES
def test_solver_batch_matches_jax(compat):
    """``bench_solver_batch``'s 32 positions are the JAX bench's, the port's
    batch solver gives JAX's ``solve_wdl_batch`` values on them, and the
    bench solves them all at 1 and 2 threads."""
    mode = oracle.MODE_COMPAT if compat else oracle.MODE_CORRECT
    want, i = [], 0
    while len(want) < 32:
        b = jbench._random_endgame_board(12, mode, 40000 + i)
        i += 1
        if not (b.game_over or b.legal_moves_bb() == 0):
            want.append((b.black, b.white, b.current_player))
    black, white, mover = tbench.endgame_positions(32, 12, compat)
    assert list(zip(black.tolist(), white.tolist(), mover.tolist())) == want
    got, solved, _ = tendgame.EndgameSolver(compat).solve_wdl_batch(
        black, white, mover)
    jvalues, jsolved, _ = jendgame.EndgameSolver(compat).solve_wdl_batch(
        black, white, mover)
    assert solved.all() and jsolved.all()
    np.testing.assert_array_equal(got, jvalues)
    rows = tbench.bench_solver_batch(32, 12, [1, 2], compat=compat)
    assert [r["threads"] for r in rows] == [1, 2]
    assert all(r["positions"] == 32 for r in rows)


def _rows(capsys, argv):
    assert tbench.main([*argv, "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert rows and all(r.pop("device") == "cpu" for r in rows)
    return rows


@pytest.mark.parametrize("argv,keys,n", [
    (["env", "--batch", "4", "--steps", "3"], ENV_KEYS, 1),
    (["env", "--batch", "4", "--steps", "3", "--compat"], ENV_KEYS, 1),
    (["mcts", "--batch-sizes", "1", "2", "--sims", "4", "--blocks", "1",
      "--filters", "8", "--dtype", "float32", "--stages", "1"],
     MCTS_KEYS, 2),
    (["mcts-sustained", "--batch", "2", "--sims", "4", "--moves", "2",
      "--blocks", "1", "--filters", "8", "--leaf-batch", "2"],
     SUSTAINED_KEYS, 1),
    (["mcts-sustained", "--batch", "2", "--sims", "4", "--moves", "2",
      "--blocks", "1", "--filters", "8", "--algorithm", "gumbel"],
     SUSTAINED_KEYS, 1),
    (["solver", "--empties", "8", "--positions", "2"], SOLVER_KEYS, 1),
    (["solver", "--empties", "8", "--positions", "2", "--wdl",
      "--compat"], SOLVER_KEYS, 1),
    (["solver-batch", "--positions", "8", "--empties", "8", "--threads",
      "2", "1"], SOLVER_BATCH_KEYS, 2),
], ids=["env", "env-compat", "mcts", "sustained-puct", "sustained-gumbel",
        "solver", "solver-wdl", "solver-batch"])
def test_command_rows_have_jax_keys(capsys, argv, keys, n):
    rows = _rows(capsys, argv)
    assert len(rows) == n and all(list(r) == keys for r in rows)
    rates = [v for r in rows for k, v in r.items() if k.endswith("_per_s")]
    assert all(np.isfinite(v) and v > 0 for v in rates)


def test_roofline_rows(capsys, monkeypatch):
    """One row per (net, sims, leaf_batch) with sims divisible by
    leaf_batch, at JAX's keys; the ceiling is batch / (rounds x forward)."""
    real = tbench.bench_nn_forward
    monkeypatch.setattr(  # keep the flagship net's CPU forwards few
        tbench, "bench_nn_forward",
        lambda *a, **kw: real(*a, **{**kw, "steps": 2, "repeats": 1}))
    rows = _rows(capsys, ["roofline", "--batch", "2", "--sims", "2", "3",
                          "--leaf-batches", "1", "2"])
    assert [list(r) for r in rows] == [ROOFLINE_KEYS] * 6
    assert [(r["net"], r["sims"], r["leaf_batch"]) for r in rows] == [
        (net, s, lb) for net in ("tiny-1x16", "flagship-5x128")
        for s, lb in ((2, 1), (2, 2), (3, 1))]
    for r in rows:
        rounds = r["sims"] // r["leaf_batch"]
        assert r["roofline_moves_per_s"] == pytest.approx(
            2 / (rounds * r["nn_ms_per_round"] * 1e-3), rel=1e-2)


def test_profile_writes_a_trace(capsys, tmp_path):
    rows = _rows(capsys, ["profile", "--trace-dir", str(tmp_path),
                          "--batch", "2", "--sims", "2"])
    (row,) = rows
    assert list(row) == PROFILE_KEYS and row["events"] > 0
    assert row["kernel_events"] == row["round_backup_kernels"] == 0  # CPU
    with open(row["trace"]) as f:
        assert json.load(f)["traceEvents"]


def test_headline_skip_iteration(capsys, monkeypatch):
    """``headline --skip-iteration`` runs every point of bench.py (sizes
    cut here) and prints one row of rates and operating points, without
    the iteration's keys."""
    tiny = dict(batch=2, num_simulations=4, moves=1, num_res_blocks=1,
                num_filters=8, repeats=1)
    monkeypatch.setattr(tbench, "HEADLINE", tuple(
        (key, point, fn, field,
         dict(batch=4, steps=2, repeats=1) if point == "env" else
         dict(batch_sizes=[1], num_simulations=4, num_res_blocks=1,
              num_filters=8, repeats=1) if point == "search_b1" else
         {**tiny, **{k: v for k, v in kw.items()
                     if k in ("algorithm", "num_stages")}})
        for key, point, fn, field, kw in tbench.HEADLINE))
    (row,) = _rows(capsys, ["headline", "--skip-iteration",
                            "--leaf-batch", "2"])
    assert sorted(row) == sorted(
        HEADLINE_KEYS + [f"{p}_operating_point" for p in POINTS])
    assert all(np.isfinite(row[k]) and row[k] > 0 for k in HEADLINE_KEYS)
    assert row["mcts_operating_point"]["leaf_batch"] == 2


def test_flagship_iteration_bench(tmp_path, monkeypatch):
    """The iteration point, on a tiny config in place of the flagship's:
    the fastest iteration after the first, with its phase seconds from the
    pipeline's metrics."""
    path = tmp_path / "config.json"
    tiny_run_config(str(tmp_path), games=2, max_moves=6).save(str(path))
    monkeypatch.setattr(tbench, "FLAGSHIP_CONFIG", path)
    out = tbench.bench_flagship_iteration(2, device="cpu")
    walls = out["flagship_iterations_s"]
    assert len(walls) == 2 and out["flagship_iteration_s"] == walls[1]
    phases = out["flagship_iteration_phases_s"]
    assert sorted(phases) == ["checkpoint", "eval", "selfplay", "train"]
    assert 0 < sum(phases.values()) <= walls[1]


def test_bench_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.main(["env", "--batch", "4", "--steps", "1"])


SCALING_ENV_KEYS = ["devices", "batch", "env_steps_per_s", "efficiency_pct"]
SCALING_SELFPLAY_KEYS = ["devices", "games", "moves_per_s", "efficiency_pct"]


def test_scaling_has_jax_arguments_and_rows():
    """``bench_scaling``: the JAX function's arguments and defaults (plus
    ``device``) and its row keys; 1 and 2 gloo ranks, spawned, at a tiny
    size, the rates counting both ranks' work."""
    import inspect

    jparams = inspect.signature(jbench.bench_scaling).parameters
    tparams = inspect.signature(tbench.bench_scaling).parameters
    assert [(k, p.default) for k, p in jparams.items()] == \
        [(k, p.default) for k, p in tparams.items() if k != "device"]
    out = tbench.bench_scaling([1, 2, 1000], env_batch_per_device=16,
                               env_steps=4, sp_games_per_device=1,
                               sp_sims=2, repeats=1, device="cpu")
    assert out["devices_available"] >= 2
    assert [r["devices"] for r in out["env"]] == [1, 2]
    assert [r["batch"] for r in out["env"]] == [16, 32]
    assert [r["games"] for r in out["selfplay"]] == [1, 2]
    for rows, keys, rate in ((out["env"], SCALING_ENV_KEYS,
                              "env_steps_per_s"),
                             (out["selfplay"], SCALING_SELFPLAY_KEYS,
                              "moves_per_s")):
        assert all(list(r) == keys for r in rows)
        assert all(np.isfinite(r[rate]) and r[rate] > 0 for r in rows)
        assert rows[0]["efficiency_pct"] == 100.0


def test_scaling_command_labels_every_row(capsys, monkeypatch):
    def fake(devices, env_batch, **kw):
        assert devices == [2] and env_batch == 8 and kw["sp_sims"] == 3
        return {"devices_available": 2,
                "env": [{"devices": 2, "batch": 16}],
                "selfplay": [{"devices": 2, "games": 4}]}

    monkeypatch.setattr(tbench, "bench_scaling", fake)
    (row,) = _rows(capsys, ["scaling", "--devices", "2",
                            "--env-batch-per-device", "8", "--sims", "3"])
    assert all(r["device"] == "cpu" for r in row["env"] + row["selfplay"])

