"""The port's tournament over several ranks (``Arena.run_tournament`` with
``shard_index``/``shard_count``/``gather``, and ``cli tournament
--coordinator``), on the CPU:

* sharding in each pairing mode: two shards played in turn in one process
  give the one-shard score rows, leaderboard and ELO history exactly, and
  every unit is played by exactly one shard;
* the ELO order against the JAX package's ``Arena.run_tournament`` on
  rigged scores (no JAX program is compiled): the 2-shard per-round and
  ``batch_rounds`` tournaments give its leaderboard and history;
* the command over 2 gloo ranks (``parallel.mesh.spawn_ranks``, a hard
  timeout): rank 0 alone prints and writes the one-process run's ELO file,
  even when it waits for rank 1's late share longer than the process
  group's timeout; a checkpoint that only rank 0 can load fails the run on
  every rank;
* the mesh checks ``train`` makes.

History records carry a wall-clock ``timestamp`` and the ELO file a
``last_updated`` time; everything else is compared exactly.
"""
import json
import os
import re
import sys
import time

import jax
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu import arena as jarena
from alphazero_reversi_tpu.config import TournamentConfig as JTournamentConfig
from alphazero_reversi_tpu_torch import checkpoint as ckpt_lib
from alphazero_reversi_tpu_torch import cli
from alphazero_reversi_tpu_torch.arena import Arena, _seed
from alphazero_reversi_tpu_torch.config import (Config, ModelConfig,
                                                TournamentConfig)
from alphazero_reversi_tpu_torch.elo import ELORatingSystem
from alphazero_reversi_tpu_torch.models import resnet
from alphazero_reversi_tpu_torch.parallel import mesh as tmesh

import torch_parity  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(num_res_blocks=1, num_filters=8, value_head_hidden_size=16,
                   compute_dtype="float32")
SPAWN_TIMEOUT_S = 120


def _without_time(history):
    return [{k: v for k, v in h.items() if k != "timestamp"}
            for h in history]


def _net(seed: int):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return resnet.build_network(TINY)


# per mode: the tournament config (an odd batch_rounds total, 3 games, so
# the filler game is dropped)
MODES = {
    "per_round": dict(algorithm="puct", rounds=2, games_per_pair=2),
    "batch_rounds": dict(algorithm="gumbel", rounds=3, games_per_pair=1,
                         batch_rounds=True),
    "merged": dict(algorithm="gumbel", rounds=2, games_per_pair=2,
                   merge_pairings=True),
}


def _arena(mode: str) -> Arena:
    cfg = TournamentConfig(num_simulations=2, max_considered_actions=2,
                           tree_reuse="root", temperature=0.1,
                           **MODES[mode])
    ar = Arena(cfg, device="cpu")
    ar.add_player("a", _net(1))
    ar.add_player("b", _net(2))
    ar.add_player("random", None)
    return ar


@pytest.mark.parametrize("mode", list(MODES))
def test_two_shards_give_the_one_shard_tournament(mode):
    seed = 5
    whole_rows = []

    def record(scores, owners):
        whole_rows.append(scores)
        return scores

    whole = _arena(mode)
    board = whole.run_tournament(seed, gather=record)
    (want,) = whole_rows
    n_units = len(whole._units(seed, whole.config.rounds,
                               whole.config.merge_pairings))
    assert whole.units_played == list(range(n_units))
    assert want.shape[0] == n_units

    rows = {}

    def keep(scores, owners):  # shard 0's rows, kept for shard 1
        rows[0] = scores
        return scores

    def merge(scores, owners):
        rows[1] = scores
        return np.stack([rows[0], scores])[owners, np.arange(len(owners))]

    first, second = _arena(mode), _arena(mode)
    first.run_tournament(seed, shard_index=0, shard_count=2, gather=keep)
    assert second.run_tournament(seed, shard_index=1, shard_count=2,
                                 gather=merge) == board
    assert _without_time(second.elo.history) == \
        _without_time(whole.elo.history)
    played = first.units_played + second.units_played
    assert sorted(played) == list(range(n_units))  # each exactly once
    for u in range(n_units):  # each unit's row from its owner shard
        np.testing.assert_array_equal(rows[u % 2][u], want[u])
    games = MODES[mode]["rounds"] * MODES[mode]["games_per_pair"] * 3
    assert len(whole.elo.history) == games


def _rigged(match: int, n: int) -> np.ndarray:
    return np.random.default_rng(match).choice(
        np.float32([0.0, 0.5, 1.0]), n)


@pytest.mark.parametrize("mode", ["per_round", "batch_rounds"])
def test_sharded_elo_order_is_jax(monkeypatch, mode):
    """Rigged match scores keyed on the match index: JAX plays its matches
    in order, the port's shards by their seeds ``_seed(seed, m)``."""
    kw = {k: v for k, v in MODES[mode].items() if k != "algorithm"}
    seed = 9
    jar = jarena.Arena(None, JTournamentConfig(**kw))
    for name in ("current", "best", "random"):
        jar.add_player(name, None)
    jax_matches = []

    def jax_play(a, b, key, n, black_games=None):
        jax_matches.append((a.name, b.name, n))
        return _rigged(len(jax_matches) - 1, n)

    monkeypatch.setattr(jar, "play_games", jax_play)
    jboard = jar.run_tournament(jax.random.PRNGKey(0))

    match_of = {_seed(seed, m): m for m in range(len(jax_matches))}
    port_matches = {}
    shards = []
    rows = {}

    def keep(scores, owners):
        rows[0] = scores
        return scores

    def merge(scores, owners):
        return np.stack([rows[0], scores])[owners, np.arange(len(owners))]

    for index, gather in ((0, keep), (1, merge)):
        ar = Arena(TournamentConfig(**kw), device="cpu")
        for name in ("current", "best", "random"):
            ar.add_player(name, None)

        def port_play(a, b, s, n):
            port_matches[match_of[s]] = (a.name, b.name, n)
            return _rigged(match_of[s], n)

        monkeypatch.setattr(ar, "play_games", port_play)
        board = ar.run_tournament(seed, shard_index=index, shard_count=2,
                                  gather=gather)
        shards.append(ar)
    assert [port_matches[m] for m in range(len(jax_matches))] == jax_matches
    assert [p["player_id"] for p in board] == \
        [p["player_id"] for p in jboard]
    for t, j in zip(board, jboard):
        assert t["games_played"] == j["games_played"]
        assert abs(t["rating"] - j["rating"]) <= 1e-9
    history, jhistory = (_without_time(h) for h in (
        shards[1].elo.history, jar.elo.history))
    assert len(history) == len(jhistory) == kw["rounds"] * \
        kw["games_per_pair"] * 3
    for t, j in zip(history, jhistory):
        assert (t["player_a"], t["player_b"], t["score_a"]) == \
            (j["player_a"], j["player_b"], j["score_a"])
        assert abs(t["rating_a_after"] - j["rating_a_after"]) <= 1e-9


# -- the command ---------------------------------------------------------

def _command_config(path, output_dir, **mesh):
    """A tiny per-round PUCT-2 tournament (1 round, 2 games a pair)."""
    cfg = Config()
    cfg.seed = 3
    cfg.model = TINY
    to = cfg.tournament
    to.algorithm, to.num_simulations, to.rounds = "puct", 2, 1
    to.games_per_pair, to.output_dir = 2, str(output_dir)
    for k, v in mesh.items():
        setattr(cfg.mesh, k, v)
    cfg.save(str(path))
    return str(path)


def _model_dir(root):
    """Two checkpoints written by the port's checkpoint module."""
    ckpt_lib.save_checkpoint(str(root), 2,
                             {"learner": {"net": _net(11).state_dict()},
                              "iteration": 2})
    ckpt_lib.save_best(str(root), _net(12).state_dict())
    return str(root)


def _elo_file(path):
    elo = ELORatingSystem()
    elo.add_player("it_000002", 1250.0)
    elo.add_player("retired", 1100.0)
    elo.update_ratings("it_000002", "retired", 1.0)
    elo.save_ratings(str(path))


# one rank of ``cli tournament`` (argv[3:]) whose process group times out
# after argv[1] s, sleeping argv[2] s before its first match
RANK = """
import datetime, sys, time
from alphazero_reversi_tpu_torch import cli
from alphazero_reversi_tpu_torch.arena import Arena
from alphazero_reversi_tpu_torch.parallel import mesh
mesh.TIMEOUT = datetime.timedelta(seconds=float(sys.argv[1]))
delay, play = [float(sys.argv[2])], Arena.play_games
def late(self, *args):
    time.sleep(delay.pop() if delay else 0.0)
    return play(self, *args)
Arena.play_games = late
sys.exit(cli.main(sys.argv[3:]))
"""
GROUP_TIMEOUT_S = 8.0
LATE_S = GROUP_TIMEOUT_S + 3.0  # rank 1's head start for rank 0's wait


def _spawn_command(tmp_path, model_dirs, late_s=0.0):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return tmesh.spawn_ranks(
        lambda r, port: [
            sys.executable, "-c", RANK, str(GROUP_TIMEOUT_S),
            str(late_s if r == 1 else 0.0), "--device", "cpu", "tournament",
            "-c", _command_config(tmp_path / f"rank{r}.json",
                                  tmp_path / f"out{r}"),
            "--model-dir", model_dirs[r], "--coordinator",
            f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
            str(r)],
        2, SPAWN_TIMEOUT_S, env=env, what="cli tournament")


def test_command_over_two_gloo_ranks(tmp_path, capsys):
    models = _model_dir(tmp_path / "models")
    elo_name = Config().tournament.elo_file
    for out in ("solo", "out0"):
        _elo_file(tmp_path / out / elo_name)

    solo = _command_config(tmp_path / "solo.json", tmp_path / "solo")
    assert cli.main(["--device", "cpu", "tournament", "-c", solo,
                     "--model-dir", models]) == 0
    want = json.loads((tmp_path / "solo" / elo_name).read_text())

    # rank 1 plays its match LATE_S late: rank 0, done with its two, waits
    # at the score gather longer than the process group's timeout
    t0 = time.monotonic()
    outs = _spawn_command(tmp_path, [models, models], late_s=LATE_S)
    assert time.monotonic() - t0 > LATE_S
    got = json.loads((tmp_path / "out0" / elo_name).read_text())
    assert got.keys() == want.keys()
    for key in want:
        if key == "history":
            assert _without_time(got[key]) == _without_time(want[key])
        elif key != "last_updated":
            assert got[key] == want[key], key
    assert set(want["ratings"]) == {"it_000002", "best_model", "random",
                                    "retired"}
    assert len(want["history"]) == 1 + 3 * 2
    board = re.compile(r"^\s*\d+\. ", re.M)
    assert len(board.findall(outs[0])) == 4 and "ratings saved" in outs[0]
    assert not board.findall(outs[1]) and "ratings saved" not in outs[1]
    assert not (tmp_path / "out1").exists()  # rank 1 wrote nothing

    # rank 1's copy of it_000002 is unreadable: every rank fails, none hangs
    broken = _model_dir(tmp_path / "broken")
    with open(os.path.join(broken, "it_000002", ckpt_lib.STATE_FILE),
              "wb") as f:
        f.write(b"not a checkpoint")
    (tmp_path / "fail").mkdir()
    with pytest.raises(RuntimeError, match="failed") as failure:
        _spawn_command(tmp_path / "fail", [models, broken])
    assert "could not load" in str(failure.value)
    assert not (tmp_path / "fail" / "out0").exists()


@pytest.mark.parametrize("mesh,match", [
    (dict(model_axis=2), "model_axis=2"),
    (dict(data_axis=2), "data_axis=2"),
])
def test_command_checks_the_mesh(tmp_path, mesh, match):
    cfg = _command_config(tmp_path / "cfg.json", tmp_path / "out", **mesh)
    with pytest.raises(ValueError, match=match):
        cli.main(["--device", "cpu", "tournament", "-c", cfg,
                  "--model-dir", str(tmp_path)])
