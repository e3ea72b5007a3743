"""The port's pipeline and CLI (``alphazero_reversi_tpu_torch.pipeline`` /
``.cli``) on the CPU at a tiny config: two iterations through ``cli.main``,
the JAX pipeline's metric names plus ``checkpoint/seconds``, one checkpoint
kept, a resumed run equal bit for bit to the uninterrupted one, the
promotion rule, and the tournament command."""
import ast
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from alphazero_reversi_tpu import selfplay as jselfplay
from alphazero_reversi_tpu_torch import checkpoint as ckpt
from alphazero_reversi_tpu_torch import cli
from alphazero_reversi_tpu_torch import pipeline as tpipeline
import torch_parity  # noqa: F401  (one torch thread)
from torch_configs import tiny_run_config

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _config_file(root, **kw) -> str:
    cfg = tiny_run_config(str(root), exact_value_empties=12, **kw)
    path = os.path.join(str(root), "config.json")
    cfg.save(path)
    return path


def _metrics(root, run):
    path = os.path.join(str(root), "logs", run, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Two iterations in one ``train`` command."""
    root = tmp_path_factory.mktemp("straight")
    cfg = _config_file(root)
    assert cli.main(["--device", "cpu", "train", "-c", cfg,
                     "--iterations", "2", "--run-name", "run"]) == 0
    return root


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """One iteration, then ``continue`` to two."""
    root = tmp_path_factory.mktemp("resumed")
    cfg = _config_file(root)
    for command, total in (("train", "1"), ("continue", "2")):
        assert cli.main(["--device", "cpu", command, "-c", cfg,
                         "--iterations", total, "--run-name", "run"]) == 0
    return root


def _jax_metric_names():
    """The metric names the JAX pipeline logs: the keys of ``train``'s
    ``metrics`` dict and of ``_evaluate_model``'s return, and the relabel
    stats."""
    tree = ast.parse((ROOT / "alphazero_reversi_tpu" / "pipeline.py")
                     .read_text())
    names = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name in (
                "train", "_evaluate_model"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    names |= {k.value for k in node.keys
                              if isinstance(k, ast.Constant)
                              and "/" in str(k.value)}
    empty = np.zeros((1, 1), np.uint64)
    _, stats = jselfplay.relabel_packed_np(
        empty, empty, np.ones((1, 1), np.int32), np.zeros((1, 1), bool),
        np.zeros((1, 1), np.float32), max_empties=0)
    return names | {f"selfplay/relabel_{k}" for k in stats}


def test_metric_names_are_the_jax_pipelines(straight):
    rows = _metrics(straight, "run")
    assert [r["step"] for r in rows] == [0, 1]
    want = _jax_metric_names() | {"checkpoint/seconds"}
    assert "eval/promoted" in want and "train/loss" in want
    for r in rows:
        assert set(r) - {"step"} == want
        assert all(np.isfinite(v) for v in r.values())
    assert rows[0]["train/lr"] == 1e-3 and rows[1]["train/lr"] == 1e-4


def test_one_checkpoint_kept(straight):
    names = sorted(os.listdir(straight / "checkpoints"))
    assert [n for n in names if n.startswith("it_")] == ["it_000002"]
    assert not [n for n in names if n.startswith(".")]
    assert ckpt.latest_checkpoint(str(straight / "checkpoints")) \
        .endswith("it_000002")
    saved = os.listdir(straight / "self_play_data")
    assert sorted(saved) == ["selfplay_it000000_b0.npz",
                             "selfplay_it000001_b0.npz"]


def _assert_trees_equal(a, b, path="tree"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_resumed_run_equals_uninterrupted(straight, resumed):
    """1 iteration + resume + 1 equals 2 iterations, bit for bit: the
    whole checkpoint (weights, AdamW, best, replay, generators, iteration,
    best ELO) and every metric but the timings."""
    a = ckpt.restore_checkpoint(str(straight / "checkpoints" / "it_000002"))
    b = ckpt.restore_checkpoint(str(resumed / "checkpoints" / "it_000002"))
    _assert_trees_equal(a, b)
    assert a["iteration"] == 2 and a["replay"]["size"] > 0
    strip = lambda rows: [{k: v for k, v in r.items()
                           if not k.endswith("seconds")} for r in rows]
    assert strip(_metrics(straight, "run")) == strip(_metrics(resumed, "run"))


def test_promotion_rule(tmp_path, monkeypatch):
    """current is promoted only when its rating beats best's by more than
    the margin; promotion copies the learner's weights into best and saves
    them."""
    cfg = tiny_run_config(str(tmp_path))
    cfg.tournament.promotion_elo_margin = 10.0
    pipe = tpipeline.AlphaZeroPipeline(cfg, device="cpu")
    with torch.no_grad():
        for p in pipe.learner.net.parameters():
            p.add_(1.0)
    for current, promoted in ((1210.0, False), (1210.5, True)):
        board = [{"player_id": "current", "rating": current},
                 {"player_id": "best", "rating": 1200.0},
                 {"player_id": "random", "rating": 1100.0}]
        monkeypatch.setattr(tpipeline.arena_lib.Arena, "run_tournament",
                            lambda self, seed, rounds=None: board)
        metrics = pipe._evaluate_model()
        assert metrics["eval/promoted"] == float(promoted)
        assert metrics["eval/random_elo"] == 1100.0
        same = all(torch.equal(x, y) for x, y in zip(
            pipe.best_net.state_dict().values(),
            pipe.learner.state_dict().values()))
        assert same == promoted
    assert pipe.best_elo == 1210.5
    best = ckpt.restore_best(cfg.training.checkpoint_dir)
    _assert_trees_equal(best, pipe.learner.state_dict())


def test_tournament_command(straight, capsys):
    """The checkpoints and the random baseline play a round robin; the
    ratings persist in the ELO file."""
    cfg = _config_file(straight)
    argv = ["--device", "cpu", "tournament", "-c", cfg, "--model-dir",
            str(straight / "checkpoints"), "--rounds", "1"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    players = {"it_000002", "random"} | (
        {"best_model"} if (straight / "checkpoints" / "best_model").exists()
        else set())
    assert all(p in out for p in players)
    elo_file = straight / "tournament_results" / "elo_ratings.json"
    data = json.loads(elo_file.read_text())
    assert set(data["ratings"]) == players
    n = len(players)
    assert len(data["history"]) == n * (n - 1) // 2 * 2


def test_create_config_writes_default(tmp_path):
    out = tmp_path / "c.json"
    assert cli.main(["create-config", "-o", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["training"]["lr_milestones"] == [5, 7]


@pytest.mark.parametrize("name", ["default_config", "demo_tpu"])
def test_shipped_puct_configs_train_one_iteration(tmp_path, name):
    """The PUCT configs as shipped (``mcts.batch_size`` 0 migrates to 1)
    go through ``cli train`` for one iteration on the CPU, cut to a 1x8
    net, 2 games of 20 moves, PUCT-4 and a PUCT-2 gate of 2 games a pair,
    with outputs under ``tmp_path``: PUCT self-play, SGD, the PUCT gate and
    the checkpoint."""
    from alphazero_reversi_tpu_torch.config import Config

    cfg = Config.load(str(ROOT / "configs" / f"{name}.json"))
    assert (cfg.mcts.algorithm, cfg.mcts.batch_size,
            cfg.tournament.algorithm) == ("puct", 1, "puct")
    cfg.model.num_res_blocks, cfg.model.num_filters = 1, 8
    cfg.model.compute_dtype = "float32"
    cfg.mcts.num_simulations, cfg.tournament.num_simulations = 4, 2
    cfg.self_play.num_games = cfg.self_play.num_parallel_games = 2
    cfg.self_play.max_moves = 20
    cfg.tournament.rounds, cfg.tournament.games_per_pair = 1, 2
    cfg.logging.use_tensorboard = False
    cfg.training.checkpoint_dir = str(tmp_path / "checkpoints")
    cfg.logging.log_dir = str(tmp_path / "logs")
    cfg.self_play.save_dir = str(tmp_path / "self_play_data")
    cfg.tournament.output_dir = str(tmp_path / "tournament")
    path = str(tmp_path / "config.json")
    cfg.save(path)
    assert cli.main(["--device", "cpu", "train", "-c", path,
                     "--iterations", "1", "--run-name", "run"]) == 0
    (row,) = _metrics(tmp_path, "run")
    assert row["selfplay/positions"] == 40
    assert ckpt.latest_checkpoint(cfg.training.checkpoint_dir)


def test_tensorboard_changes_no_training_state(straight, tmp_path):
    """The same two iterations with TensorBoard on end in the same
    checkpoint, bit for bit, as with it off (``straight``), and each
    in-loop save was followed by a projector embedding of the buffer,
    labelled by value target."""
    cfg = _config_file(tmp_path, use_tensorboard=True)
    assert cli.main(["--device", "cpu", "train", "-c", cfg,
                     "--iterations", "2", "--run-name", "run"]) == 0
    a = ckpt.restore_checkpoint(str(straight / "checkpoints" / "it_000002"))
    b = ckpt.restore_checkpoint(str(tmp_path / "checkpoints" / "it_000002"))
    _assert_trees_equal(a, b)
    run = tmp_path / "logs" / "run"
    projector = (run / "projector_config.pbtxt").read_text()
    assert projector.count("replay/positions") == 2  # steps 0 and 1
    for step in (0, 1):
        (meta,) = run.glob(f"{step:05d}/replay*/metadata.tsv")
        labels = meta.read_text().split()
        assert 0 < len(labels) <= 256
        assert all(x.startswith("v=") and len(x) == 7 for x in labels)
