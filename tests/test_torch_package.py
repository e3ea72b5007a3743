"""Package-level checks of the PyTorch port: it never imports JAX or the JAX
package, its entry points default to CUDA, and its config copy loads every
shipped config exactly as the JAX package does."""
import ast
import dataclasses
import pathlib

import pytest
import torch

from alphazero_reversi_tpu.config import Config as JConfig
from alphazero_reversi_tpu_torch import (arena, cli, learner, pipeline,
                                         replay, selfplay)
from alphazero_reversi_tpu_torch.config import Config, ModelConfig
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.mcts import gumbel, search
from alphazero_reversi_tpu_torch.models import resnet
from alphazero_reversi_tpu_torch.parallel import dp, mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "alphazero_reversi_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "alphazero_reversi_tpu")


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_ast_check_covers_every_port_module():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("ops/random.py", "zobrist.py", "mcts/transposition.py",
                   "mcts/search.py", "env/game.py", "interop.py", "cli.py",
                   "benchmarks.py", "hostfetch.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/multihost.py",
                   "parallel/dp.py", "parallel/replay_sharded.py"):
        assert f"alphazero_reversi_tpu_torch/{module}" in names


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")),
                         ids=lambda p: p.name)
def test_config_loads_like_jax(path):
    assert dataclasses.asdict(Config.load(str(path))) == \
        dataclasses.asdict(JConfig.load(str(path)))


def test_config_migrates_legacy_keys_like_jax():
    raw = {"mcts": {"temperature": 0.7, "temperature_threshold": 9,
                    "batch_size": 0, "c_visit": 12.0},
           "unknown_section": {}, "model": {"not_a_field": 1}}
    assert dataclasses.asdict(Config.from_dict(raw)) == \
        dataclasses.asdict(JConfig.from_dict(raw))


def test_entry_points_default_to_cuda(tmp_path):
    """Without a device argument the entry points mean CUDA, and raise on a
    host without one instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    net = resnet.build_network(ModelConfig(num_res_blocks=0, num_filters=4))
    states = tenv.initial_state((2,))
    with pytest.raises(RuntimeError, match="CUDA"):
        gumbel.run_gumbel_search(net, states, num_simulations=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        search.run_search(net, states, num_simulations=2, c_puct=1.0,
                          dirichlet_alpha=0.3, dirichlet_epsilon=0.25)
    with pytest.raises(RuntimeError, match="CUDA"):
        search.MCTS(net, Config().mcts)
    kw = selfplay.search_kwargs(Config().mcts, Config().self_play)
    with pytest.raises(RuntimeError, match="CUDA"):
        selfplay.play_games(net, num_games=2, **{**kw, "algorithm": "gumbel"})
    with pytest.raises(RuntimeError, match="CUDA"):
        selfplay.play_games(net, num_games=2, **kw)  # PUCT
    with pytest.raises(RuntimeError, match="CUDA"):
        selfplay.SelfPlay(net, Config().mcts, Config().self_play)
    with pytest.raises(RuntimeError, match="CUDA"):
        learner.Learner(net, Config().training)
    with pytest.raises(RuntimeError, match="CUDA"):
        replay.create(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        arena.Arena(Config().tournament)
    with pytest.raises(RuntimeError, match="CUDA"):
        arena.play_units([None, None], [(0, 1, 2, tenv.BLACK)],
                         num_simulations=2, temperature=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        dp.DPTrainer(net, Config().training)
    with pytest.raises(RuntimeError, match="CUDA"):
        dp.sharded_play_games(net, num_games=2, seed=0, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):  # before any rendezvous
        mesh.initialize_distributed("127.0.0.1:1", 1, 0)
    cfg = Config()
    cfg.logging.log_dir = str(tmp_path / "logs")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.AlphaZeroPipeline(cfg)
    cfg.save(str(tmp_path / "c.json"))
    for argv in (["train", "-c", str(tmp_path / "c.json")],
                 ["continue", "-c", str(tmp_path / "c.json")],
                 ["tournament", "-c", str(tmp_path / "c.json"),
                  "--model-dir", str(tmp_path)],
                 ["analyze", "-c", str(tmp_path / "c.json"), "d3"],
                 ["play", "-c", str(tmp_path / "c.json")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)


def test_search_refuses_states_on_another_device():
    net = resnet.build_network(ModelConfig(num_res_blocks=0, num_filters=4))
    with pytest.raises(ValueError, match="root_states"):
        gumbel.run_gumbel_search(net, tenv.initial_state((2,)),
                                 num_simulations=2, device="meta")


def test_trace_busy_time_is_the_union_of_kernel_spans():
    """trace_selfplay's device busy time counts overlapping kernels once."""
    from types import SimpleNamespace

    from alphazero_reversi_tpu_torch.trace_selfplay import _busy_us

    spans = [(0, 10), (5, 12), (20, 25), (21, 22), (30, 31)]
    events = [SimpleNamespace(time_range=SimpleNamespace(start=s, end=e))
              for s, e in spans]
    assert _busy_us(events) == 12 + 5 + 1
    assert _busy_us([]) == 0
