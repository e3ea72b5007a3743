"""The port's host play path against the JAX package: Zobrist hashes, the
transposition table, ``Board``/``ReversiGame``, ``MCTS`` (exact endgames,
the table, the net swap), checkpoint interop with the reference format, and
the CLI's ``analyze``, ``play`` and ``import-checkpoint`` on the CPU."""
import builtins
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu import interop as jinterop
from alphazero_reversi_tpu import zobrist as jzobrist
from alphazero_reversi_tpu.config import MCTSConfig as JMCTSConfig
from alphazero_reversi_tpu.config import ModelConfig as JModelConfig
from alphazero_reversi_tpu.env import game as jgame
from alphazero_reversi_tpu.mcts import search as jsearch
from alphazero_reversi_tpu.mcts.transposition import \
    TranspositionTable as JTable
from alphazero_reversi_tpu.models import resnet as jresnet
from alphazero_reversi_tpu_torch import checkpoint as ckpt
from alphazero_reversi_tpu_torch import cli, interop, symmetry, zobrist
from alphazero_reversi_tpu_torch.config import Config, MCTSConfig, \
    ModelConfig
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.env import game as tgame
from alphazero_reversi_tpu_torch.mcts import search as tsearch
from alphazero_reversi_tpu_torch.mcts.transposition import \
    TranspositionTable
from alphazero_reversi_tpu_torch.models import resnet as tresnet
from torch_parity import (make_nets, random_positions, to_jax_state,
                          u64_to_int64)

A = tenv.NUM_ACTIONS
MASK = (1 << 64) - 1


def _host(states, i):
    """(black, white, to_move) of position ``i`` as unsigned host ints."""
    return (int(states.black[i]) & MASK, int(states.white[i]) & MASK,
            int(states.to_move[i]))


@pytest.fixture(scope="module")
def positions():
    return random_positions(24, 11)


# ------------------------------------------------------------- zobrist
def test_batched_hashes_match_jax(positions):
    js = to_jax_state(positions)
    want = jax.jit(lambda s: (jzobrist.hash_states(s),
                              jzobrist.symmetry_hashes(s),
                              jzobrist.canonical_hash(s)))(js)
    got = (zobrist.hash_states(positions), zobrist.symmetry_hashes(positions),
           zobrist.canonical_hash(positions))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), u64_to_int64(w))


def test_host_hashes_match_jax_and_batched(positions):
    batched = zobrist.symmetry_hashes(positions).numpy().view(np.uint64)
    for i in range(8):
        b, w, m = _host(positions, i)
        assert zobrist.hash_ints(b, w, m) == jzobrist.hash_ints(b, w, m)
        syms = zobrist.symmetry_hashes_ints(b, w, m)
        assert syms == jzobrist.symmetry_hashes_ints(b, w, m)
        assert syms == [int(x) for x in batched[i]]
        for s in range(8):
            assert zobrist.transform_bits(b, s) == \
                jzobrist.transform_bits(b, s)


# ------------------------------------------------------------ the table
def test_transposition_table_sequence_matches_jax(positions):
    """The same stores and lookups (symmetric variants, both kinds, LRU
    eviction at capacity 6) give the same answers and counters."""
    rng = np.random.default_rng(3)
    tables = (TranspositionTable(capacity=6), JTable(capacity=6))
    for step in range(60):
        i = int(rng.integers(0, 10))
        b, w, m = _host(positions, i)
        s = int(rng.integers(0, 8))
        b, w = zobrist.transform_bits(b, s), zobrist.transform_bits(w, s)
        op = rng.integers(0, 4)
        if op == 0:
            counts = rng.integers(0, 9, A).astype(np.float32)
            for t in tables:
                t.store(b, w, m, counts, float(step))
        elif op == 1:
            counts = rng.integers(0, 9, A).astype(np.float32)
            probs = rng.dirichlet(np.ones(A)).astype(np.float32)
            chosen = int(rng.integers(0, A))
            for t in tables:
                t.store(b, w, m, counts, -float(step), action_probs=probs,
                        chosen_action=chosen)
        else:
            lookup = "lookup" if op == 2 else "lookup_gumbel"
            got, want = (getattr(t, lookup)(b, w, m) for t in tables)
            assert (got is None) == (want is None), step
            if got is not None:
                for x, y in zip(got, want):
                    np.testing.assert_array_equal(np.asarray(x),
                                                  np.asarray(y))
    assert (len(tables[0]), tables[0].hits, tables[0].misses) == \
        (len(tables[1]), tables[1].hits, tables[1].misses)
    assert tables[0].hits > 0 and tables[0].misses > 0


# ------------------------------------------------------------ the board
@pytest.mark.parametrize("compat", [False, True], ids=["correct", "compat"])
def test_board_and_game_move_for_move(compat):
    """A random game through both packages' ReversiGame: moves, stones,
    scores, boards, canonical planes, printed board, hashes and history."""
    rng = np.random.default_rng(int(compat))
    tg, jg = tgame.ReversiGame(compat=compat), jgame.ReversiGame(
        compat=compat)
    assert str(tg.board) == str(jg.board)
    while not jg.game_over:
        moves = tg.get_valid_moves()
        assert moves == jg.get_valid_moves()
        r, c = moves[int(rng.integers(len(moves)))]
        assert tg.make_move(r, c) and jg.make_move(r, c)
        assert (tg.board.black, tg.board.white, tg.current_player) == \
            (jg.board.black, jg.board.white, jg.current_player)
        assert tg.get_score() == jg.get_score()
        assert tg.game_over == jg.game_over
        assert tg.get_zobrist_hash() == jg.get_zobrist_hash()
    assert tg.winner == jg.winner and tg.get_winner() is not None
    np.testing.assert_array_equal(tg.get_board_state(), jg.get_board_state())
    np.testing.assert_array_equal(tg.get_canonical_state(),
                                  jg.get_canonical_state())
    assert tg.get_symmetry_hashes() == jg.get_symmetry_hashes()
    assert str(tg.board) == str(jg.board)
    assert len(tg.move_history) == len(jg.move_history)
    assert not tg.make_move(0, 0)  # the game is over


def test_board_rejects_and_restores():
    b = tgame.Board()
    assert not b.make_move(0, 0)  # illegal: state unchanged
    assert b.get_score() == (2, 2) and b.current_player == tgame.BLACK
    assert not b.make_move(2, 3, player=tgame.WHITE)  # not white's turn
    copy = b.copy()
    assert b.make_move(2, 3)
    assert copy.get_score() == (2, 2) and b.get_score() == (4, 1)
    b.black, b.white = 0x1, 0x2
    assert (b.black, b.white) == (1, 2)
    assert b.state.black.shape == (1,) and b.state.black.device.type == "cpu"
    with pytest.raises(ValueError):
        tgame.Board(size=6)


# ---------------------------------------------------------------- MCTS
def _endgame_board(seed: int, empties: int, compat: bool = False):
    """A board ``empties`` empty squares from full (or earlier if the game
    ends), reached by random play, with the moves that reach it."""
    rng = np.random.default_rng(seed)
    board = tgame.Board(compat=compat)
    tokens = []
    while sum(board.get_score()) < 64 - empties and not board.game_over:
        moves = board.get_valid_moves()
        r, c = moves[int(rng.integers(len(moves)))]
        board.make_move(r, c)
        tokens.append(f"{chr(ord('a') + c)}{r + 1}")
    return board, tokens


@pytest.fixture(scope="module")
def tiny():
    return make_nets(14, 1, 8)


@pytest.mark.parametrize("compat", [False, True], ids=["correct", "compat"])
def test_exact_endgame_matches_jax(tiny, compat):
    jnet, variables, tnet, _ = tiny
    board, _ = _endgame_board(5 + compat, 10, compat)
    assert not board.game_over
    cfg = dict(num_simulations=4, exact_endgame_empties=12)
    tm = tsearch.MCTS(tnet, MCTSConfig(**cfg), compat=compat, device="cpu")
    jm = jsearch.MCTS(jnet, variables, JMCTSConfig(**cfg), compat=compat)
    for m in (tm, jm):  # node counts depend on the solvers' shared tables
        m.endgame_solver.clear()
    tprobs, tres = tm.get_action_probs(board.state, temperature=1.0)
    jstate = jax.tree_util.tree_map(lambda x: x[0:1],
                                    to_jax_state(board.state))
    jprobs, jres = jm.get_action_probs(jstate, jax.random.PRNGKey(0))
    assert isinstance(tres, tsearch.ExactResult)
    assert isinstance(jres, jsearch.ExactResult)
    assert (tres.disc_diff, tres.nodes) == (jres.disc_diff, jres.nodes)
    assert int(tres.chosen_action[0]) == int(jres.chosen_action[0])
    np.testing.assert_array_equal(tprobs.numpy(), np.asarray(jprobs))
    np.testing.assert_array_equal(tres.root_value.numpy(),
                                  np.asarray(jres.root_value))


def _puct_config(**kw):
    return MCTSConfig(**{**dict(num_simulations=8, max_depth=4,
                                num_stages=2), **kw})


def test_mcts_search_is_run_search_and_the_table_hits(tiny):
    """A noise-free query equals run_search at the same settings; asking
    again (and in a rotated orientation) hits the table and returns the
    same counts, permuted; swapping the net clears the table."""
    _, _, tnet, _ = tiny
    board, _ = _endgame_board(7, 40)
    tt = TranspositionTable()
    m = tsearch.MCTS(tnet, _puct_config(), transposition_table=tt,
                     device="cpu")
    probs, res = m.get_action_probs(board.state, add_noise=False)
    want = tsearch.run_search(tnet, board.state, num_simulations=8,
                              c_puct=1.0, dirichlet_alpha=0.03,
                              dirichlet_epsilon=0.25, max_depth=4,
                              add_noise=False, num_stages=2, device="cpu")
    assert torch.equal(res.visit_counts, want.visit_counts)
    assert (tt.hits, tt.misses, len(tt)) == (0, 1, 1)
    again_probs, again = m.get_action_probs(board.state, add_noise=False)
    assert tt.hits == 1 and again.tree is None
    assert torch.equal(again.visit_counts, res.visit_counts.float())
    assert torch.equal(again_probs, probs)
    # the same position rotated by symmetry 1 hits too, counts permuted
    rot = tgame.Board()
    rot.black, rot.white = (zobrist.transform_bits(x, 1)
                            for x in (board.black, board.white))
    rot.current_player = board.current_player
    rot._state = rot.state._replace(to_move=board.state.to_move)
    _, hit = m.get_action_probs(rot.state, add_noise=False)
    assert tt.hits == 2
    # query square i is the stored position's square PERMS[1, i]
    np.testing.assert_array_equal(
        hit.visit_counts[0, :64].numpy(),
        res.visit_counts[0, symmetry.PERMS[1]].float().numpy())
    # noised queries bypass the table
    m.get_action_probs(board.state, generator=torch.Generator()
                       .manual_seed(0))
    assert (tt.hits, tt.misses) == (2, 1)
    m.net = make_nets(15, 1, 8)[2]
    assert len(tt) == 0


def test_mcts_gumbel_and_compat_table_downgrade(tiny):
    _, _, tnet, _ = tiny
    tt = TranspositionTable()
    m = tsearch.MCTS(tnet, _puct_config(algorithm="gumbel",
                                        max_considered_actions=4),
                     compat=True, transposition_table=tt, device="cpu")
    assert not tt.use_symmetry
    state = tenv.initial_state((1,))
    probs, res = m.get_action_probs(state, temperature=0.0,
                                    add_noise=False)
    _, hit = m.get_action_probs(state, temperature=0.0, add_noise=False)
    assert tt.hits == 1 and int(hit.chosen_action[0]) == int(
        res.chosen_action[0]) == int(probs[0].argmax())
    full = TranspositionTable()
    full.store(1, 2, 1, np.zeros(A, np.float32), 0.0)
    with pytest.raises(ValueError, match="symmetry"):
        tsearch.MCTS(tnet, _puct_config(), compat=True,
                     transposition_table=full, device="cpu")


# ------------------------------------------------------------- interop
@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A reference-format .pth written by the JAX package's exporter from
    a 2x16 float32 net, and the JAX net's outputs on random positions."""
    jnet, variables, _, _ = make_nets(16, 2, 16)
    path = str(tmp_path_factory.mktemp("pth") / "best_model.pth")
    jcfg = JModelConfig(num_res_blocks=2, num_filters=16,
                        value_head_hidden_size=16, compute_dtype="float32")
    jinterop.export_torch_checkpoint(variables, path, jcfg)
    states = random_positions(16, 17)
    planes = tenv.canonical_planes(states)
    want = jax.jit(lambda p: jresnet.apply_eval(jnet, variables, p))(
        jnp.asarray(planes.numpy()))
    return path, planes, want, variables


def test_imported_reference_checkpoint_matches_jax(exported):
    path, planes, (jlogits, jvalue), _ = exported
    cfg = ModelConfig(num_res_blocks=2, num_filters=16,
                      value_head_hidden_size=16, compute_dtype="float32")
    sd, inferred = interop.import_torch_checkpoint(path, cfg)
    assert inferred is cfg
    net = tresnet.build_network(cfg)
    net.load_state_dict(sd)
    logits, value = tresnet.apply_eval(net, planes)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=1e-4)


def test_export_import_round_trip_and_wrappers(exported, tmp_path):
    """The port's export of the imported weights is what JAX imports back
    to the same Flax variables; the wrapper and TorchScript-key forms load
    the same; a BN-free net and a wrong architecture raise."""
    path, _, _, variables = exported
    sd, cfg = interop.import_torch_checkpoint(path)
    assert (cfg.num_res_blocks, cfg.num_filters,
            cfg.value_head_hidden_size) == (2, 16, 16)
    out = str(tmp_path / "again.pth")
    interop.export_torch_checkpoint(sd, out, cfg)
    back, _ = jinterop.import_torch_checkpoint(out)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    raw = torch.load(path)
    torch.save({"model_state_dict": raw, "epoch": 3},
               str(tmp_path / "wrapped.pth"))
    scripted = {f"_script_module.{k}": v * 0 for k, v in raw.items()}
    torch.save({**raw, **scripted}, str(tmp_path / "scripted.pth"))
    for name in ("wrapped.pth", "scripted.pth"):
        got, _ = interop.import_torch_checkpoint(str(tmp_path / name))
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="BN-free"):
        interop.export_torch_checkpoint(
            sd, out, dataclasses.replace(cfg, use_batch_norm=False))
    with pytest.raises(ValueError, match="num_filters"):
        interop.import_torch_checkpoint(
            path, dataclasses.replace(cfg, num_filters=32))


class _Payload:
    """An object that only arbitrary unpickling can rebuild."""


def test_import_refuses_arbitrary_pickles(exported, tmp_path):
    """The reference forms load tensors-only; a ``.pth`` that holds any
    other object raises a ValueError naming the file, unloaded."""
    raw = torch.load(exported[0])
    bad = str(tmp_path / "bad.pth")
    torch.save({"model_state_dict": raw, "extra": _Payload()}, bad)
    with pytest.raises(ValueError, match="bad.pth"):
        interop.import_torch_checkpoint(bad)


def test_cli_imports_a_full_state_reference_checkpoint(exported, tmp_path,
                                                      capsys):
    """The reference's full-state checkpoint (model, Adam and MultiStepLR
    state dicts, the iteration, ``best_elo`` as a numpy scalar, a config
    dict and metrics holding numpy scalars) imports through the CLI,
    without arbitrary unpickling; one that also holds a numpy array, which
    needs it, still raises the ValueError that names the file."""
    raw = torch.load(exported[0])
    params = [torch.nn.Parameter(v.clone()) for v in raw.values()
              if v.is_floating_point()]
    opt = torch.optim.Adam(params, lr=1e-3)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, [10, 20], 0.1)
    full = {"model_state_dict": raw, "optimizer_state_dict": opt.state_dict(),
            "scheduler_state_dict": sched.state_dict(), "iteration": 7,
            "best_elo": np.float64(1234.5),
            "config": {"model": {"num_filters": 16}, "lr": 1e-3,
                       "milestones": [10, 20], "name": "ref"},
            "metrics": {"loss": np.float32(0.75), "elo": [np.float64(1200.0)],
                        "games": np.int64(64)}}
    path = str(tmp_path / "full.pth")
    torch.save(full, path)
    ckpt_dir = str(tmp_path / "ckpt")
    assert cli.main(["--device", "cpu", "import-checkpoint", path,
                     "-d", ckpt_dir]) == 0
    assert "2x16 net, board 8" in capsys.readouterr().out
    want, _ = interop.import_torch_checkpoint(exported[0])
    got = ckpt.restore_best(ckpt_dir)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    bad = str(tmp_path / "array.pth")
    torch.save({**full, "metrics": {"losses": np.zeros(3)}}, bad)
    with pytest.raises(ValueError, match="array.pth"):
        interop.import_torch_checkpoint(bad)


# ----------------------------------------------------------------- CLI
def _cli_config(tmp_path, algorithm="puct") -> str:
    cfg = Config()
    cfg.model = ModelConfig(num_res_blocks=2, num_filters=16,
                            value_head_hidden_size=16,
                            compute_dtype="float32")
    cfg.mcts = dataclasses.replace(cfg.mcts, algorithm=algorithm,
                                   num_simulations=8, max_depth=4,
                                   max_considered_actions=4)
    path = str(tmp_path / "config.json")
    cfg.save(path)
    return path


def test_cli_import_then_analyze(exported, tmp_path, capsys):
    path = exported[0]
    ckpt_dir = str(tmp_path / "ckpt")
    cfg_path = _cli_config(tmp_path)
    assert cli.main(["--device", "cpu", "import-checkpoint", path,
                     "-d", ckpt_dir]) == 0
    assert "2x16 net, board 8" in capsys.readouterr().out
    assert ckpt.restore_best(ckpt_dir) is not None
    assert cli.main(["--device", "cpu", "analyze", "-c", cfg_path,
                     "-d", ckpt_dir, "--top", "3", "d3", "c5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-6:-4] == ["X 3 - O 3, black (X) to move", ""]
    assert out[-4].startswith("root value (black to move):")
    assert out[-4].endswith("[8 simulations]")
    assert len(out) == 15 and all("visits" in x for x in out[-3:])
    assert sum(int(x.split()[2]) for x in out[-3:]) <= 8
    # a directory without a best model, an illegal move, a bad token
    for argv in (["-d", str(tmp_path / "none")], ["e5"], ["z9"]):
        assert cli.main(["--device", "cpu", "analyze", "-c", cfg_path,
                         *argv]) == 1


def test_cli_analyze_solves_endgames(tmp_path, capsys):
    board, tokens = _endgame_board(8, 12)
    cfg_path = _cli_config(tmp_path, algorithm="gumbel")
    assert cli.main(["--device", "cpu", "analyze", "-c", cfg_path,
                     "--solve", "14", *tokens]) == 0
    out = capsys.readouterr().out
    solved = tsearch.MCTS(
        make_nets(14, 1, 8)[2], MCTSConfig(exact_endgame_empties=14),
        device="cpu")._exact_endgame((board.black, board.white,
                                      board.current_player, 0, False))
    assert f"{solved.disc_diff:+d} discs under optimal play" in out
    assert "optimal move: " in out
    assert cli.main(["--device", "cpu", "analyze", "-c", cfg_path,
                     "--sims", "6", "d3"]) == 0  # gumbel, no solve
    assert "[6 simulations]" in capsys.readouterr().out


def test_cli_play_reads_moves_from_stdin(tmp_path, capsys, monkeypatch):
    """Human black: a bad token, an illegal move, two legal moves (the
    agent answers each), then 'q'. As white, end of input aborts after the
    agent's opening move."""
    cfg_path = _cli_config(tmp_path)
    lines = iter(["zz", "a1", "d3", "pass", "q"])

    def fake_input(prompt=""):
        print(prompt, end="")
        return next(lines)

    monkeypatch.setattr(builtins, "input", fake_input)
    assert cli.main(["--device", "cpu", "play", "-c", cfg_path]) == 0
    out = capsys.readouterr().out
    assert "bad move 'zz'" in out and "illegal move 'a1'" in out
    assert out.count("agent plays ") == 1  # 'pass' is illegal here
    assert "illegal move 'pass'" in out and out.endswith("game aborted\n")

    def no_input(prompt=""):
        raise EOFError

    monkeypatch.setattr(builtins, "input", no_input)
    assert cli.main(["--device", "cpu", "play", "-c", cfg_path,
                     "--color", "white", "--sims", "4"]) == 0
    out = capsys.readouterr().out
    assert out.count("agent plays ") == 1 and "game aborted" in out
