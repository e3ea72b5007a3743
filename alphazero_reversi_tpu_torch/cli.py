"""Command-line interface of the PyTorch port.

Port of ``alphazero_reversi_tpu/cli.py``: ``create-config``, ``train``,
``continue`` (``train --resume``), ``tournament`` (a round robin over a
directory's ``it_*`` and ``best_model`` checkpoints plus the random
baseline, with a persistent ELO file), and the host play commands:
``analyze`` (search one position and print the top moves, or solve it
exactly), ``play`` (a match against the agent; moves come from stdin, so a
script can drive it) and ``import-checkpoint`` (a reference ``.pth`` into a
best model). They read the same config files as the JAX package and run on
the card unless ``--device`` says otherwise::

    python -m alphazero_reversi_tpu_torch.cli train -c configs/flagship_run.json
    python -m alphazero_reversi_tpu_torch.cli continue -c configs/flagship_run.json
    python -m alphazero_reversi_tpu_torch.cli tournament --model-dir checkpoints
    python -m alphazero_reversi_tpu_torch.cli analyze -d checkpoints d3 c5
    python -m alphazero_reversi_tpu_torch.cli play -d checkpoints --color white
    python -m alphazero_reversi_tpu_torch.cli import-checkpoint best_model.pth -d checkpoints
"""
from __future__ import annotations

import argparse
import datetime
import glob
import os
import sys
from typing import List, Optional

import torch

from . import checkpoint as ckpt_lib
from .arena import Arena
from .config import Config, MCTSConfig, get_default_config
from .elo import ELORatingSystem
from .env.game import Board
from .mcts import search as search_lib
from .mcts.search import resolve_device
from .models import resnet
from .pipeline import AlphaZeroPipeline


def _load_config(path: Optional[str]) -> Config:
    return Config.load(path) if path else get_default_config()


def _make_run_dirs(config: Config, output_dir: str) -> str:
    """Timestamped run dir with every output path rewritten into it."""
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    run_dir = os.path.join(output_dir, f"run_{ts}")
    os.makedirs(run_dir, exist_ok=True)
    config.training.checkpoint_dir = os.path.join(run_dir, "checkpoints")
    config.logging.log_dir = os.path.join(run_dir, "logs")
    config.self_play.save_dir = os.path.join(run_dir, "self_play_data")
    config.tournament.output_dir = os.path.join(run_dir,
                                                "tournament_results")
    config.save(os.path.join(run_dir, "config.json"))
    return run_dir


def cmd_create_config(args) -> int:
    """Write a default config file."""
    get_default_config().save(args.output)
    print(f"wrote default config to {args.output}")
    return 0


def cmd_train(args) -> int:
    config = _load_config(args.config)
    if args.iterations is not None:
        config.training.num_epochs = args.iterations
    if args.run_dir:
        _make_run_dirs(config, args.run_dir)
    run_name = args.run_name or (
        f"{config.project_name}_"
        f"{datetime.datetime.now().strftime('%Y%m%d_%H%M%S')}")
    pipe = AlphaZeroPipeline(config, run_name=run_name, device=args.device)
    if args.resume:
        pipe.load_checkpoint(args.checkpoint)
    pipe.train()
    return 0


def cmd_tournament(args) -> int:
    """Round robin over the checkpoints in ``--model-dir`` and the random
    baseline; ratings persist in the config's ELO file."""
    config = _load_config(args.config)
    device = resolve_device(args.device)
    ar = Arena(config.tournament, compat=config.env_compat, device=device)
    found: List[str] = []
    for pattern in ("it_*", "best_model"):
        found.extend(sorted(glob.glob(os.path.join(args.model_dir,
                                                   pattern))))
    for path in found:
        name = os.path.basename(path)
        try:
            if name == "best_model":
                weights = ckpt_lib.restore_best(args.model_dir)
            else:
                weights = ckpt_lib.restore_checkpoint(path)["learner"]["net"]
            net = resnet.build_network(config.model)
            net.load_state_dict(weights)
        except Exception as e:  # skip checkpoints of another config
            print(f"skipping {name}: {e}", file=sys.stderr)
            continue
        ar.add_player(name, net)
    ar.add_player("random", None)

    elo_path = os.path.join(config.tournament.output_dir,
                            config.tournament.elo_file)
    if os.path.exists(elo_path):  # ratings persist across runs
        ar.elo = ELORatingSystem.load_ratings(elo_path)
        for p in ar.players:
            ar.elo.add_player(p.name)

    board = ar.run_tournament(config.seed, rounds=args.rounds)
    for i, p in enumerate(board):
        print(f"{i + 1:2d}. {p['player_id']:<30s} "
              f"{p['rating']:7.1f}  ({p['games_played']} games)")
    ar.save_results(elo_path)
    print(f"ratings saved to {elo_path}")
    return 0


def _parse_move_token(token: str):
    """One move token, ``pass``, algebraic (``d3``) or ``row,col``, as a
    validated (row, col) pair; ValueError says what is wrong with it."""
    t = token.strip().lower()
    if t == "pass":
        return -1, -1
    if "," in t:
        parts = t.split(",")
        if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
            raise ValueError("expected ROW,COL with integers 0-7")
        r, c = (int(p) for p in parts)
    else:
        if (len(t) < 2 or not ("a" <= t[0] <= "h")
                or not t[1:].isdigit()):
            raise ValueError(
                "expected algebraic a1-h8, ROW,COL, or 'pass'")
        c, r = ord(t[0]) - ord("a"), int(t[1:]) - 1
    if not (0 <= r < 8 and 0 <= c < 8):
        raise ValueError(f"square ({r},{c}) is off the 8x8 board")
    return r, c


def _action_name(action: int) -> str:
    """65-way action index -> 'pass' or algebraic a1-h8."""
    if action == 64:
        return "pass"
    return f"{chr(ord('a') + action % 8)}{action // 8 + 1}"


def _net_from_args(config: Config, checkpoint_dir: Optional[str], device):
    """The configured net on ``device``: the best model under
    ``checkpoint_dir``, or untrained weights from the config's seed when no
    directory is given. None when the directory has no best model."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        net = resnet.build_network(config.model)
    if checkpoint_dir:
        weights = ckpt_lib.restore_best(checkpoint_dir)
        if weights is None:
            return None
        net.load_state_dict(weights)
    return net.to(device)


def _play_mcts(config: Config, net, sims: int, solve: Optional[int],
               device, transposition_table=None) -> search_lib.MCTS:
    """The configured search at ``sims`` simulations, with exact endgames
    at ``solve`` empties (default: the config's)."""
    m = config.mcts
    return search_lib.MCTS(
        net, MCTSConfig(
            num_simulations=sims, c_puct=m.c_puct, max_depth=m.max_depth,
            batch_size=m.batch_size, num_stages=m.num_stages,
            algorithm=m.algorithm,
            max_considered_actions=m.max_considered_actions,
            c_visit=m.c_visit, c_scale=m.c_scale,
            exact_endgame_empties=(solve if solve is not None
                                   else m.exact_endgame_empties)),
        compat=config.env_compat, transposition_table=transposition_table,
        device=device)


def cmd_analyze(args) -> int:
    """Play the given moves from the initial board, search the position
    noise-free, and print the top moves with their visit counts and the
    root value (or the exact solve at few enough empties)."""
    config = _load_config(args.config)
    device = resolve_device(args.device)
    net = _net_from_args(config, args.checkpoint_dir, device)
    if net is None:
        print(f"no best checkpoint under {args.checkpoint_dir}",
              file=sys.stderr)
        return 1
    board = Board(compat=config.env_compat)
    for token in args.moves:
        try:
            r, c = _parse_move_token(token)
        except ValueError as e:
            print(f"bad move {token!r}: {e}", file=sys.stderr)
            return 1
        if not board.make_move(r, c):
            print(f"illegal move {token!r} at this position",
                  file=sys.stderr)
            return 1
    print(board)

    sims = args.sims or config.mcts.num_simulations
    leaf_batch = max(1, config.mcts.batch_size)
    if sims % leaf_batch:
        rounded = -(-sims // leaf_batch) * leaf_batch
        print(f"note: rounding --sims {sims} up to {rounded} "
              f"(a multiple of mcts.batch_size={leaf_batch})",
              file=sys.stderr)
        sims = rounded
    mcts = _play_mcts(config, net, sims, args.solve, device)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    _, result = mcts.get_action_probs(board.state, gen, temperature=1.0,
                                      add_noise=False)
    mover = "black" if board.current_player == 1 else "white"
    if isinstance(result, search_lib.ExactResult):
        print(f"\nexact endgame solve ({mover} to move): "
              f"{result.disc_diff:+d} discs under optimal play   "
              f"[{result.nodes} solver nodes]")
        print(f"  optimal move: {_action_name(int(result.chosen_action[0]))}")
        return 0
    vc = result.visit_counts[0].cpu().numpy()
    value = float(result.root_value[0])
    print(f"\nroot value ({mover} to move): {value:+.3f}   "
          f"[{sims} simulations]")
    shown = 0
    for a in vc.argsort()[::-1]:
        if vc[a] == 0 or shown >= args.top:
            break
        print(f"  {_action_name(int(a)):>5s}  visits {int(vc[a]):5d}  "
              f"({vc[a] / max(vc.sum(), 1):5.1%})")
        shown += 1
    return 0


def cmd_play(args) -> int:
    """A terminal match against the agent. The human's moves are read from
    stdin: algebraic (d3), ROW,COL or 'pass'; 'q' (or the end of input)
    quits. The agent searches noise-free at --sims with a transposition
    table, and plays exact endgames when --solve /
    mcts.exact_endgame_empties is set."""
    from .mcts.transposition import TranspositionTable

    config = _load_config(args.config)
    device = resolve_device(args.device)
    net = _net_from_args(config, args.checkpoint_dir, device)
    if net is None:
        print(f"no best checkpoint under {args.checkpoint_dir}",
              file=sys.stderr)
        return 1
    human = 1 if args.color == "black" else 2
    sims = args.sims or config.mcts.num_simulations
    solve = (args.solve if args.solve is not None
             else config.mcts.exact_endgame_empties)
    # repeated positions hit the table instead of searching again
    mcts = _play_mcts(config, net, sims, solve, device,
                      transposition_table=TranspositionTable())
    gen = torch.Generator(device=device).manual_seed(config.seed)
    board = Board(compat=config.env_compat)
    print(f"you play {'black (X)' if human == 1 else 'white (O)'} — "
          f"agent at {sims} simulations"
          + (f", exact endgames at <={solve} empties" if solve else ""))
    print("moves: algebraic (d3), ROW,COL, 'pass'; 'q' to quit")
    while not board.game_over:
        print()
        print(board)
        if board.current_player == human:
            legal = board.get_valid_moves()
            if not legal:
                print("no legal moves — you must pass")
            try:
                token = input("your move> ").strip()
            except EOFError:
                token = "q"
            if token.lower() in ("q", "quit", "resign", "exit"):
                print("game aborted")
                return 0
            try:
                r, c = _parse_move_token(token)
            except ValueError as e:
                print(f"bad move {token!r}: {e}")
                continue
            if not board.make_move(r, c):
                names = ", ".join(_action_name(rr * 8 + cc)
                                  for rr, cc in legal) or "pass"
                print(f"illegal move {token!r} here (legal: {names})")
                continue
        else:
            probs, result = mcts.get_action_probs(
                board.state, gen, temperature=0.0, add_noise=False)
            action = int(probs[0].argmax())
            exact = isinstance(result, search_lib.ExactResult)
            print(f"agent plays {_action_name(action)}"
                  + (f" (exact: {result.disc_diff:+d} discs optimal)"
                     if exact else ""))
            if not board.make_move(*((-1, -1) if action == 64
                                     else divmod(action, 8))):
                raise RuntimeError("the agent produced an illegal move")

    print()
    print(board)
    nb, nw = board.get_score()
    w = board.winner or 0
    outcome = ("draw" if w == 0
               else "you win!" if w == human else "agent wins")
    print(f"game over: X {nb} - O {nw} — {outcome}")
    return 0


def cmd_import_checkpoint(args) -> int:
    """A reference PyTorch ``.pth`` into the best model under
    ``--checkpoint-dir`` (``interop.import_checkpoint``)."""
    from . import interop

    cfg = interop.import_checkpoint(args.pth, args.checkpoint_dir)
    print(f"imported {args.pth} -> {args.checkpoint_dir} "
          f"(best): {cfg.num_res_blocks}x{cfg.num_filters} net, "
          f"board {cfg.board_size}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m alphazero_reversi_tpu_torch.cli",
        description="AlphaZero Reversi on one CUDA GPU (PyTorch port)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs on the host)")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("create-config", help="write a default config file")
    c.add_argument("--output", "-o", default="config.json")
    c.set_defaults(fn=cmd_create_config)

    def run_args(q):
        q.add_argument("--config", "-c", default=None)
        q.add_argument("--iterations", type=int, default=None,
                       help="override training.num_epochs (the total, "
                            "counting a resumed run's iterations)")
        q.add_argument("--run-dir", default=None,
                       help="create a timestamped run dir here")
        q.add_argument("--run-name", default=None,
                       help="run name for logs (default: "
                            "<project_name>_<timestamp>)")
        q.add_argument("--checkpoint", default=None,
                       help="explicit checkpoint path to resume from")

    t = sub.add_parser("train", help="run the training pipeline")
    run_args(t)
    t.add_argument("--resume", action="store_true")
    t.set_defaults(fn=cmd_train)

    k = sub.add_parser("continue", help="resume training from the latest "
                                        "checkpoint")
    run_args(k)
    k.set_defaults(fn=cmd_train, resume=True)

    m = sub.add_parser("tournament", help="round-robin ELO tournament over "
                                          "checkpoints")
    m.add_argument("--config", "-c", default=None)
    m.add_argument("--model-dir", required=True)
    m.add_argument("--rounds", type=int, default=None)
    m.set_defaults(fn=cmd_tournament)

    a = sub.add_parser("analyze",
                       help="search a position and print the top moves")
    a.add_argument("moves", nargs="*",
                   help="moves from the initial position (algebraic like "
                        "'d3', 'r,c' pairs, or 'pass')")
    a.add_argument("--config", "-c", default=None)
    a.add_argument("--checkpoint-dir", "-d", default=None,
                   help="load the 'best' model from here (default: "
                        "untrained net)")
    a.add_argument("--sims", type=int, default=None)
    a.add_argument("--top", type=int, default=8)
    a.add_argument(
        "--solve", type=int, default=None, metavar="EMPTIES",
        help="solve the position exactly (native alpha-beta, "
             "env/endgame.py) when it has at most EMPTIES empty squares, "
             "overriding mcts.exact_endgame_empties")
    a.set_defaults(fn=cmd_analyze)

    g = sub.add_parser("play",
                       help="play against the agent in the terminal")
    g.add_argument("--config", "-c", default=None)
    g.add_argument("--checkpoint-dir", "-d", default=None,
                   help="load the 'best' model from here (default: "
                        "untrained net)")
    g.add_argument("--color", choices=["black", "white"], default="black",
                   help="your color (black moves first)")
    g.add_argument("--sims", type=int, default=None)
    g.add_argument(
        "--solve", type=int, default=None, metavar="EMPTIES",
        help="agent plays exact endgames at <= EMPTIES empty squares "
             "(overrides mcts.exact_endgame_empties)")
    g.set_defaults(fn=cmd_play)

    i = sub.add_parser(
        "import-checkpoint",
        help="migrate a reference PyTorch .pth into a 'best' checkpoint "
             "that analyze, play, tournament and train load")
    i.add_argument("pth", help="reference .pth (raw state_dict or "
                               "{'model_state_dict': ...} wrapper)")
    i.add_argument("--checkpoint-dir", "-d", required=True)
    i.set_defaults(fn=cmd_import_checkpoint)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
