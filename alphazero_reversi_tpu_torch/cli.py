"""Command-line interface of the PyTorch port.

Port of the training and tournament commands of
``alphazero_reversi_tpu/cli.py``: ``create-config``, ``train``,
``continue`` (``train --resume``) and ``tournament`` (a round robin over a
directory's ``it_*`` and ``best_model`` checkpoints plus the random
baseline, with a persistent ELO file). They read the same config files as
the JAX package and run on the card unless ``--device`` says otherwise::

    python -m alphazero_reversi_tpu_torch.cli train -c configs/flagship_run.json
    python -m alphazero_reversi_tpu_torch.cli continue -c configs/flagship_run.json
    python -m alphazero_reversi_tpu_torch.cli tournament --model-dir checkpoints
"""
from __future__ import annotations

import argparse
import datetime
import glob
import os
import sys
from typing import List, Optional

from . import checkpoint as ckpt_lib
from .arena import Arena
from .config import Config, get_default_config
from .elo import ELORatingSystem
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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
