"""A tiny run config for driving the port's pipeline and CLI end to end
(CPU tests and the card smoke run). JAX-free."""
from __future__ import annotations

import os

from alphazero_reversi_tpu_torch.config import Config


def tiny_run_config(root: str, *, blocks: int = 1, filters: int = 8,
                    games: int = 4, max_moves: int = 12,
                    exact_value_empties: int = 0, gate_simulations: int = 1,
                    use_tensorboard: bool = False) -> Config:
    """Gumbel-4 self-play of ``games`` games on a ``blocks`` x ``filters``
    float32 net, SGD in chunks of 2 steps at batch 16, and a gate of
    ``gate_simulations`` (1 round, 2 games per pair, merged pairings, tree
    reuse); every output under ``root``."""
    cfg = Config()
    cfg.project_name = "tiny"
    cfg.seed = 7
    m = cfg.model
    m.num_res_blocks, m.num_filters = blocks, filters
    m.value_head_hidden_size, m.compute_dtype = 16, "float32"
    mc = cfg.mcts
    mc.algorithm, mc.num_simulations, mc.max_considered_actions = \
        "gumbel", 4, 4
    mc.max_depth, mc.num_stages, mc.tree_reuse = 4, 1, "root"
    sp = cfg.self_play
    sp.num_games = sp.num_parallel_games = games
    sp.max_moves, sp.save_every = max_moves, 1
    sp.exact_value_empties, sp.exact_value_budget_s = exact_value_empties, 0
    sp.save_dir = os.path.join(root, "self_play_data")
    tr = cfg.training
    tr.batch_size, tr.steps_per_dispatch, tr.replay_capacity = 16, 2, 512
    tr.num_epochs, tr.lr_milestones = 2, [1]
    tr.checkpoint_dir = os.path.join(root, "checkpoints")
    to = cfg.tournament
    to.algorithm, to.num_simulations, to.max_considered_actions = \
        "gumbel", gate_simulations, 2
    to.rounds, to.games_per_pair, to.merge_pairings = 1, 2, True
    to.tree_reuse, to.temperature = "root", 0.1
    to.output_dir = os.path.join(root, "tournament_results")
    lg = cfg.logging
    lg.log_dir, lg.use_tensorboard, lg.verbose = \
        os.path.join(root, "logs"), use_tensorboard, False
    return cfg
