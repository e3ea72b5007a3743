"""Batched self-play data generation on the device.

Port of ``alphazero_reversi_tpu/selfplay.py`` (the Gumbel branch).
``num_games`` games advance in lockstep: every move slot runs one batched
Gumbel search over all games, records the position, and steps every env.
Where the JAX package scans over move slots inside one program, this is a
Python loop; the batch-global tail skip becomes a host ``if`` per move.

Value targets are the final outcome from the perspective of the player to
move at each position; games still live at ``max_moves`` are scored by piece
count. With ``tree_reuse="root"`` the played child's root-edge statistics
seed the next move's search (zeros at move 0). Exact-value relabelling and
the PUCT branch are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .config import MCTSConfig, SelfPlayConfig
from .env import bitboard as env
from .mcts import gumbel as gumbel_lib
from .mcts import tree as tree_lib
from .mcts.search import resolve_device


class Trajectory(NamedTuple):
    """Self-play results; ``T`` move slots, ``B`` games. ``valid[t, b]``
    marks slots where game b was live; other rows are padding."""

    planes: torch.Tensor  # [T, B, 8, 8, 3] f32 canonical NN input
    policy: torch.Tensor  # [T, B, 65] f32 improved policy (the target)
    value: torch.Tensor  # [T, B] f32 outcome from the mover's perspective
    to_move: torch.Tensor  # [T, B] i32
    valid: torch.Tensor  # [T, B] bool
    final_state: env.EnvState  # [B] terminal (or cutoff) states
    actions: torch.Tensor  # [T, B] i32 played action (-1 on padding)


def _outcome_value(final: env.EnvState, to_move: torch.Tensor
                   ) -> torch.Tensor:
    """Outcome in {-1, 0, +1} from ``to_move``'s POV; games cut off before
    the end are scored by piece count."""
    nb, nw = env.score(final)
    count_winner = (nb > nw).to(torch.int32) * env.BLACK \
        + (nw > nb).to(torch.int32) * env.WHITE
    winner = torch.where(final.done, final.winner, count_winner)
    return (winner == to_move).float() - (winner == 3 - to_move).float()


@torch.no_grad()
def play_games(net, *, num_games: int, num_simulations: int, c_puct: float,
               dirichlet_alpha: float, dirichlet_epsilon: float,
               temp_threshold: int, temp_init: float, temp_final: float,
               max_depth: int = 64, max_moves: int = 60,
               compat: bool = False, num_stages: int = 6,
               leaf_batch: int = 1, algorithm: str = "puct",
               max_considered_actions: int = 16, c_visit: float = 50.0,
               c_scale: float = 0.1, tree_reuse: str = "off",
               tree_reuse_discount: float = 1.0,
               init_states: Optional[env.EnvState] = None,
               generator: Optional[torch.Generator] = None,
               gumbel_noise: Optional[torch.Tensor] = None,
               device=None) -> Trajectory:
    """Play ``num_games`` games in lockstep on ``device`` (default CUDA;
    the net must already be there).

    The arguments mirror the JAX ``play_games`` (``search_kwargs`` builds
    them from configs); the PUCT-only ones are accepted for that reason.
    ``gumbel_noise`` ([max_moves, B, A]) replaces the per-move Gumbel draws;
    otherwise they come from ``generator`` on the device.
    """
    if algorithm == "puct":
        raise NotImplementedError(
            "PUCT self-play is not ported yet (ROADMAP.md queue 1 item 9); "
            "use algorithm='gumbel'")
    if algorithm != "gumbel":
        raise ValueError(f"unknown search algorithm {algorithm!r}")
    if tree_reuse not in ("off", "root"):
        raise ValueError(f"unknown tree_reuse mode {tree_reuse!r}")
    dev = resolve_device(device)
    if any(p.device != dev for p in net.parameters()):
        raise ValueError(f"the net's parameters must be on {dev}")
    states = init_states if init_states is not None \
        else env.initial_state((num_games,), device=dev)
    b = states.done.shape[0]
    warm = None
    if tree_reuse == "root":
        warm = (torch.zeros(b, env.NUM_ACTIONS, device=dev),
                torch.zeros(b, env.NUM_ACTIONS, device=dev))

    records = []
    for t in range(max_moves):
        live = ~states.done
        if not bool(live.any()):
            # every game finished: skip the search; records are padding
            records.append((torch.zeros(b, 8, 8, 3, device=dev),
                            torch.zeros(b, env.NUM_ACTIONS, device=dev),
                            states.to_move, live,
                            torch.full((b,), -1, dtype=torch.int32,
                                       device=dev)))
            continue
        gres = gumbel_lib.run_gumbel_search(
            net, states, num_simulations=num_simulations,
            max_considered_actions=max_considered_actions,
            c_visit=c_visit, c_scale=c_scale, gumbel_scale=1.0,
            max_depth=max_depth, compat=compat, num_stages=num_stages,
            leaf_batch=leaf_batch, warm_root=warm,
            warm_discount=tree_reuse_discount,
            gumbel=None if gumbel_noise is None else gumbel_noise[t],
            generator=generator, device=dev)
        actions = gres.chosen_action
        records.append((env.canonical_planes(states, compat=compat),
                        gres.action_probs, states.to_move, live,
                        torch.where(live, actions, -1)))
        new_states, _ = env.step(states, actions, compat=compat)
        if warm is not None:
            wv, ws = tree_lib.root_child_warm_stats(gres.tree, actions)
            lc = live[:, None]
            warm = (torch.where(lc, wv, 0.0), torch.where(lc, ws, 0.0))
        # finished games hold their position
        states = env.where_state(states.done, states, new_states)

    planes, policy, to_move, valid, actions = (
        torch.stack(x) for x in zip(*records))
    value = torch.where(valid, _outcome_value(states, to_move), 0.0)
    return Trajectory(planes=planes, policy=policy, value=value,
                      to_move=to_move, valid=valid, final_state=states,
                      actions=actions)


def flatten_trajectory(traj: Trajectory) -> Tuple[torch.Tensor, ...]:
    """[T, B, ...] -> flat [T*B, ...] ``(planes, policy, value, valid)``;
    padding rows are kept and masked by ``valid``."""
    t, b = traj.valid.shape
    return (traj.planes.reshape(t * b, *traj.planes.shape[2:]),
            traj.policy.reshape(t * b, traj.policy.shape[-1]),
            traj.value.reshape(t * b),
            traj.valid.reshape(t * b))


def search_kwargs(mcts_config: MCTSConfig, sp_config: SelfPlayConfig,
                  compat: bool = False) -> Dict[str, Any]:
    """``play_games`` keyword arguments from configs."""
    return dict(
        num_simulations=mcts_config.num_simulations,
        c_puct=mcts_config.c_puct,
        dirichlet_alpha=mcts_config.dirichlet_alpha,
        dirichlet_epsilon=mcts_config.dirichlet_epsilon,
        temp_threshold=sp_config.temp_threshold,
        temp_init=sp_config.temp_init,
        temp_final=sp_config.temp_final,
        max_depth=mcts_config.max_depth,
        max_moves=sp_config.max_moves,
        compat=compat,
        num_stages=mcts_config.num_stages,
        leaf_batch=mcts_config.batch_size,
        algorithm=mcts_config.algorithm,
        max_considered_actions=mcts_config.max_considered_actions,
        c_visit=mcts_config.c_visit,
        c_scale=mcts_config.c_scale,
        tree_reuse=mcts_config.tree_reuse,
        tree_reuse_discount=mcts_config.tree_reuse_discount,
    )


class SelfPlay:
    """Object wrapper over ``play_games`` (the reference's ``SelfPlay``
    surface): the net moves to ``device`` (default CUDA)."""

    def __init__(self, net, mcts_config: MCTSConfig,
                 sp_config: SelfPlayConfig, compat: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.mcts_config = mcts_config
        self.sp_config = sp_config
        self.compat = compat

    def generate_games(self, seed: int, num_games: Optional[int] = None
                       ) -> Trajectory:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return play_games(
            self.net, num_games=num_games or self.sp_config.num_parallel_games,
            generator=gen, device=self.device,
            **search_kwargs(self.mcts_config, self.sp_config, self.compat))

    def generate_training_data(self, seed: int,
                               num_games: Optional[int] = None):
        """Flat ``(planes, policy, value, valid)`` arrays."""
        return flatten_trajectory(self.generate_games(seed, num_games))
