"""Batched self-play data generation on the device.

Port of ``alphazero_reversi_tpu/selfplay.py``. ``num_games`` games advance
in lockstep: every move slot runs one batched search over all games,
records the position, and steps every env. Where the JAX package scans over
move slots inside one program, this is a Python loop; the batch-global tail
skip becomes a host ``if`` per move.

``algorithm="puct"`` searches with root Dirichlet noise, samples the move
from the visit counts at the schedule's temperature (``temp_init`` before
move ``temp_threshold``, ``temp_final`` after) and records the visit
distribution (tau = 1) as the policy target. ``algorithm="gumbel"`` plays
the sequential-halving winner and records the improved policy.

Value targets are the final outcome from the perspective of the player to
move at each position; games still live at ``max_moves`` are scored by piece
count. With ``tree_reuse="root"`` the played child's root-edge statistics
seed the next move's search (zeros at move 0), shrunk by
``tree_reuse_discount``.

After self-play, ``relabel_exact_values_with_stats`` replaces the value
targets of late positions with the native solver's exact outcome: only the
packed stones (``pack_stone_boards``, 16 bytes a position), ``to_move``,
``valid`` and ``value`` leave the card, and the new values go back to it.
``save_trajectory`` writes a batch in the JAX package's ``.npz`` layout.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import hostfetch
from .config import MCTSConfig, SelfPlayConfig
from .env import bitboard as env
from .env import endgame as endgame_lib
from .mcts import gumbel as gumbel_lib
from .mcts import search as search_lib
from .mcts import tree as tree_lib
from .mcts.search import resolve_device
from .ops import random as rand_ops


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
               log_gamma: Optional[torch.Tensor] = None,
               sample_noise: Optional[torch.Tensor] = None,
               first_game: int = 0, global_games: Optional[int] = None,
               device=None) -> Trajectory:
    """Play ``num_games`` games in lockstep on ``device`` (default CUDA;
    the net must already be there).

    The arguments mirror the JAX ``play_games`` (``search_kwargs`` builds
    them from configs). Every draw comes from ``generator`` on the device
    unless injected, per move slot: ``gumbel_noise`` ``[max_moves, B, A]``
    (the Gumbel search's root draw), ``log_gamma`` ``[max_moves, B, A]``
    (PUCT's raw log-gamma draw behind the root Dirichlet noise) and
    ``sample_noise`` ``[max_moves, B, A]`` (the Gumbel draw that samples
    PUCT's move, as ``search.sample_actions`` takes it).

    With ``global_games`` these games are rows ``[first_game, first_game +
    B)`` of a batch of ``global_games``: each draw is made at the whole
    batch's shape, in the same order, and these rows are kept. So the ranks
    of a data-parallel run, each playing its block from the same seed,
    play the games one process would (``parallel.dp.sharded_play_games``).
    The loop still ends its searches when this block's games are all over.
    """
    if algorithm not in ("puct", "gumbel"):
        raise ValueError(f"unknown search algorithm {algorithm!r}")
    if tree_reuse not in ("off", "root"):
        raise ValueError(f"unknown tree_reuse mode {tree_reuse!r}")
    dev = resolve_device(device)
    if any(p.device != dev for p in net.parameters()):
        raise ValueError(f"the net's parameters must be on {dev}")
    states = init_states if init_states is not None \
        else env.initial_state((num_games,), device=dev)
    b = states.done.shape[0]
    rows = slice(first_game, first_game + b)
    if global_games is not None and not 0 <= first_game <= \
            global_games - b:
        raise ValueError(f"games [{first_game}, {first_game + b}) are not "
                         f"rows of a batch of {global_games}")

    def own_rows(draw, injected):
        """Slot t's injected draw, else this block's rows of a draw at the
        whole batch's shape (None: the search draws it itself)."""
        if injected is not None:
            return injected[t]
        return None if global_games is None else draw()[rows]
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
        if algorithm == "gumbel":
            res = gumbel_lib.run_gumbel_search(
                net, states, num_simulations=num_simulations,
                max_considered_actions=max_considered_actions,
                c_visit=c_visit, c_scale=c_scale, gumbel_scale=1.0,
                max_depth=max_depth, compat=compat, num_stages=num_stages,
                leaf_batch=leaf_batch, warm_root=warm,
                warm_discount=tree_reuse_discount,
                gumbel=own_rows(lambda: gumbel_lib.draw_gumbel(
                    global_games, generator, dev), gumbel_noise),
                generator=generator, device=dev)
            actions = res.chosen_action
        else:
            res = search_lib.run_search(
                net, states, num_simulations=num_simulations,
                c_puct=c_puct, dirichlet_alpha=dirichlet_alpha,
                dirichlet_epsilon=dirichlet_epsilon, max_depth=max_depth,
                compat=compat, add_noise=True, num_stages=num_stages,
                leaf_batch=leaf_batch, warm_root=warm,
                warm_discount=tree_reuse_discount,
                log_gamma=own_rows(lambda: rand_ops.sample_log_gamma(
                    dirichlet_alpha, (global_games, env.NUM_ACTIONS),
                    generator, device=dev), log_gamma),
                generator=generator, device=dev)
            temp = temp_init if t < temp_threshold else temp_final
            actions = search_lib.sample_actions(
                search_lib.probs_with_temperature(res.visit_counts, temp),
                generator=generator,
                noise=own_rows(lambda: search_lib.draw_sample_noise(
                    (global_games, env.NUM_ACTIONS), generator, dev),
                    sample_noise))
        records.append((env.canonical_planes(states, compat=compat),
                        res.action_probs, states.to_move, live,
                        torch.where(live, actions, -1)))
        new_states, _ = env.step(states, actions, compat=compat)
        if warm is not None:
            wv, ws = tree_lib.root_child_warm_stats(res.tree, actions)
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


def save_trajectory(traj: Trajectory, directory: str, tag: str) -> str:
    """Persist a self-play batch as one compressed ``.npz``
    (``selfplay_<tag>.npz``), in the JAX package's layout: planes uint8,
    policy and value float32, to_move and actions int8, valid bool. A file
    written by either package loads in the other."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"selfplay_{tag}.npz")
    host = lambda x: x.detach().cpu().numpy()
    np.savez_compressed(
        path,
        planes=host(traj.planes).astype(np.uint8),
        policy=host(traj.policy).astype(np.float32),
        value=host(traj.value).astype(np.float32),
        to_move=host(traj.to_move).astype(np.int8),
        valid=host(traj.valid),
        actions=host(traj.actions).astype(np.int8),
    )
    return path


def load_trajectory_arrays(path: str) -> Dict[str, np.ndarray]:
    """Load a saved self-play batch back as float/bool numpy arrays."""
    with np.load(path) as data:
        return {
            "planes": data["planes"].astype(np.float32),
            "policy": data["policy"],
            "value": data["value"],
            "to_move": data["to_move"].astype(np.int32),
            "valid": data["valid"],
            "actions": data["actions"].astype(np.int32),
        }


def pack_stone_boards(planes: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack the mover/opponent stone planes of ``[..., 8, 8, C]`` canonical
    input into two int64 bitboards ``(mine, theirs)`` of the leading shape,
    on the planes' device: bit ``r*8+c`` = square (r, c), the env's order.
    A packed position is 16 bytes against 768 of float32 planes, so the
    relabel fetches ~48x less from the card."""
    weights = torch.ones(64, dtype=torch.int64, device=planes.device) \
        << torch.arange(64, device=planes.device)
    stones = (planes[..., :2] > 0.5).flatten(-3, -2).to(torch.int64)
    # distinct powers of two: the sum is the OR (bit 63 is the sign bit)
    packed = (stones * weights[:, None]).sum(-2)
    return packed[..., 0], packed[..., 1]


def _popcount64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit popcount (numpy<2 has no ``bitwise_count``)."""
    x = x.astype(np.uint64, copy=True)
    m1 = np.uint64(0x5555555555555555)
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    h01 = np.uint64(0x0101010101010101)
    with np.errstate(over="ignore"):  # the multiply wraps mod 2^64 by design
        x = x - ((x >> np.uint64(1)) & m1)
        x = (x & m2) + ((x >> np.uint64(2)) & m2)
        x = (x + (x >> np.uint64(4))) & m4
        return ((x * h01) >> np.uint64(56)).astype(np.int64)


def relabel_exact_values_with_stats(
        traj: Trajectory, max_empties: int, compat: bool = False,
        budget_s: Optional[float] = None,
        fetch_timeout_s: Optional[float] = None,
) -> Tuple[Trajectory, Dict[str, float]]:
    """Replace the value targets of positions with at most ``max_empties``
    empty squares by the sign of the solver's optimal-play disc
    differential from the mover's perspective
    (``SelfPlayConfig.exact_value_empties``).

    A recorded value is the realised outcome of the game; when the tail of
    a game is misplayed, every position along it gets a label it does not
    deserve. The solver's win/draw/loss probe is ground truth.

    The stones are packed on the trajectory's device and fetched with
    ``to_move``, ``valid`` and ``value`` (under the ``hostfetch`` watchdog
    when ``fetch_timeout_s`` > 0); the solve runs on the host
    (``relabel_packed_np``) and the new values go back to the device.
    Candidates are solved empties-ascending until ``budget_s`` wall-clock
    seconds are spent (``None``: no limit). Stats: ``candidates``,
    ``solved`` (positions relabelled), ``unique_solves`` (solver probes
    after dedup), ``skipped`` (cut by the budget), ``seconds``,
    ``max_empties_solved``, ``changed`` (labels that differ from the
    realised outcome).
    """
    mine, theirs = pack_stone_boards(traj.planes)
    mine, theirs, to_move, valid, old = (x.numpy() for x in
                                         hostfetch.device_get(
        (mine, theirs, traj.to_move, traj.valid, traj.value),
        fetch_timeout_s, what="relabel fetch"))
    value, stats = relabel_packed_np(
        mine.view(np.uint64), theirs.view(np.uint64), to_move, valid, old,
        max_empties=max_empties, compat=compat, budget_s=budget_s)
    if stats["solved"] == 0:
        return traj, stats
    return traj._replace(value=torch.from_numpy(value).to(
        traj.value.device)), stats


def relabel_np(planes: np.ndarray, to_move: np.ndarray, valid: np.ndarray,
               value: np.ndarray, *, max_empties: int, compat: bool = False,
               budget_s: Optional[float] = None
               ) -> Tuple[np.ndarray, Dict[str, float]]:
    """Planes-input wrapper of :func:`relabel_packed_np` for callers that
    start from host plane arrays (a loaded ``.npz``): packs the stone
    planes into uint64 bitboards with numpy and delegates."""
    def pack_all(boards: np.ndarray) -> np.ndarray:
        # [..., 8, 8] -> uint64 [...]; bit r*8+c = square (r, c)
        flat = (boards > 0.5).reshape(*boards.shape[:-2], 64)
        bytes8 = np.packbits(flat, axis=-1, bitorder="little")
        return np.ascontiguousarray(bytes8).view(np.uint64)[..., 0]

    return relabel_packed_np(
        pack_all(planes[..., 0]), pack_all(planes[..., 1]),
        to_move, valid, value,
        max_empties=max_empties, compat=compat, budget_s=budget_s)


def relabel_packed_np(mine64: np.ndarray, theirs64: np.ndarray,
                      to_move: np.ndarray, valid: np.ndarray,
                      value: np.ndarray, *, max_empties: int,
                      compat: bool = False,
                      budget_s: Optional[float] = None,
                      num_threads: Optional[int] = None
                      ) -> Tuple[np.ndarray, Dict[str, float]]:
    """Host core of ``relabel_exact_values_with_stats`` over packed
    bitboards (``mine64``/``theirs64``: uint64 ``[T, B]``, bit ``r*8+c``
    per square).

    Candidates are deduplicated (transpositions across games solve once)
    and the unique positions go to the native parallel batch solver
    (``EndgameSolver.solve_wdl_batch``) in empties-ascending order, so the
    ``budget_s`` bound spends cheapest-first. ``num_threads`` None = all
    host cores.
    """
    stats = {"candidates": 0, "solved": 0, "unique_solves": 0,
             "skipped": 0, "seconds": 0.0, "max_empties_solved": 0,
             "changed": 0}
    if max_empties <= 0:
        return value, stats

    empties = 64 - _popcount64_np(mine64 | theirs64)
    candidates = valid & (empties <= max_empties)
    stats["candidates"] = int(candidates.sum())
    if not candidates.any():
        return value, stats

    value = value.copy()
    solver = endgame_lib.EndgameSolver(compat=compat)
    if num_threads is None:
        num_threads = os.cpu_count() or 1

    ts, bs = np.nonzero(candidates)
    order = np.argsort(empties[ts, bs], kind="stable")
    ts, bs = ts[order], bs[order]
    t0 = time.perf_counter()

    # positions always have the mover to act (the env auto-passes); map to
    # absolute colours for the solver
    mine = mine64[ts, bs]
    theirs = theirs64[ts, bs]
    mover = to_move[ts, bs].astype(np.int32)
    is_black = mover == env.BLACK
    black = np.where(is_black, mine, theirs)
    white = np.where(is_black, theirs, mine)

    # first-occurrence dedup that PRESERVES the empties-ascending order
    # (np.unique would sort by key and break the cheapest-first budget)
    cache: Dict[Tuple[int, int, int], int] = {}
    uniq_of = np.empty(len(ts), np.int64)
    first_idx = []
    for i, key in enumerate(zip(black.tolist(), white.tolist(),
                                mover.tolist())):
        j = cache.get(key)
        if j is None:
            j = cache[key] = len(cache)
            first_idx.append(i)
        uniq_of[i] = j
    first = np.asarray(first_idx, np.int64)

    wdl, solved_u, _nodes = solver.solve_wdl_batch(
        black[first], white[first], mover[first],
        budget_s=budget_s, num_threads=num_threads)
    exact_u = np.sign(wdl).astype(np.float32)

    solved_c = solved_u[uniq_of]  # per candidate: was its unique solved?
    exact_c = exact_u[uniq_of]
    stats["unique_solves"] = int(solved_u.sum())
    stats["solved"] = int(solved_c.sum())
    stats["skipped"] = int((~solved_c).sum())
    if solved_c.any():
        emp_c = empties[ts, bs]
        stats["max_empties_solved"] = int(emp_c[solved_c].max())
        old = value[ts[solved_c], bs[solved_c]]
        stats["changed"] = int((exact_c[solved_c] != old).sum())
        value[ts[solved_c], bs[solved_c]] = exact_c[solved_c]
    stats["seconds"] = time.perf_counter() - t0
    return value, stats


def relabel_exact_values(traj: Trajectory, max_empties: int,
                         compat: bool = False,
                         budget_s: Optional[float] = None) -> Trajectory:
    """Stats-free wrapper of ``relabel_exact_values_with_stats``."""
    traj, _ = relabel_exact_values_with_stats(traj, max_empties,
                                              compat=compat,
                                              budget_s=budget_s)
    return traj
