"""Batched PUCT search, the machinery it shares with the Gumbel driver, and
the host play surface.

Port of ``alphazero_reversi_tpu/mcts/search.py``: leaf evaluation, the
staged-unroll bounds, the lockstep descent below the root picks, the
selection-agnostic round tail (evaluate, expand, back up), the PUCT driver
``run_search`` with root Dirichlet noise and 1-level tree reuse, the
temperature transform, the action sampler, and the object-style ``MCTS``
(exact endgames, transposition table) that ``cli analyze``/``play`` use.

The batch axis is games: every simulation round selects ``leaf_batch``
leaves in each of B games, evaluates them in one NN forward, expands them
into contiguous slots and backs them up with one launch of the backup
kernel (``tree.round_backup``). The tree is allocated at its final capacity
up front (the JAX package grows it between stages; the final tree is the
same), and each stage only sets how many select levels a round unrolls,
``max(1, min(levels_cap, end))``, so shapes stay static for a later CUDA
graph capture. ``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does.

Value convention: every evaluated value is from the perspective of the
player to move at the evaluated state; the backup flips its sign per path
level only where that level's player differs (the env auto-passes, so not
every ply).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MCTSConfig
from ..env import bitboard as env
from ..models import resnet
from ..ops import random as rand_ops
from . import tree as tree_lib

A = env.NUM_ACTIONS


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA (the current card). Raises if CUDA is asked for
    and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU by "
                               "default; pass device='cpu' to run on the CPU")
        if dev.index is None:  # compare equal to tensors' "cuda:N"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_on_device(root_states: env.EnvState, dev: torch.device) -> None:
    if root_states.black.device != dev:
        raise ValueError(f"root_states are on {root_states.black.device}, "
                         f"expected {dev}")


class SearchResult(NamedTuple):
    """Outcome of one batched PUCT search."""

    visit_counts: torch.Tensor  # [B, A] i32 fresh root child visit counts
    action_probs: torch.Tensor  # [B, A] normalised visit counts (tau = 1)
    root_value: torch.Tensor  # [B] mean root value (root player POV)
    tree: Optional[tree_lib.Tree]  # None for a transposition-table hit


class ExactResult(NamedTuple):
    """Outcome of an exact endgame solve on the host play path: the fields
    a search result's consumers read, plus the solver's own outputs."""

    visit_counts: torch.Tensor  # [1, A] one-hot at the optimal move
    action_probs: torch.Tensor  # [1, A] one-hot at the optimal move
    root_value: torch.Tensor  # [1] sign of the disc differential
    chosen_action: torch.Tensor  # [1] i32 the optimal move
    disc_diff: int  # exact final disc differential (mover - opponent)
    nodes: int  # solver nodes visited


def _evaluate(net, states: env.EnvState, compat: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch NN eval -> (prior [B,A], value [B], legal [B,A]). Terminal
    states take their exact outcome (player-to-move POV) as value."""
    planes = env.canonical_planes(states, compat=compat)
    logits, value = resnet.apply_eval(net, planes)
    legal = env.legal_action_mask(states, compat=compat)
    prior = resnet.masked_policy(logits, legal)
    term_val = env.terminal_value(states, states.to_move)
    return prior, torch.where(states.done, term_val, value), legal


def _stage_bounds(num_simulations: int, num_stages: int) -> Tuple[int, ...]:
    """Round-count boundaries of the depth stages: a stage ending at round
    ``end`` unrolls ``min(levels_cap, end)`` select levels, since a descent
    in round r can be at most r + 1 levels deep."""
    if num_stages <= 1 or num_simulations < 2 * num_stages:
        return (num_simulations,)
    bounds = []
    for s in range(1, num_stages + 1):
        b = (num_simulations * s) // num_stages
        if not bounds or b > bounds[-1]:
            bounds.append(b)
    return tuple(bounds)


def stage_levels(num_rounds: int, num_stages: int, levels_cap: int):
    """``(start, end, levels)`` of each depth stage."""
    start = 0
    for end in _stage_bounds(num_rounds, num_stages):
        yield start, end, max(1, min(levels_cap, end))
        start = end


def _pick(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return x.gather(-1, index.unsqueeze(-1)).squeeze(-1)


# select(row, prior, legal, visits, vsum) -> action, all [B, L, ...]
Select = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor], torch.Tensor]


def descend(trees: tree_lib.Tree, root_row: torch.Tensor,
            root_done: torch.Tensor, a0: torch.Tensor, child0: torch.Tensor,
            levels: int, select: Select):
    """The lockstep descent of all L lanes below their root picks ``a0``
    (``child0``: the picked edges' child slots), ``levels`` levels with one
    row gather each; ``select`` picks each live lane's action at its node.
    A lane ends at an unexpanded edge (its leaf), at a terminal node, or
    at the depth bound (evaluated where it stands, nothing expanded).

    Returns ``(pn, pa, pt, leaf, leaf_action, eval_row)``: the
    ``[B, L * levels]`` lane-major path arrays, the ``[B, L]`` leaf edges
    (``leaf_action < 0``: no expansion) and the ``[B, L, K]`` rows each
    lane evaluates from."""
    batch, L = a0.shape
    can0 = (~root_done)[:, None].expand(batch, L)
    found = can0 & (child0 == 0)
    finishing = found | ~can0
    path_nodes = [torch.where(can0, 0, -1)]
    path_actions = [torch.where(can0, a0, 0)]
    path_tomove = [root_row[:, tree_lib.S_TO_MOVE][:, None].expand(batch, L)]
    leaf = torch.zeros_like(a0)
    leaf_action = torch.where(found, a0, -1)
    eval_row = root_row[:, None, :].expand(batch, L, tree_lib.K)
    alive = ~finishing
    node = torch.where(alive, child0, 0)

    for _ in range(1, levels):
        row, srow = tree_lib.gather_node(trees, node)  # [B, L, K/S]
        p, lg = tree_lib.decode_prior_legal(row)
        done_n = row[..., tree_lib.S_DONE] > 0.5
        visits, child = tree_lib.unpack_visits_child(
            srow[..., tree_lib.VISITS_OFF:tree_lib.VISITS_OFF + A])
        vsum = srow[..., tree_lib.VSUM_OFF:tree_lib.VSUM_OFF + A]
        a = select(row, p, lg, visits, vsum)
        child_idx = _pick(child, a).long()

        can_step = alive & ~done_n
        found = can_step & (child_idx == 0)
        path_nodes.append(torch.where(can_step, node, -1))
        path_actions.append(torch.where(can_step, a, 0))
        path_tomove.append(row[..., tree_lib.S_TO_MOVE])

        finishing = found | (alive & done_n)
        eval_row = torch.where(finishing[..., None], row, eval_row)
        leaf = torch.where(found, node, leaf)
        leaf_action = torch.where(found, a, leaf_action)
        alive = alive & ~finishing
        node = torch.where(alive, child_idx, node)

    # depth-truncated lanes evaluate the node they reached
    trow, _ = tree_lib.gather_node(trees, node)
    eval_row = torch.where(alive[..., None], trow, eval_row)

    pn = torch.stack(path_nodes, -1).reshape(batch, L * levels)
    pa = torch.stack(path_actions, -1).reshape(batch, L * levels)
    pt = torch.stack(path_tomove, -1).reshape(batch, L * levels)
    return pn, pa, pt, leaf, leaf_action, eval_row


def expand_and_backup(net, trees: tree_lib.Tree, pn: torch.Tensor,
                      pa: torch.Tensor, pt: torch.Tensor,
                      leaves: torch.Tensor, leaf_acts: torch.Tensor,
                      eval_rows: torch.Tensor, slot0: int,
                      root_to_move: torch.Tensor, compat: bool
                      ) -> tree_lib.Tree:
    """Tail of a simulation round: evaluate the selected leaves, expand them
    into the contiguous slots ``slot0 ..``, and back the values up.

    ``pn``/``pa``/``pt`` are ``[B, L*levels]`` lane-major path arrays (node /
    action / to-move per level, ``node < 0`` on padding); ``leaves`` and
    ``leaf_acts`` are ``[B, L]`` (``leaf_acts < 0``: the lane ends without
    expansion); ``eval_rows`` ``[B, L, K]`` holds each lane's evaluation
    target row (the leaf's parent; the leaf state is made here by stepping).
    The backup, links and root totals are one ``tree_lib.round_backup``:
    one kernel launch on the card.
    """
    batch, L = leaves.shape

    base_state = tree_lib.unpack_state(
        eval_rows.reshape(batch * L, -1)[:, A:])
    do_expand = (leaf_acts >= 0).reshape(batch * L)
    stepped, _ = env.step(base_state, leaf_acts.reshape(batch * L)
                          .clamp_min(0), compat=compat)
    eval_state = env.where_state(do_expand, stepped, base_state)
    prior_c, value_c, legal_c = _evaluate(net, eval_state, compat)

    trees = tree_lib.write_children_rows(
        trees, slot0,
        tree_lib.make_row(eval_state, prior_c, legal_c, value_c)
        .reshape(batch, L, -1))

    return tree_lib.round_backup(
        trees, pn, pa, pt, eval_state.to_move.reshape(batch, L),
        value_c.reshape(batch, L), leaves, leaf_acts, slot0, root_to_move)


# ----------------------------------------------------------------- PUCT
def add_dirichlet_noise(prior: torch.Tensor, legal: torch.Tensor,
                        alpha: float, epsilon: float,
                        generator: Optional[torch.Generator] = None,
                        log_gamma: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Mix the root prior with Dirichlet(alpha) noise over the legal
    actions, ``(1 - epsilon) * prior + epsilon * noise``, renormalised.
    ``log_gamma`` ``[B, A]`` (raw log-gamma draws) replaces the draw from
    ``generator``."""
    noise = rand_ops.dirichlet_noise(alpha, legal, generator=generator,
                                     log_gamma=log_gamma)
    mixed = (1.0 - epsilon) * prior + epsilon * noise
    mixed = torch.where(legal, mixed, 0.0)
    return mixed / mixed.sum(-1, keepdim=True).clamp_min(1e-12)


def _puct_action(visits: torch.Tensor, vsum: torch.Tensor,
                 prior: torch.Tensor, legal: torch.Tensor, c: float
                 ) -> torch.Tensor:
    """``argmax Q + c P sqrt(sum N + 1) / (1 + N)`` over legal actions
    (unvisited edges: Q = 0)."""
    q = torch.where(visits > 0, vsum / visits.clamp_min(1.0), 0.0)
    parent_visit = visits.sum(-1, keepdim=True) + 1.0
    score = q + c * prior * parent_visit.sqrt() / (1.0 + visits)
    return torch.where(legal, score, -math.inf).argmax(-1)


class _PuctRoot(NamedTuple):
    row: torch.Tensor  # [B, K]
    prior: torch.Tensor  # [B, A] (noised when the search adds noise)
    legal: torch.Tensor  # [B, A]
    done: torch.Tensor  # [B]
    to_move: torch.Tensor  # [B]


def _puct_round(net, trees: tree_lib.Tree, r: int, levels: int, L: int,
                root: _PuctRoot, c: float, compat: bool) -> tree_lib.Tree:
    """One simulation round: L sequential root picks with root virtual loss,
    the lockstep descent, then evaluate/expand/back up."""
    root_srow = trees.stats[:, :tree_lib.STRIDE]
    root_visits, root_child = tree_lib.unpack_visits_child(
        root_srow[:, tree_lib.VISITS_OFF:tree_lib.VISITS_OFF + A])
    root_vsum = root_srow[:, tree_lib.VSUM_OFF:tree_lib.VSUM_OFF + A]
    # virtual loss: a pending in-round root visit counts as a visit that
    # returned a loss
    root_extra = torch.zeros_like(root_visits)
    a0s, child0s = [], []
    for _ in range(L):
        a = _puct_action(root_visits + root_extra, root_vsum - root_extra,
                         root.prior, root.legal, c)
        root_extra = root_extra + torch.where(
            ~root.done[:, None], F.one_hot(a, A).float(), 0.0)
        a0s.append(a)
        child0s.append(_pick(root_child, a).long())

    def select(row, p, lg, visits, vsum):
        return _puct_action(visits, vsum, p, lg, c)

    pn, pa, pt, leaf, leaf_action, eval_row = descend(
        trees, root.row, root.done, torch.stack(a0s, -1),
        torch.stack(child0s, -1), levels, select)
    return expand_and_backup(net, trees, pn, pa, pt, leaf, leaf_action,
                             eval_row, r * L + 1, root.to_move, compat)


@torch.no_grad()
def run_search(net, root_states: env.EnvState, *, num_simulations: int,
               c_puct: float, dirichlet_alpha: float,
               dirichlet_epsilon: float, max_depth: int = 24,
               compat: bool = False, add_noise: bool = True,
               num_stages: int = 6, leaf_batch: int = 1,
               warm_root: Optional[Tuple[torch.Tensor,
                                         torch.Tensor]] = None,
               warm_discount: float = 1.0,
               log_gamma: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               device=None) -> SearchResult:
    """Batched PUCT search from ``root_states`` (leading batch axis B) on
    ``device`` (default CUDA), which must hold the states and the net.

    With ``add_noise`` the root prior is mixed with Dirichlet noise
    (``add_dirichlet_noise``) drawn from ``generator``, or built from the
    injected ``log_gamma`` ``[B, A]``. ``leaf_batch`` (L) descents per game
    and round diversify by root virtual loss; descents that still land on
    the same (leaf, action) evaluate and back it up again but link it once.
    ``num_simulations`` must be a multiple of L.

    ``warm_root`` ``(visits [B, A], vsum [B, A])`` seeds the root's edge
    statistics from the previous move's search (1-level tree reuse),
    shrunk by ``warm_discount`` (``tree.discount_warm``); the reported
    ``visit_counts`` and ``action_probs`` count only this search's fresh
    visits, ``root_value`` blends both.
    """
    dev = resolve_device(device)
    check_on_device(root_states, dev)
    batch = root_states.to_move.shape[0]
    L = leaf_batch
    if L < 1 or num_simulations % L != 0:
        raise ValueError(
            f"num_simulations={num_simulations} must be a positive multiple "
            f"of leaf_batch={L}")
    num_rounds = num_simulations // L
    # a path cannot be longer than the expansions that built it, nor than
    # the number of stones the board can still take
    levels_cap = max(1, min(max_depth, num_simulations, 60))

    prior, root_raw, legal = _evaluate(net, root_states, compat)
    if add_noise:
        prior = add_dirichlet_noise(prior, legal, dirichlet_alpha,
                                    dirichlet_epsilon, generator=generator,
                                    log_gamma=log_gamma)
    trees = tree_lib.init_root(
        tree_lib.make_tree(batch, num_rounds * L + 1, device=dev),
        root_states, prior, legal, root_raw)
    warm_v = None
    if warm_root is not None:
        warm_v = torch.where(legal, warm_root[0].float().clamp_min(0.0), 0.0)
        warm_s = warm_root[1].float()
        if warm_discount != 1.0:
            warm_v, warm_s = tree_lib.discount_warm(warm_v, warm_s,
                                                    warm_discount)
        trees = tree_lib.seed_root_stats(trees, warm_v, warm_s, legal)
    root_row = trees.rows[:, 0, :]
    root_p, root_lg = tree_lib.decode_prior_legal(root_row)
    root = _PuctRoot(row=root_row, prior=root_p, legal=root_lg,
                     done=root_row[:, tree_lib.S_DONE] > 0.5,
                     to_move=root_states.to_move)

    c = float(c_puct)
    for start, end, levels in stage_levels(num_rounds, num_stages,
                                           levels_cap):
        for r in range(start, end):
            trees = _puct_round(net, trees, r, levels, L, root, c, compat)

    visit_counts = tree_lib.root_visit_counts(trees)
    if warm_v is not None:
        visit_counts = visit_counts - warm_v.to(torch.int32)  # fresh only
    total = visit_counts.sum(-1, keepdim=True).clamp_min(1)
    return SearchResult(visit_counts=visit_counts,
                        action_probs=visit_counts.float() / total,
                        root_value=tree_lib.root_value(trees), tree=trees)


def probs_with_temperature(visit_counts: torch.Tensor, temperature
                           ) -> torch.Tensor:
    """Visit counts -> action distribution at ``temperature``: ``tau`` below
    1e-3 plays the argmax, otherwise ``p(a) ∝ N(a)^(1/tau)``."""
    counts = visit_counts.float()
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=counts.device)
    greedy = F.one_hot(counts.argmax(-1), counts.shape[-1]).float()
    logits = torch.where(counts > 0, counts.clamp_min(1e-12).log(),
                         -torch.inf)
    scaled = logits / temperature.clamp_min(1e-3)
    scaled = scaled - scaled.max(-1, keepdim=True).values
    powed = torch.where(counts > 0, scaled.exp(), 0.0)
    soft = powed / powed.sum(-1, keepdim=True).clamp_min(1e-12)
    soft = torch.where(counts.sum(-1, keepdim=True) == 0, greedy, soft)
    return torch.where(temperature < 1e-3, greedy, soft)


def sample_actions(probs: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One action per row of ``probs`` [..., A], drawn from it: the argmax
    of ``log p + g`` over actions with ``p > 0``, ``g`` standard Gumbel
    (JAX's ``jax.random.categorical``). ``g`` is drawn on the device from
    ``generator`` as ``-log(-log(u))``, ``u`` uniform in [tiny, 1), or
    taken from ``noise`` (same shape as ``probs``). Returns int32."""
    logits = torch.where(probs > 0, probs.clamp_min(1e-12).log(),
                         -torch.inf)
    if noise is None:
        u = torch.rand(probs.shape, generator=generator,
                       device=probs.device)
        noise = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
    return (logits + noise).argmax(-1).to(torch.int32)


# ------------------------------------------------------ host play surface
class MCTS:
    """Object-style search for the host play path (``cli analyze`` and
    ``play``): one position at a time, a fresh tree per call.

    ``get_action_probs`` takes an ``EnvState`` of batch 1 on any device
    (``env.game.Board`` keeps its state on the CPU), copies it to the
    search's ``device`` (default CUDA) and runs the configured algorithm.
    Two host shortcuts apply to batch-1 queries: an exact endgame solve
    (``config.exact_endgame_empties`` > 0; the native solver,
    ``env/endgame.py``) and, for noise-free searches, a
    ``transposition.TranspositionTable`` keyed by the symmetry-canonical
    position. Both read the position from ONE device-to-host copy.
    """

    def __init__(self, net, config: MCTSConfig, compat: bool = False,
                 transposition_table=None, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.compat = compat
        if (transposition_table is not None and compat
                and transposition_table.use_symmetry):
            # compat rules are not dihedral-equivariant (their edge-wrap
            # and west-mask quirks single out east and west), so a hit
            # through a symmetry could put visits on moves illegal in the
            # query's orientation: a fresh table drops to exact-position
            # keys, a table that already holds symmetry keys is refused
            if len(transposition_table):
                raise ValueError(
                    "compat-mode MCTS cannot reuse a symmetry-keyed "
                    "transposition table with existing entries")
            transposition_table.use_symmetry = False
        self.transposition_table = transposition_table
        self.endgame_solver = None
        if config.exact_endgame_empties > 0:
            from ..env import endgame as endgame_lib
            self.endgame_solver = endgame_lib.EndgameSolver(compat=compat)
        self._net = net.to(self.device).eval()

    @property
    def net(self):
        return self._net

    @net.setter
    def net(self, new_net) -> None:
        # cached searches are a function of the weights: a new net (the
        # pipeline's promotion pattern) invalidates the table
        if self.transposition_table is not None and new_net is not self._net:
            self.transposition_table.clear()
        self._net = new_net.to(self.device).eval()

    def _on_device(self, states: env.EnvState) -> env.EnvState:
        return env.EnvState(*(t.to(self.device) for t in states))

    def search_batch(self, root_states: env.EnvState,
                     generator: Optional[torch.Generator] = None,
                     add_noise: bool = True):
        """Run the configured algorithm: a ``SearchResult`` (``"puct"``) or
        a ``gumbel.GumbelResult`` (``"gumbel"``; ``add_noise=False`` is the
        deterministic ``gumbel_scale=0`` search)."""
        cfg = self.config
        states = self._on_device(root_states)
        if cfg.algorithm == "gumbel":
            from . import gumbel as gumbel_lib
            n = states.to_move.shape[0]
            return gumbel_lib.run_gumbel_search(
                self.net, states, num_simulations=cfg.num_simulations,
                max_considered_actions=cfg.max_considered_actions,
                c_visit=cfg.c_visit, c_scale=cfg.c_scale,
                gumbel_scale=1.0 if add_noise else 0.0,
                max_depth=cfg.max_depth, compat=self.compat,
                num_stages=cfg.num_stages, leaf_batch=cfg.batch_size,
                gumbel=None if add_noise else torch.zeros(
                    n, A, device=self.device),
                generator=generator, device=self.device)
        return run_search(
            self.net, states, num_simulations=cfg.num_simulations,
            c_puct=cfg.c_puct, dirichlet_alpha=cfg.dirichlet_alpha,
            dirichlet_epsilon=cfg.dirichlet_epsilon,
            max_depth=cfg.max_depth, compat=self.compat,
            add_noise=add_noise, num_stages=cfg.num_stages,
            leaf_batch=cfg.batch_size, generator=generator,
            device=self.device)

    def get_action_probs(self, root_states: env.EnvState,
                         generator: Optional[torch.Generator] = None,
                         temperature: float = 1.0, add_noise: bool = True):
        """``(probs [B, A], result)``: the move distribution at
        ``temperature`` and the search (or exact) result behind it."""
        host = self._host_position(root_states, add_noise)
        exact = self._exact_endgame(host)
        if exact is not None:
            # a proven-optimal move needs no temperature or noise
            return exact.action_probs, exact
        result = self._search_with_tt(root_states, generator, add_noise,
                                      host)
        if self.config.algorithm == "gumbel":
            from . import gumbel as gumbel_lib
            return gumbel_lib.play_probs(result, temperature), result
        return probs_with_temperature(result.visit_counts,
                                      temperature), result

    def _host_position(self, root_states: env.EnvState, add_noise: bool):
        """One device-to-host copy of a batch-1 position for the solver and
        the table: ``(black, white, to_move, passed, done)`` host ints
        (bitboards unsigned), or None when the batch is not 1 or neither
        wants it."""
        want_solver = self.endgame_solver is not None
        want_tt = self.transposition_table is not None and not add_noise
        if not (want_solver or want_tt) or root_states.to_move.shape != (1,):
            return None
        words = torch.stack([t.reshape(()).to(torch.int64)
                             for t in root_states]).cpu().tolist()
        mask = (1 << 64) - 1
        black, white, to_move, passed, done, _ = words
        return black & mask, white & mask, to_move, passed, bool(done)

    def _exact_endgame(self, host) -> Optional[ExactResult]:
        """The exact solve of a batch-1, unfinished position with at most
        ``exact_endgame_empties`` empty squares, else None."""
        if self.endgame_solver is None or host is None:
            return None
        from ..env import endgame as endgame_lib

        black, white, to_move, passed, done = host
        if done or (endgame_lib.count_empties(black, white)
                    > self.config.exact_endgame_empties):
            return None
        res = self.endgame_solver.solve(black, white, to_move, passed=passed)
        action = res.best_move if res.best_move >= 0 else env.PASS_ACTION
        one_hot = torch.zeros(1, A, device=self.device)
        one_hot[0, action] = 1.0
        return ExactResult(
            visit_counts=one_hot, action_probs=one_hot.clone(),
            root_value=torch.tensor([float(np.sign(res.value))],
                                    device=self.device),
            chosen_action=torch.tensor([action], dtype=torch.int32,
                                       device=self.device),
            disc_diff=res.value, nodes=res.nodes)

    def _search_with_tt(self, root_states: env.EnvState,
                        generator: Optional[torch.Generator],
                        add_noise: bool, host=None):
        """Search, through the transposition table when the query is
        cacheable: batch 1 and noise-free (a noised search is not a
        function of the position)."""
        tt = self.transposition_table
        if host is None:
            host = self._host_position(root_states, add_noise)
        if tt is None or add_noise or host is None:
            return self.search_batch(root_states, generator, add_noise)

        dev = self.device
        as_row = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)[None]
        black, white, to_move, _, _ = host
        if self.config.algorithm == "gumbel":
            from . import gumbel as gumbel_lib
            hit = tt.lookup_gumbel(black, white, to_move)
            if hit is not None:
                counts, value, probs, chosen = hit
                return gumbel_lib.GumbelResult(
                    visit_counts=as_row(counts), action_probs=as_row(probs),
                    chosen_action=torch.tensor([chosen], dtype=torch.int32,
                                               device=dev),
                    root_value=torch.tensor([value], device=dev), tree=None)
            result = self.search_batch(root_states, generator, False)
            tt.store(black, white, to_move,
                     result.visit_counts[0].cpu().numpy(),
                     float(result.root_value[0]),
                     action_probs=result.action_probs[0].cpu().numpy(),
                     chosen_action=int(result.chosen_action[0]))
            return result
        hit = tt.lookup(black, white, to_move)
        if hit is not None:
            counts, value = hit
            vc = as_row(counts)
            return SearchResult(
                visit_counts=vc,
                action_probs=vc / vc.sum(-1, keepdim=True).clamp_min(1.0),
                root_value=torch.tensor([value], device=dev), tree=None)
        result = self.search_batch(root_states, generator, False)
        tt.store(black, white, to_move,
                 result.visit_counts[0].cpu().numpy(),
                 float(result.root_value[0]))
        return result
