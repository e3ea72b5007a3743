"""Gumbel AlphaZero search: sequential halving with Gumbel at the root.

Port of ``alphazero_reversi_tpu/mcts/gumbel.py`` (Danihelka et al., ICLR
2022, over the packed array tree). The rules are the JAX package's:

* root: simulation ``i`` visits an action whose fresh root visit count
  equals the prescribed count ``seq[i]`` of the halving schedule, picking
  ``argmax g + logits + sigma(q)`` among them;
* interior nodes: ``argmax softmax(logits + sigma) - N / (1 + sum N)``;
* unvisited actions take the mixed-value estimate; completed Q is min-max
  rescaled over legal actions and scaled by ``(c_visit + max N) * c_scale``;
* the move is the halving winner; the policy target is the improved policy
  ``softmax(logits + sigma)``.

The tree is allocated at its final capacity up front (the JAX package grows
it by zero-padding between stages; the final tree is the same). Stages only
set how many select levels a round unrolls, ``max(1, min(levels_cap, end))``:
the unroll stays static so that a round can later be captured as a CUDA
graph. ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..env import bitboard as env
from . import tree as tree_lib
from .search import (_evaluate, _pick, check_on_device, descend,
                     expand_and_backup, probs_with_temperature,
                     resolve_device, stage_levels)

A = env.NUM_ACTIONS
_NEG = -1e30


@functools.lru_cache(maxsize=None)
def halving_schedule(num_considered: int, num_simulations: int
                     ) -> Tuple[int, ...]:
    """Prescribed root visit count before each simulation: sequential
    halving over ``num_considered`` candidates within ``num_simulations``."""
    if num_considered <= 1:
        return tuple(range(num_simulations))
    phases = max(1, math.ceil(math.log2(num_considered)))
    seq: list = []
    count = 0
    alive = num_considered
    while len(seq) < num_simulations:
        extra = max(1, num_simulations // (phases * alive))
        for _ in range(extra):
            seq.extend([count] * alive)
            count += 1
        alive = max(2, alive // 2)
    return tuple(seq[:num_simulations])


def schedule_table(max_considered: int, num_simulations: int) -> np.ndarray:
    """``[max_considered + 1, num_simulations]`` int32: row ``m`` is the
    schedule for ``m`` candidate actions."""
    rows = [halving_schedule(max(m, 1), num_simulations)
            for m in range(max_considered + 1)]
    return np.asarray(rows, np.int32)


def completed_q_sigma(visits: torch.Tensor, vsum: torch.Tensor,
                      prior: torch.Tensor, legal: torch.Tensor,
                      raw_value: torch.Tensor, c_visit: float,
                      c_scale: float) -> torch.Tensor:
    """``sigma(completed q-hat)`` ([..., A]) for selection and targets."""
    visited = visits > 0
    q = torch.where(visited, vsum / visits.clamp_min(1.0), 0.0)
    sum_n = visits.sum(-1, keepdim=True)
    prior_visited = torch.where(visited, prior, 0.0)
    psum = prior_visited.sum(-1, keepdim=True)
    weighted_q = (prior_visited * q).sum(-1, keepdim=True) \
        / psum.clamp_min(1e-12)
    v_mix = (raw_value.unsqueeze(-1) + sum_n * weighted_q) / (sum_n + 1.0)
    completed = torch.where(visited, q, v_mix)
    cmax = torch.where(legal, completed, _NEG).max(-1, keepdim=True).values
    cmin = torch.where(legal, completed, -_NEG).min(-1, keepdim=True).values
    rescaled = (completed - cmin) / (cmax - cmin).clamp_min(1e-8)
    max_n = visits.max(-1, keepdim=True).values
    return (c_visit + max_n) * c_scale * torch.where(legal, rescaled, 0.0)


def _logits(prior: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Action logits recovered from the stored masked-softmax prior (up to a
    per-game constant, to which every consumer is invariant)."""
    return torch.where(legal, prior.clamp_min(1e-12).log(), _NEG)


def _masked_argmax(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, score, _NEG).argmax(-1)


class GumbelResult(NamedTuple):
    visit_counts: torch.Tensor  # [B, A] i32 fresh root child visit counts
    action_probs: torch.Tensor  # [B, A] improved policy (training target)
    chosen_action: torch.Tensor  # [B] i32 sequential-halving winner
    root_value: torch.Tensor  # [B] mean root value (root player POV)
    tree: tree_lib.Tree


def play_probs(result: GumbelResult, temperature) -> torch.Tensor:
    """Action distribution for play: the halving winner below temperature
    1e-3, else the tempered improved policy."""
    greedy = F.one_hot(result.chosen_action.long(), A).float()
    tempered = probs_with_temperature(result.action_probs, temperature)
    return torch.where(torch.as_tensor(temperature) < 1e-3, greedy, tempered)


class _Root(NamedTuple):
    """Per-search root quantities, fixed for the whole search."""

    row: torch.Tensor  # [B, K]
    prior: torch.Tensor  # [B, A]
    legal: torch.Tensor  # [B, A]
    logits: torch.Tensor  # [B, A]
    fallback: torch.Tensor  # [B] argmax of logits over legal actions
    g: torch.Tensor  # [B, A] scaled, masked Gumbel draw
    done: torch.Tensor  # [B]
    value: torch.Tensor  # [B] raw NN value of the root
    to_move: torch.Tensor  # [B]
    schedule: torch.Tensor  # [B, num_simulations] prescribed counts
    warm_v: Optional[torch.Tensor]  # [B, A] warm visits, or None


def _sim_round(net, trees: tree_lib.Tree, r: int, levels: int, L: int,
               root: _Root, cv: float, cs: float, compat: bool
               ) -> tree_lib.Tree:
    """One simulation round: L schedule-masked root picks, a lockstep
    descent of ``levels`` levels, then evaluate/expand/back up."""
    root_lg, root_done, root_row = root.legal, root.done, root.row

    # root phase
    root_srow = trees.stats[:, :tree_lib.STRIDE]
    root_visits, root_child = tree_lib.unpack_visits_child(
        root_srow[:, tree_lib.VISITS_OFF:tree_lib.VISITS_OFF + A])
    root_vsum = root_srow[:, tree_lib.VSUM_OFF:tree_lib.VSUM_OFF + A]
    sigma = completed_q_sigma(root_visits, root_vsum, root.prior, root_lg,
                              root.value, cv, cs)
    score = root.g + root.logits + sigma
    seq_round = root.schedule[:, r * L:(r + 1) * L]  # [B, L]
    # the schedule prescribes FRESH counts: warm counts are subtracted
    fresh = root_visits if root.warm_v is None else root_visits - root.warm_v
    root_extra = torch.zeros_like(fresh)
    a0s, child0s = [], []
    for l in range(L):
        eligible = root_lg & ((fresh + root_extra) == seq_round[:, l:l + 1]) \
            & ~root_done[:, None]
        a = torch.where(eligible.any(-1), _masked_argmax(score, eligible),
                        root.fallback)
        root_extra = root_extra + torch.where(
            ~root_done[:, None], F.one_hot(a, A).float(), 0.0)
        a0s.append(a)
        child0s.append(_pick(root_child, a).long())

    def select(row, p, lg, visits, vsum):
        sig = completed_q_sigma(visits, vsum, p, lg,
                                row[..., tree_lib.S_VALUE], cv, cs)
        pi = torch.softmax(torch.where(lg, _logits(p, lg) + sig, _NEG), -1)
        return _masked_argmax(
            pi - visits / (1.0 + visits.sum(-1, keepdim=True)), lg)

    pn, pa, pt, leaf, leaf_action, eval_row = descend(
        trees, root_row, root_done, torch.stack(a0s, -1),
        torch.stack(child0s, -1), levels, select)
    return expand_and_backup(net, trees, pn, pa, pt, leaf, leaf_action,
                             eval_row, r * L + 1, root.to_move, compat)


@torch.no_grad()
def draw_gumbel(batch: int, generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """The search's root draw: standard Gumbel ``[batch, A]`` float32 from
    ``generator``."""
    return torch.empty(batch, A, device=device).exponential_(
        generator=generator).log_().neg_()


def run_gumbel_search(net, root_states: env.EnvState, *,
                      num_simulations: int, max_considered_actions: int = 16,
                      c_visit: float = 50.0, c_scale: float = 0.1,
                      gumbel_scale: float = 1.0, max_depth: int = 24,
                      compat: bool = False, num_stages: int = 6,
                      leaf_batch: int = 1,
                      warm_root: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                      warm_discount: float = 1.0,
                      gumbel: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> GumbelResult:
    """Batched Gumbel search from ``root_states`` (leading batch axis B).

    ``device`` (default CUDA) must hold ``root_states`` and the net.
    ``gumbel`` ([B, A]) replaces the internal Gumbel draw; it is scaled by
    ``gumbel_scale`` and masked to ``-1e30`` on illegal actions exactly as
    the drawn one. Otherwise the draw comes from ``generator`` (default: the
    device's default generator).

    ``warm_root`` seeds the root's edge stats from the previous move's search
    (1-level tree reuse). The halving schedule runs on FRESH counts (warm
    subtracted), sigma sees warm + fresh evidence, and the reported
    ``visit_counts`` are fresh only.
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
    levels_cap = max(1, min(max_depth, num_simulations, 60))
    cv, cs = float(c_visit), float(c_scale)

    prior, root_raw, legal = _evaluate(net, root_states, compat)
    if gumbel is None:
        gumbel = draw_gumbel(batch, generator, dev)
    g = torch.where(legal, gumbel_scale * gumbel.float(), _NEG)

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
    root_logits = _logits(root_p, root_lg)
    # games with m legal actions follow row min(m, max_considered) of the
    # schedule table
    table = torch.as_tensor(
        schedule_table(max_considered_actions, num_simulations), device=dev)
    m_eff = root_lg.sum(-1).clamp_max(max_considered_actions)
    root = _Root(
        row=root_row, prior=root_p, legal=root_lg, logits=root_logits,
        fallback=_masked_argmax(root_logits, root_lg), g=g,
        done=root_row[:, tree_lib.S_DONE] > 0.5,
        value=root_row[:, tree_lib.S_VALUE], to_move=root_states.to_move,
        schedule=table[m_eff].float(), warm_v=warm_v)

    for start, end, levels in stage_levels(num_rounds, num_stages,
                                           levels_cap):
        for r in range(start, end):
            trees = _sim_round(net, trees, r, levels, L, root, cv, cs,
                               compat)

    # outputs
    final_srow = trees.stats[:, :tree_lib.STRIDE]
    visit_counts_f, _ = tree_lib.unpack_visits_child(
        final_srow[:, tree_lib.VISITS_OFF:tree_lib.VISITS_OFF + A])
    root_vsum = final_srow[:, tree_lib.VSUM_OFF:tree_lib.VSUM_OFF + A]
    sigma = completed_q_sigma(visit_counts_f, root_vsum, root_p, root_lg,
                              root.value, cv, cs)
    if warm_v is not None:
        visit_counts_f = visit_counts_f - warm_v  # report fresh only

    # the move: argmax of g + logits + sigma among the maximally (freshly)
    # visited legal actions
    max_count = torch.where(root_lg, visit_counts_f, -1.0).max(
        -1, keepdim=True).values
    survivors = root_lg & (visit_counts_f == max_count)
    final_score = g + root_logits + sigma
    chosen = torch.where(survivors.any(-1),
                         _masked_argmax(final_score, survivors),
                         _masked_argmax(final_score, root_lg))

    improved = torch.softmax(torch.where(root_lg, root_logits + sigma, _NEG),
                             -1)
    improved = torch.where(root_lg, improved, 0.0)
    improved = improved / improved.sum(-1, keepdim=True).clamp_min(1e-12)

    return GumbelResult(
        visit_counts=visit_counts_f.to(torch.int32),
        action_probs=improved,
        chosen_action=chosen.to(torch.int32),
        root_value=tree_lib.root_value(trees),
        tree=trees,
    )
