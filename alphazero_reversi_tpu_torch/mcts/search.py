"""Search machinery shared by the search drivers.

Port of the shared part of ``alphazero_reversi_tpu/mcts/search.py``: leaf
evaluation, the staged-unroll bounds, the selection-agnostic round tail
(evaluate, expand, back up), the temperature transform and the action
sampler. The PUCT driver (``run_search``) is not ported yet.

Value convention: every evaluated value is from the perspective of the
player to move at the evaluated state; the backup flips its sign per path
level only where that level's player differs (the env auto-passes, so not
every ply).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..env import bitboard as env
from ..models import resnet
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


def probs_with_temperature(visit_counts: torch.Tensor, temperature
                           ) -> torch.Tensor:
    """Visit counts -> action distribution at ``temperature``: ``tau`` below
    1e-3 plays the argmax, otherwise ``p(a) ∝ N(a)^(1/tau)``."""
    counts = visit_counts.float()
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=counts.device)
    greedy = torch.nn.functional.one_hot(
        counts.argmax(-1), counts.shape[-1]).float()
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
