"""Plain batched searches, Gumbel and PUCT, over the benchmark's own rules.

The reference that a self-play cell's recorded policies and moves are held
against: it runs the search itself, from the recorded root positions, with
the benchmark's draws and a net given as a function (the reference net at a
stated precision). Games are searched side by side, each with its own tree
of ``rounds * L + 1`` node slots; simulation round ``r`` writes slots ``r *
L + 1 ..``.

* A round picks ``L`` root actions one after another, then each lane
  descends below its pick: at an unexpanded edge it stops at its leaf (the
  state after that action is evaluated and written to the lane's slot), at
  a finished game it evaluates that node, and after ``levels`` levels it
  evaluates the node it reached. Every edge on a lane's path gains a visit
  and the evaluated value, negated where the edge's player is not the
  evaluated state's player to move, added lane by lane; an expanded leaf is
  linked to the first lane's slot that reached it.
* ``levels`` grows with the rounds in ``stages`` steps up to ``min(max_depth,
  simulations, 60)``: a stage ending at round ``e`` descends ``e`` levels.
* PUCT (Silver et al., 2018): ``argmax Q + c P sqrt(1 + sum N) / (1 + N)``
  over the legal actions, ``Q = 0`` where unvisited; at the root a pick
  already made this round counts as a visit that returned a loss, and the
  prior is mixed with Dirichlet noise, ``(1 - eps) P + eps D``, ``D`` the
  softmax of the given log-gamma draws over the legal actions.
* Gumbel (Danihelka et al., ICLR 2022): root pick ``i`` takes, among the
  legal actions whose fresh visit count equals the halving schedule's count
  for simulation ``i``, the one with the largest ``g + logits + sigma``;
  interior nodes take ``argmax pi - N / (1 + sum N)`` with ``pi`` the
  softmax of ``logits + sigma``. ``sigma`` is completed Q (``vsum / N`` where
  visited, else the mixed value) min-max rescaled over the legal actions and
  scaled by ``(c_visit + max N) * c_scale``. The move is the largest ``g +
  logits + sigma`` among the legal actions visited most; the policy is the
  softmax of ``logits + sigma``.
* A warm root (tree reuse) starts from the edge statistics of the previous
  search's child along the move played; schedules count fresh visits only.

Search arithmetic is float32, as the configurations state it. Nothing here
imports the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import rules

A = 65
NEG = -1e30
Net = Callable[[np.ndarray], Tuple[torch.Tensor, torch.Tensor]]


def stage_levels(rounds: int, stages: int, cap: int):
    """``(start, end, levels)`` of each depth stage of a search."""
    if stages <= 1 or rounds < 2 * stages:
        bounds = [rounds]
    else:
        bounds = []
        for s in range(1, stages + 1):
            b = rounds * s // stages
            if not bounds or b > bounds[-1]:
                bounds.append(b)
    start = 0
    for end in bounds:
        yield start, end, max(1, min(cap, end))
        start = end


def halving_schedule(m: int, sims: int) -> list:
    """Root visit count prescribed before each simulation: sequential
    halving over ``m`` candidate actions within ``sims`` simulations."""
    if m <= 1:
        return list(range(sims))
    phases = max(1, math.ceil(math.log2(m)))
    seq: list = []
    count, alive = 0, m
    while len(seq) < sims:
        for _ in range(max(1, sims // (phases * alive))):
            seq.extend([count] * alive)
            count += 1
        alive = max(2, alive // 2)
    return seq[:sims]


def masked_prior(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Softmax over the legal actions (uniform where none is legal), zero
    on the others."""
    low = torch.finfo(torch.float32).min
    p = torch.softmax(torch.where(legal, logits.float(), low), -1)
    p = torch.where(legal.any(-1, keepdim=True), p, 1.0 / A)
    return torch.where(legal, p, 0.0)


def terminal_value(s: dict) -> np.ndarray:
    """A finished game's result for its player to move, 0 while live."""
    w, tm = s["winner"], s["to_move"]
    val = ((w == tm) & (w != 0)).astype(np.float32) \
        - ((w == 3 - tm) & (w != 0)).astype(np.float32)
    return np.where(s["done"], val, 0.0).astype(np.float32)


def evaluate(net: Net, s: dict):
    """``(prior, value, legal)`` of states ``s``; a finished game takes its
    result as value."""
    logits, value = net(rules.planes(s))
    legal = torch.as_tensor(rules.legal_mask(s))
    done = torch.as_tensor(s["done"])
    value = torch.where(done, torch.as_tensor(terminal_value(s)),
                        value.float())
    return masked_prior(logits, legal), value, legal


def sigma(visits, vsum, prior, legal, raw_value, c_visit: float,
          c_scale: float) -> torch.Tensor:
    """Gumbel's ``sigma(completed Q)`` over ``[..., A]``."""
    seen = visits > 0
    q = torch.where(seen, vsum / visits.clamp_min(1.0), 0.0)
    total = visits.sum(-1, keepdim=True)
    p_seen = torch.where(seen, prior, 0.0)
    mean_q = (p_seen * q).sum(-1, keepdim=True) \
        / p_seen.sum(-1, keepdim=True).clamp_min(1e-12)
    mixed = (raw_value.unsqueeze(-1) + total * mean_q) / (total + 1.0)
    completed = torch.where(seen, q, mixed)
    hi = torch.where(legal, completed, NEG).max(-1, keepdim=True).values
    lo = torch.where(legal, completed, -NEG).min(-1, keepdim=True).values
    scaled = (completed - lo) / (hi - lo).clamp_min(1e-8)
    top = visits.max(-1, keepdim=True).values
    return (c_visit + top) * c_scale * torch.where(legal, scaled, 0.0)


def logits_of(prior: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    return torch.where(legal, prior.clamp_min(1e-12).log(), NEG)


def puct_pick(visits, vsum, prior, legal, c: float) -> torch.Tensor:
    q = torch.where(visits > 0, vsum / visits.clamp_min(1.0), 0.0)
    parent = visits.sum(-1, keepdim=True) + 1.0
    score = q + c * prior * parent.sqrt() / (1.0 + visits)
    return torch.where(legal, score, -math.inf).argmax(-1)


def masked_argmax(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, score, NEG).argmax(-1)


class Tree:
    """``G`` trees of ``N`` node slots: each node's state (numpy), prior,
    legality and value, and per edge its visits, value sum and child."""

    def __init__(self, G: int, N: int):
        self.state = {k: np.zeros((G, N), v.dtype)
                      for k, v in rules.initial(1).items()}
        self.prior = torch.zeros(G, N, A)
        self.legal = torch.zeros(G, N, A, dtype=torch.bool)
        self.value = torch.zeros(G, N)
        self.visits_np = np.zeros((G, N, A), np.float32)
        self.vsum_np = np.zeros((G, N, A), np.float32)
        self.visits = torch.from_numpy(self.visits_np)
        self.vsum = torch.from_numpy(self.vsum_np)
        self.child = torch.zeros(G, N, A, dtype=torch.int64)

    def write(self, slots: torch.Tensor, s: dict, prior, legal, value):
        """Nodes ``slots`` ``[G, L]`` take states ``s`` (flat ``[G * L]``)."""
        G, L = slots.shape
        g = np.repeat(np.arange(G), L)
        n = slots.reshape(-1).numpy()
        for k in self.state:
            self.state[k][g, n] = s[k]
        gi = torch.as_tensor(g)
        self.prior[gi, slots.reshape(-1)] = prior
        self.legal[gi, slots.reshape(-1)] = legal
        self.value[gi, slots.reshape(-1)] = value

    def node_state(self, node: torch.Tensor) -> dict:
        G, L = node.shape
        g = np.repeat(np.arange(G), L)
        n = node.reshape(-1).numpy()
        return {k: v[g, n] for k, v in self.state.items()}


def _descend(tree: Tree, a0, levels: int, select):
    """Each lane's path below its root pick ``a0`` ``[G, L]``: ``(nodes,
    actions, players)`` ``[G, L, levels]`` (node -1: no entry), its leaf
    ``(node, action)`` (action -1: nothing expanded) and the node whose
    state it evaluates (stepped by the leaf action where there is one)."""
    G, L = a0.shape
    gi = torch.arange(G)[:, None].expand(G, L)
    root_tm = torch.as_tensor(tree.state["to_move"][:, 0]).float()
    child0 = tree.child[gi, 0, a0]
    found = child0 == 0
    nodes = [torch.zeros(G, L, dtype=torch.int64)]
    actions = [a0]
    players = [root_tm[:, None].expand(G, L)]
    leaf = torch.zeros(G, L, dtype=torch.int64)
    leaf_action = torch.where(found, a0, -1)
    at = torch.zeros(G, L, dtype=torch.int64)
    alive = ~found
    node = torch.where(alive, child0, 0)
    to_move = torch.as_tensor(tree.state["to_move"]).float()
    done = torch.as_tensor(tree.state["done"])
    for _ in range(1, levels):
        if not alive.any():  # the levels left would add no entry
            break
        a = select(gi, node)
        child = tree.child[gi, node, a]
        done_n = done[gi, node]
        step = alive & ~done_n
        found = step & (child == 0)
        nodes.append(torch.where(step, node, -1))
        actions.append(torch.where(step, a, 0))
        players.append(to_move[gi, node])
        ends = found | (alive & done_n)
        at = torch.where(ends, node, at)
        leaf = torch.where(found, node, leaf)
        leaf_action = torch.where(found, a, leaf_action)
        alive = alive & ~ends
        node = torch.where(alive, child, node)
    at = torch.where(alive, node, at)
    return (torch.stack(nodes, -1), torch.stack(actions, -1),
            torch.stack(players, -1), leaf, leaf_action, at)


def _backup(tree: Tree, nodes, actions, players, value, player, leaf,
            leaf_action, slot0: int) -> None:
    """Visits and values along every lane's path, lane by lane, then the
    links of the expanded leaves."""
    G, L, P = nodes.shape
    ok = (nodes >= 0).numpy()
    sign = torch.where(players == player[..., None].float(), 1.0, -1.0)
    inc = (sign * value[..., None]).numpy().astype(np.float32)
    g = np.broadcast_to(np.arange(G)[:, None, None], (G, L, P))
    cells = (g[ok], nodes.numpy()[ok], actions.numpy()[ok])
    np.add.at(tree.visits_np, cells, np.float32(1.0))
    np.add.at(tree.vsum_np, cells, inc[ok])  # in lane order, game by game
    same = (leaf[:, :, None] == leaf[:, None, :]) \
        & (leaf_action[:, :, None] == leaf_action[:, None, :])
    earlier = torch.ones(L, L, dtype=torch.bool).tril(-1)
    link = (leaf_action >= 0) & ~(same & earlier).any(-1)
    gi = torch.arange(G)[:, None].expand(G, L)
    slots = (slot0 + torch.arange(L)).expand(G, L)
    tree.child[gi[link], leaf[link], leaf_action[link]] = slots[link]


def run(net: Net, root: dict, *, algorithm: str, simulations: int,
        leaf_batch: int, max_depth: int, stages: int,
        c_puct: float = 1.0, dirichlet_epsilon: float = 0.0,
        log_gamma: Optional[torch.Tensor] = None,
        max_considered: int = 16, c_visit: float = 50.0,
        c_scale: float = 0.1, gumbel: Optional[torch.Tensor] = None,
        warm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        warm_discount: float = 1.0) -> Dict:
    """One search from each of the live root states ``root`` ``[G]``.

    Returns ``visits`` (fresh root counts), ``policy`` (PUCT: the fresh
    counts over their sum; Gumbel: the improved policy), ``move`` (Gumbel's
    halving winner) and ``tree``."""
    G = len(root["done"])
    L = leaf_batch
    rounds = simulations // L
    tree = Tree(G, rounds * L + 1)
    prior, value, legal = evaluate(net, root)
    if algorithm == "puct":
        noise = torch.where(legal, torch.softmax(
            torch.where(legal, log_gamma.float(), -math.inf), -1), 0.0)
        prior = torch.where(legal, (1.0 - dirichlet_epsilon) * prior
                            + dirichlet_epsilon * noise, 0.0)
        prior = prior / prior.sum(-1, keepdim=True).clamp_min(1e-12)
    tree.write(torch.zeros(G, 1, dtype=torch.int64), root, prior, legal,
               value)
    warm_v = None
    if warm is not None:
        warm_v = torch.where(legal, warm[0].float().clamp_min(0.0), 0.0)
        warm_s = warm[1].float()
        if warm_discount != 1.0:
            scaled = torch.round(warm_v * warm_discount)
            warm_s = warm_s / warm_v.clamp_min(1.0) * scaled
            warm_v = scaled
        tree.visits[:, 0] = warm_v
        tree.vsum[:, 0] = torch.where(legal, warm_s, 0.0)
    root_value = value
    logits = logits_of(prior, legal)
    if algorithm == "gumbel":
        g = torch.where(legal, gumbel.float(), NEG)
        m = legal.sum(-1).clamp_max(max_considered)
        table = torch.tensor([halving_schedule(max(k, 1), simulations)
                              for k in range(max_considered + 1)],
                             dtype=torch.float32)[m]
        fallback = masked_argmax(logits, legal)

        def select(gi, node):
            v, s = tree.visits[gi, node], tree.vsum[gi, node]
            p, lg = tree.prior[gi, node], tree.legal[gi, node]
            sig = sigma(v, s, p, lg, tree.value[gi, node], c_visit, c_scale)
            pi = torch.softmax(torch.where(lg, logits_of(p, lg) + sig, NEG),
                               -1)
            return masked_argmax(pi - v / (1.0 + v.sum(-1, keepdim=True)),
                                 lg)
    else:
        def select(gi, node):
            return puct_pick(tree.visits[gi, node], tree.vsum[gi, node],
                             tree.prior[gi, node], tree.legal[gi, node],
                             c_puct)

    cap = max(1, min(max_depth, simulations, 60))
    for start, end, levels in stage_levels(rounds, stages, cap):
        for r in range(start, end):
            visits, vsum = tree.visits[:, 0], tree.vsum[:, 0]
            extra = torch.zeros(G, A)
            picks = []
            if algorithm == "gumbel":
                score = g + logits + sigma(visits, vsum, prior, legal,
                                           root_value, c_visit, c_scale)
                fresh = visits if warm_v is None else visits - warm_v
            for lane in range(L):
                if algorithm == "gumbel":
                    ok = legal & ((fresh + extra)
                                  == table[:, r * L + lane:r * L + lane + 1])
                    a = torch.where(ok.any(-1), masked_argmax(score, ok),
                                    fallback)
                else:
                    a = puct_pick(visits + extra, vsum - extra, prior, legal,
                                  c_puct)
                extra = extra + torch.nn.functional.one_hot(a, A).float()
                picks.append(a)
            nodes, actions, players, leaf, leaf_action, at = _descend(
                tree, torch.stack(picks, -1), levels, select)
            base = tree.node_state(at)
            expand = (leaf_action >= 0).reshape(-1).numpy()
            stepped = rules.step(base, np.where(
                expand, leaf_action.reshape(-1).numpy(), 0))
            s = {k: np.where(expand, stepped[k], base[k]) for k in base}
            p_c, v_c, lg_c = evaluate(net, s)
            slot0 = r * L + 1
            tree.write((slot0 + torch.arange(L)).expand(G, L), s, p_c, lg_c,
                       v_c)
            player = torch.as_tensor(s["to_move"]).view(G, L)
            _backup(tree, nodes, actions, players, v_c.view(G, L), player,
                    leaf, leaf_action, slot0)

    visits = tree.visits[:, 0].clone()
    out = dict(tree=tree, move=None)
    if algorithm == "gumbel":
        sig = sigma(visits, tree.vsum[:, 0], prior, legal, root_value,
                    c_visit, c_scale)
        fresh = visits if warm_v is None else visits - warm_v
        top = torch.where(legal, fresh, -1.0).max(-1, keepdim=True).values
        most = legal & (fresh == top)
        score = g + logits + sig
        out["move"] = torch.where(most.any(-1), masked_argmax(score, most),
                                  masked_argmax(score, legal))
        policy = torch.softmax(torch.where(legal, logits + sig, NEG), -1)
        policy = torch.where(legal, policy, 0.0)
        out["policy"] = policy / policy.sum(-1, keepdim=True).clamp_min(1e-12)
    else:
        fresh = visits if warm_v is None else visits - warm_v
        out["policy"] = fresh / fresh.sum(-1, keepdim=True).clamp_min(1.0)
    out["visits"] = fresh
    return out


def warm_after(tree: Tree, move: torch.Tensor):
    """Edge statistics of the root's child along ``move``: the next search's
    warm root (zeros where that child was never expanded)."""
    G = move.shape[0]
    gi = torch.arange(G)
    c = tree.child[gi, 0, move]
    ok = (c > 0)[:, None]
    return (torch.where(ok, tree.visits[gi, c], 0.0),
            torch.where(ok, tree.vsum[gi, c], 0.0))


def move_gap(score: torch.Tensor, allowed: torch.Tensor,
             played: torch.Tensor) -> torch.Tensor:
    """How far the played move's score lies below the best allowed one's
    (``inf`` where the played move is not allowed)."""
    best = torch.where(allowed, score, -torch.inf).max(-1).values
    mine = score.gather(-1, played.clamp_min(0)[:, None].long())[:, 0]
    ok = allowed.gather(-1, played.clamp_min(0)[:, None].long())[:, 0]
    return torch.where(ok, best - mine, torch.inf)


def puct_sample_score(counts: torch.Tensor, temperature: float,
                      noise: torch.Tensor) -> torch.Tensor:
    """``log p_T + g`` over the visited actions (``-inf`` elsewhere): PUCT's
    move is its argmax, ``p_T`` the counts at temperature ``T``."""
    counts = counts.double()
    logp = torch.where(counts > 0, counts.clamp_min(1e-300).log(),
                       -torch.inf) / max(temperature, 1e-3)
    return logp + noise.double()
