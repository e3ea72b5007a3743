"""Batched arena on the card: head-to-head matches and round-robin ELO
tournaments, with the merged-pairings promotion gate.

Port of ``alphazero_reversi_tpu/arena.py`` (single device). A match's games
run batched: every game starts with BLACK to move and the scheduled mover
colour alternates by ply, so at each half-ply a single-colour batch of games
(a *unit*) needs exactly one search, by the player who owns the scheduled
colour. ``play_units`` plays any list of units together and concatenates
the units whose searcher is the same model into one search batch: the
promotion gate (current, best, random; 6 units) runs two searches per
half-ply, current's and best's, and the random player none.

Where the JAX package scans over ply pairs inside one compiled program,
this is a Python loop of at most ``(max_moves + pass_slack + 1) // 2`` ply
pairs. A game whose mover differs from the schedule (an auto-pass gave one
player two plies in a row) stalls for one ply and realigns; ``pass_slack``
plies absorb that, and a game still live at the end is scored by piece
count. The loop reads one flag per unit per half-ply from the card: a group
whose games all have no move at the scheduled colour skips its search, and
the loop ends once every game is over. Neither changes a result, because
the move mask already holds those games.

Arena searches are deterministic: PUCT without root noise (the move is
sampled from the visit counts at the tournament temperature) or Gumbel at
``gumbel_scale=0`` (sampled from the tempered improved policy). With
``tree_reuse="root"`` each unit keeps, per searching side, its last search's
tree stats and the two actions since, and seeds the next search from the
grandchild (``tree.warm_stats_after``). Move sampling draws from one
``torch.Generator`` per unit, seeded from the tournament seed and the unit's
index; ``sample_noise`` replaces those draws (the parity tests inject JAX's
own).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch
from torch import nn

from .config import TournamentConfig
from .elo import ELORatingSystem
from .env import bitboard as env
from .mcts import gumbel as gumbel_lib
from .mcts import search as search_lib
from .mcts import tree as tree_lib
from .mcts.search import resolve_device, sample_actions

A = env.NUM_ACTIONS
Unit = Tuple[int, int, int, int]  # (a_idx, b_idx, num_games, a_color)


class Player(NamedTuple):
    """A tournament participant: a net, or the random baseline
    (``net=None``)."""

    name: str
    net: Optional[nn.Module] = None


def _random_probs(states: env.EnvState, compat: bool) -> torch.Tensor:
    """Uniform distribution over legal actions (the random baseline)."""
    legal = env.legal_action_mask(states, compat=compat).float()
    return legal / legal.sum(-1, keepdim=True).clamp_min(1e-9)


def _score_a(final: env.EnvState, a_color: int) -> torch.Tensor:
    """Per-game score for A: 1.0 win / 0.5 draw / 0.0 loss. Games still
    live at the ply cap are scored by piece count."""
    nb, nw = env.score(final)
    count_winner = torch.where(nb > nw, env.BLACK,
                               torch.where(nw > nb, env.WHITE, 0))
    winner = torch.where(final.done, final.winner, count_winner.to(
        final.winner.dtype))
    return torch.where(winner == a_color, 1.0,
                       torch.where(winner == 0, 0.5, 0.0))


def _make_side_probs(*, num_simulations: int, c_puct: float,
                     temperature: float, max_depth: int, compat: bool,
                     leaf_batch: int = 1, algorithm: str = "puct",
                     max_considered_actions: int = 16, c_visit: float = 50.0,
                     c_scale: float = 0.1, warm_discount: float = 1.0,
                     num_stages: int = 6, device=None) -> Callable:
    """Policy for one searching side at the tournament temperature: a PUCT
    search without root noise (``probs_with_temperature`` of its visit
    counts) or a Gumbel search at ``gumbel_scale=0``
    (``gumbel.play_probs``). The returned callable ``side_probs(states,
    net, warm=None)`` gives ``(probs, stats)``, ``stats`` the finished
    search's flat tree stats for the reuse carry."""
    if algorithm not in ("puct", "gumbel"):
        raise ValueError(f"unknown search algorithm {algorithm!r}")

    def side_probs(states: env.EnvState, net: nn.Module, warm=None):
        if algorithm == "puct":
            res = search_lib.run_search(
                net, states, num_simulations=num_simulations,
                c_puct=c_puct, dirichlet_alpha=0.3, dirichlet_epsilon=0.0,
                max_depth=max_depth, compat=compat, add_noise=False,
                num_stages=num_stages, leaf_batch=leaf_batch,
                warm_root=warm, warm_discount=warm_discount, device=device)
            return search_lib.probs_with_temperature(
                res.visit_counts, temperature), res.tree.stats
        n = states.done.shape[0]
        gres = gumbel_lib.run_gumbel_search(
            net, states, num_simulations=num_simulations,
            max_considered_actions=max_considered_actions, c_visit=c_visit,
            c_scale=c_scale, gumbel_scale=0.0, max_depth=max_depth,
            compat=compat, num_stages=num_stages, leaf_batch=leaf_batch,
            warm_root=warm, warm_discount=warm_discount,
            gumbel=torch.zeros(n, A, device=device), device=device)
        return gumbel_lib.play_probs(gres, temperature), gres.tree.stats

    return side_probs


def _cat_states(states: Sequence[env.EnvState]) -> env.EnvState:
    if len(states) == 1:
        return states[0]
    return env.EnvState(*(torch.cat(xs) for xs in zip(*states)))


def _check_units(units: Sequence[Unit], num_models: int) -> None:
    for a_idx, b_idx, n, a_col in units:
        if n <= 0:
            raise ValueError(f"unit game count {n} must be positive")
        if a_col not in (env.BLACK, env.WHITE):
            raise ValueError(f"unit a_color {a_col} not BLACK/WHITE")
        for m_idx in (a_idx, b_idx):
            if not 0 <= m_idx < num_models:
                raise ValueError(f"unit model index {m_idx} out of range")


@torch.no_grad()
def play_units(nets: Sequence[Optional[nn.Module]], units: Sequence[Unit], *,
               num_simulations: int, temperature: float,
               c_puct: float = 1.0, max_depth: int = 64, max_moves: int = 60,
               compat: bool = False, pass_slack: int = 16,
               leaf_batch: int = 1, algorithm: str = "puct",
               max_considered_actions: int = 16, c_visit: float = 50.0,
               c_scale: float = 0.1, tree_reuse: str = "off",
               tree_reuse_discount: float = 1.0, num_stages: int = 6,
               generators: Optional[Sequence[torch.Generator]] = None,
               sample_noise: Optional[Sequence[torch.Tensor]] = None,
               info: Optional[Dict[str, int]] = None,
               device=None) -> List[np.ndarray]:
    """Play every single-colour unit together on ``device`` (default CUDA),
    sharing each half-ply's searches across units by searcher model.

    ``nets``: one net per player (``None``: the random baseline), on the
    device, in eval mode. ``units``: ``(a_idx, b_idx, num_games, a_color)``,
    indices into ``nets``, the unit's game count and the colour A plays in
    all of them. ``generators``: one per unit for move sampling (default:
    the device's default generator). ``sample_noise``: one tensor per unit,
    ``[2 * num_pairs, num_games, A]``, the Gumbel draw of each half-ply
    (black, white, black, ...), replacing the generators. ``info``, when
    given, has
    this call's counts added to it: ``searches``, ``half_plies`` (with a
    move), ``searched_games``, ``moves`` (plies played) and ``unfinished``
    (games still live at the ply cap, scored by piece count).

    Returns each unit's ``score_a`` (1.0 win / 0.5 draw / 0.0 loss for A)
    as a numpy array.
    """
    units = [tuple(u) for u in units]
    if not units:
        return []
    _check_units(units, len(nets))
    if tree_reuse not in ("off", "root"):
        raise ValueError(f"unknown tree_reuse mode {tree_reuse!r}")
    dev = resolve_device(device)
    random_mask = [net is None for net in nets]
    searching = {u[i] for u in units for i in (0, 1)
                 if not random_mask[u[i]]}
    side_probs = None
    if searching:
        side_probs = _make_side_probs(
            num_simulations=num_simulations, c_puct=c_puct,
            temperature=temperature, max_depth=max_depth, compat=compat,
            leaf_batch=leaf_batch, algorithm=algorithm,
            max_considered_actions=max_considered_actions, c_visit=c_visit,
            c_scale=c_scale, warm_discount=tree_reuse_discount,
            num_stages=num_stages, device=dev)
    for m_idx in searching:
        if any(p.device != dev for p in nets[m_idx].parameters()):
            raise ValueError(f"net {m_idx}'s parameters must be on {dev}")
    reuse = tree_reuse == "root"
    n_units = len(units)
    num_pairs = (max_moves + pass_slack + 1) // 2
    if sample_noise is not None and len(sample_noise) != n_units:
        raise ValueError("sample_noise needs one tensor per unit")

    parts = [env.initial_state((n,), device=dev) for (_, _, n, _) in units]
    width = (num_simulations + 1) * tree_lib.STRIDE  # the search's tree
    # per unit, per side: (stats, a_self, a_opp), or None (no reuse, or the
    # search-free random baseline)
    carries: List[List[Any]] = []
    for a_idx, b_idx, n, _ in units:
        carries.append([
            None if not reuse or random_mask[m] else
            (torch.zeros(n, width, device=dev),
             torch.full((n,), -1, dtype=torch.int32, device=dev),
             torch.full((n,), -1, dtype=torch.int32, device=dev))
            for m in (a_idx, b_idx)])

    def groups_for(sched_color: int) -> List[Tuple[int, List[int]]]:
        """Searcher model index -> the units it moves for at this colour, in
        unit order."""
        groups: Dict[int, List[int]] = {}
        for u, (a_idx, b_idx, _, a_col) in enumerate(units):
            groups.setdefault(a_idx if a_col == sched_color else b_idx,
                              []).append(u)
        return sorted(groups.items())

    groups = {c: groups_for(c) for c in (env.BLACK, env.WHITE)}
    counts = dict(searches=0, half_plies=0, searched_games=0)
    moves = torch.zeros((), dtype=torch.int64, device=dev)

    for half in range(2 * num_pairs):
        sched = env.BLACK if half % 2 == 0 else env.WHITE
        move_ok = [(p.to_move == sched) & ~p.done for p in parts]
        flags = torch.stack([m.any() for m in move_ok]
                            + [(~p.done).any() for p in parts]).tolist()
        live, unfinished = flags[:n_units], flags[n_units:]
        if not any(unfinished):
            break
        if not any(live):
            continue
        counts["half_plies"] += 1
        probs_p: List[Optional[torch.Tensor]] = [None] * n_units
        stats_p: List[Optional[torch.Tensor]] = [None] * n_units
        for m_idx, us in groups[sched]:
            if not any(live[u] for u in us):
                continue
            if random_mask[m_idx]:
                for u in us:
                    probs_p[u] = _random_probs(parts[u], compat)
                continue
            warm = None
            if reuse:
                comps = [carries[u][0 if units[u][3] == sched else 1]
                         for u in us]
                warm = tree_lib.warm_stats_after(
                    *(torch.cat([c[i] for c in comps]) for i in range(3)))
            probs, stats = side_probs(_cat_states([parts[u] for u in us]),
                                      nets[m_idx], warm)
            counts["searches"] += 1
            counts["searched_games"] += probs.shape[0]
            sizes = [units[u][2] for u in us]
            for u, p, s in zip(us, probs.split(sizes), stats.split(sizes)):
                probs_p[u], stats_p[u] = p, s

        for u, (a_idx, b_idx, n, a_col) in enumerate(units):
            if not live[u]:
                continue  # no game moves: the updates below are no-ops
            states, ok = parts[u], move_ok[u]
            moves += ok.sum()
            actions = sample_actions(
                probs_p[u],
                generator=None if generators is None else generators[u],
                noise=None if sample_noise is None else sample_noise[u][half])
            new_states, _ = env.step(states, actions, compat=compat)
            parts[u] = env.where_state(ok, new_states, states)
            mover = 0 if a_col == sched else 1
            cm = carries[u][mover]
            if cm is not None and stats_p[u] is not None:
                stats, a_self, a_opp = cm
                carries[u][mover] = (
                    torch.where(ok[:, None], stats_p[u], stats),
                    torch.where(ok, actions, a_self),
                    torch.where(ok, -1, a_opp))
            co = carries[u][1 - mover]
            if co is not None:
                # a second mover move since the opponent's search (auto-pass
                # realignment) outruns the 2-ply carry: invalidate it
                stats_o, a_self_o, a_opp_o = co
                invalid = ok & (a_opp_o >= 0)
                carries[u][1 - mover] = (
                    stats_o, torch.where(invalid, -1, a_self_o),
                    torch.where(invalid, -1,
                                torch.where(ok, actions, a_opp_o)))

    if info is not None:
        counts["moves"] = int(moves)
        counts["unfinished"] = int(sum((~p.done).sum() for p in parts))
        for k, v in counts.items():
            info[k] = info.get(k, 0) + v
    scores = torch.cat([_score_a(f, units[u][3]) for u, f in
                        enumerate(parts)]).cpu().numpy()
    return list(np.split(scores, np.cumsum([u[2] for u in units])[:-1]))


def play_pair(net_a: Optional[nn.Module], net_b: Optional[nn.Module], *,
              num_games: int, black_games: Optional[int] = None,
              generators: Optional[Sequence[torch.Generator]] = None,
              **kwargs) -> np.ndarray:
    """``num_games`` games of A vs B as two single-colour halves: A plays
    BLACK in the first ``black_games`` (default ``num_games // 2``, and
    ``num_games`` must then be even) and WHITE in the rest. Returns A's
    per-game scores, A-as-BLACK games first. ``generators``: one per
    non-empty half. Other keyword arguments as in ``play_units``."""
    if black_games is None:
        if num_games % 2 != 0:
            raise ValueError(
                f"num_games={num_games} must be even (color split)")
        black_games = num_games // 2
    elif not 0 <= black_games <= num_games:
        raise ValueError(
            f"black_games={black_games} outside [0, {num_games}]")
    units = [(0, 1, n, c) for n, c in ((black_games, env.BLACK),
                                       (num_games - black_games, env.WHITE))
             if n > 0]
    scores = play_units([net_a, net_b], units, generators=generators,
                        **kwargs)
    return np.concatenate(scores) if scores else np.zeros(0, np.float32)


def _seed(*words: int) -> int:
    """A 64-bit generator seed, a pure function of ``words``."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


class Arena:
    """Round-robin tournament league on ``device`` (default CUDA). Each
    player's net is copied to the device in eval mode at registration."""

    def __init__(self, config: TournamentConfig, compat: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.config = config
        self.compat = compat
        self.elo = ELORatingSystem(k=config.elo_k_factor,
                                   initial_rating=config.elo_initial)
        self.players: List[Player] = []
        # play_units' counts since the arena was made
        self.play_info: Dict[str, int] = {}
        # unit indices the last run_tournament(_sharded) played here
        self.units_played: List[int] = []

    def add_player(self, name: str, net: Optional[nn.Module] = None,
                   rating: Optional[float] = None) -> None:
        if net is not None:
            net = copy.deepcopy(net).to(self.device).eval()
        self.players.append(Player(name=name, net=net))
        self.elo.add_player(name, rating)

    def _generators(self, seeds: Sequence[int]) -> List[torch.Generator]:
        return [torch.Generator(device=self.device).manual_seed(s)
                for s in seeds]

    def _play_kwargs(self) -> Dict[str, Any]:
        cfg = self.config
        return dict(num_simulations=cfg.num_simulations,
                    c_puct=cfg.c_puct, temperature=cfg.temperature,
                    compat=self.compat,
                    algorithm=cfg.algorithm,
                    max_considered_actions=cfg.max_considered_actions,
                    c_visit=cfg.c_visit, c_scale=cfg.c_scale,
                    tree_reuse=cfg.tree_reuse,
                    tree_reuse_discount=cfg.tree_reuse_discount,
                    info=self.play_info, device=self.device)

    def play_games(self, a: Player, b: Player, seed: int,
                   num_games: int) -> np.ndarray:
        """Batched A-vs-B match, A as BLACK in the first half (``num_games``
        even); returns per-game scores for A."""
        return play_pair(a.net, b.net, num_games=num_games,
                         generators=self._generators(
                             [_seed(seed, 0), _seed(seed, 1)]),
                         **self._play_kwargs())

    def play_units_merged(self, units) -> List[np.ndarray]:
        """Play ``_tournament_units`` work units ``(i, j, num_games,
        black_games, seed)``, ``black_games`` in ``{0, num_games}``, all
        together (``play_units``). Returns per-unit score arrays in input
        order."""
        spec, seeds = [], []
        for i, j, ng, bg, seed in units:
            if bg not in (0, ng):
                raise ValueError(
                    f"merged units must be single-color (black_games={bg}, "
                    f"num_games={ng})")
            spec.append((i, j, ng, env.BLACK if bg else env.WHITE))
            seeds.append(seed)
        return play_units([p.net for p in self.players], spec,
                          generators=self._generators(seeds),
                          **self._play_kwargs())

    def run_tournament(self, seed: int, rounds: Optional[int] = None, *,
                       shard_index: int = 0, shard_count: int = 1,
                       gather: Optional[Callable] = None) -> List[Dict]:
        """Every pair plays ``games_per_pair`` games per round; per-game ELO
        updates. ``merge_pairings`` plays the canonical units all together,
        ``batch_rounds`` one batch per pairing, otherwise one match per
        pairing per round with the first mover alternating by ``(i + j +
        round) % 2``.

        The pairing mode's units of play (``_units``) may be dealt out over
        shards (``_run_units``); every unit has its own generator seeds and
        the ratings never feed back into play, so every shard ends with the
        one-shard leaderboard and history."""
        rounds = rounds if rounds is not None else self.config.rounds
        return self._run_units(seed, rounds, self.config.merge_pairings,
                               shard_index, shard_count, gather)

    def run_tournament_sharded(self, seed: int, shard_index: int = 0,
                               shard_count: int = 1,
                               gather: Optional[Callable] = None,
                               rounds: Optional[int] = None) -> List[Dict]:
        """The pipeline's gate over shards: the canonical merged units
        whatever the pairing mode (as the JAX pipeline's multi-process
        gate), this shard's all in one ``play_units`` call
        (``_run_units``). One shard plays every unit: it is
        ``run_tournament``, in the config's pairing mode, and gathers
        nothing."""
        rounds = rounds if rounds is not None else self.config.rounds
        if shard_count == 1:
            return self.run_tournament(seed, rounds)
        return self._run_units(seed, rounds, True, shard_index, shard_count,
                               gather)

    def _run_units(self, seed: int, rounds: int, merged: bool,
                   shard_index: int, shard_count: int,
                   gather: Optional[Callable]) -> List[Dict]:
        """Play this shard's units (``_units``): unit ``u`` when ``u %
        shard_count == shard_index`` (``units_played`` lists them), each
        ``play_games`` match alone at the shape one shard gives it, or all
        merged units in one ``play_units_merged`` call. ``gather(scores,
        owners)`` merges the ``[U, G]`` score rows over the shards, each
        unit's row from its owner (``parallel.multihost.score_gather``).
        Then the ELO updates are replayed in the one-shard order: per-round
        match by match with the match's first mover as A, otherwise
        ``_replay_elo``'s."""
        units = self._units(seed, rounds, merged)
        mine = [u for u in range(len(units))
                if u % shard_count == shard_index]
        self.units_played = mine
        if not units:
            return self.elo.get_leaderboard()
        if merged:
            played = self.play_units_merged([units[u] for u in mine])
        else:
            played = [self.play_games(self.players[units[u][0]],
                                      self.players[units[u][1]],
                                      units[u][3], units[u][2])
                      for u in mine]
        scores = np.zeros((len(units), max(u[2] for u in units)),
                          np.float32)
        for u, s in zip(mine, played):
            scores[u, :len(s)] = s
        if gather is not None:
            scores = gather(scores, np.arange(len(units)) % shard_count)
        if not (merged or self.config.batch_rounds):
            # per-round: each match's games in match order, as played
            for (a, b, n, _), row in zip(units, scores):
                for s in row[:n]:
                    self.elo.update_ratings(self.players[a].name,
                                            self.players[b].name, float(s))
            return self.elo.get_leaderboard()
        # an odd batch_rounds total drops its filler game
        keep = rounds * self.config.games_per_pair
        per_pair: Dict[Tuple[int, int], List[float]] = {}
        for (i, j, n, *_), row in zip(units, scores):
            per_pair.setdefault((i, j), []).extend(
                float(x) for x in row[:min(n, keep)])
        self._replay_elo(per_pair, rounds)
        return self.elo.get_leaderboard()

    def _units(self, seed: int, rounds: int, merged: bool) -> list:
        """The units of play, a pure function of the players, the config
        and ``seed``: the canonical colour-half units when ``merged``
        (``_tournament_units``); otherwise matches ``(a, b, num_games,
        match_seed)``, A moving first in the first half, match ``m`` seeded
        ``_seed(seed, m)``: with ``batch_rounds`` one per pairing of all
        its ``rounds * games_per_pair`` games (plus a filler game when that
        is odd), else one per round and pairing of ``games_per_pair``
        games, in round, pairing order."""
        if merged:
            return self._tournament_units(seed, rounds)
        n = len(self.players)
        g = self.config.games_per_pair
        if self.config.batch_rounds:
            total = rounds * g
            if total == 0:
                return []
            pairs = [(i, j, total + total % 2) for i in range(n)
                     for j in range(i + 1, n)]
        else:
            pairs = [(i, j, g) if (i + j + r) % 2 == 0 else (j, i, g)
                     for r in range(rounds) for i in range(n)
                     for j in range(i + 1, n)]
        return [(a, b, k, _seed(seed, m)) for m, (a, b, k) in enumerate(pairs)]

    def _replay_elo(self, per_pair: Dict[Tuple[int, int], List[float]],
                    rounds: int) -> None:
        """Per-game ELO updates in the canonical round-interleaved (round,
        pairing, game) order (ELO updates depend on their order)."""
        g = self.config.games_per_pair
        for round_num in range(rounds):
            for (i, j), scores in per_pair.items():
                for s in scores[round_num * g:(round_num + 1) * g]:
                    self.elo.update_ratings(self.players[i].name,
                                            self.players[j].name, s)

    def _tournament_units(self, seed: int, rounds: int):
        """Canonical (pairing, colour-half) work units ``(i, j, num_games,
        black_games, unit_seed)``: two single-colour batches per pairing.
        The list (order, game counts, seeds) is a pure function of the
        players, the config and ``seed``."""
        n = len(self.players)
        total = rounds * self.config.games_per_pair
        units = []
        pair = 0
        for i in range(n):
            for j in range(i + 1, n):
                nb = (total + 1) // 2  # odd totals favour black
                nw = total // 2
                if nb:
                    units.append((i, j, nb, nb, _seed(seed, pair, 0)))
                if nw:
                    units.append((i, j, nw, 0, _seed(seed, pair, 1)))
                pair += 1
        return units

    def save_results(self, filepath: str) -> None:
        """Persist the ELO state."""
        self.elo.save_ratings(filepath)
