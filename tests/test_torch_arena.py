"""Parity of the port's arena (``alphazero_reversi_tpu_torch.arena``) with the
JAX package's: the merged-pairings program (Gumbel and PUCT searchers) with
JAX's own move-sampling draws injected, the grandchild reuse carry, the
action sampler, the tournament's ELO replay, and the agreement of the
port's three tournament paths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from alphazero_reversi_tpu import arena as jarena
from alphazero_reversi_tpu.config import TournamentConfig as JTournamentConfig
from alphazero_reversi_tpu.mcts import search as jsearch
from alphazero_reversi_tpu.mcts import tree as jtree
from alphazero_reversi_tpu_torch import arena as tarena
from alphazero_reversi_tpu_torch.config import TournamentConfig
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.mcts import gumbel as tgumbel
from alphazero_reversi_tpu_torch.mcts import search as tsearch
from alphazero_reversi_tpu_torch.mcts import tree as ttree
from torch_parity import make_nets, random_positions

A = ttree.A
BLACK, WHITE = tenv.BLACK, tenv.WHITE
# Player 0 is a net, player 1 the random baseline. With reuse on (net 0
# of two): unit 0 has the net as BLACK, unit 1 as BLACK against a random
# A, so the net searches both units' games at once at BLACK and the random
# player moves for both at WHITE. With reuse off (net 1): the net plays
# WHITE. (Each search in a JAX program costs about 20 s to compile on the
# CPU, so each program holds one.)
UNITS = {"root": [(0, 1, 2, BLACK), (1, 0, 2, WHITE)],
         "off": [(0, 1, 2, WHITE)]}
# 8 simulations over 2 considered actions: the searched root children have
# children of their own with visits, so the reuse carry finds warm
# grandchildren
KW = dict(num_simulations=8, temperature=1.0, max_depth=4,
          max_moves=12, pass_slack=4, algorithm="gumbel",
          max_considered_actions=2)
NUM_PAIRS = (KW["max_moves"] + KW["pass_slack"] + 1) // 2


def _sample_noise(keys, n):
    """The Gumbel draws behind JAX play_units' move sampling for each unit
    key: split(ukey, num_pairs) -> split(pair_key) -> split(step_key, 2)[1]
    -> jax.random.categorical's gumbel, half-ply by half-ply."""
    def per_unit(ukey):
        def per_pair(pair_key):
            return jnp.stack([
                jax.random.gumbel(jax.random.split(step_key, 2)[1], (n, A),
                                  jnp.float32)
                for step_key in jax.random.split(pair_key)])
        return jax.vmap(per_pair)(jax.random.split(ukey, NUM_PAIRS)) \
            .reshape(2 * NUM_PAIRS, n, A)
    return np.array(jax.jit(jax.vmap(per_unit))(jnp.stack(keys)))


# the units' keys and their draws (the "off" program's one unit takes the
# first key, as JAX's unit 0 would)
KEYS = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(2)]


@pytest.fixture(scope="module")
def draws():
    return list(torch.from_numpy(_sample_noise(KEYS, 2)))


@pytest.fixture(scope="module")
def nets():
    jnet, v0, t0, _ = make_nets(21, 2, 16)
    _, v1, t1, _ = make_nets(22, 2, 16)
    return jnet, {"root": (v0, t0), "off": (v1, t1)}


@pytest.fixture(scope="module", params=["root", "off"])
def merged(request, nets, draws):
    """(reuse mode, JAX per-unit scores, port per-unit scores, the port's
    play info) for one tree_reuse mode."""
    jnet, players = nets
    jvars, tnet = players[request.param]
    units = UNITS[request.param]
    jscores = jarena.play_units(jnet, (jvars, None), units,
                                KEYS[:len(units)],
                                random_mask=(False, True),
                                tree_reuse=request.param, c_puct=1.0,
                                **KW)
    noise = draws[:len(units)]
    info = {}
    warm_visits = []
    original = ttree.warm_stats_after

    def record(*args):
        out = original(*args)
        warm_visits.append(out[0].sum().item())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tarena.tree_lib, "warm_stats_after", record)
        tscores = tarena.play_units([tnet, None], units, sample_noise=noise,
                                    tree_reuse=request.param, info=info,
                                    device="cpu", **KW)
    return request.param, jscores, tscores, dict(info, warm=warm_visits)


def test_merged_units_scores_exact(merged):
    mode, jscores, tscores, _ = merged
    assert len(tscores) == len(UNITS[mode])
    for u, (j, t) in enumerate(zip(jscores, tscores)):
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=f"unit {u}")
    assert set(np.concatenate(tscores).tolist()) <= {0.0, 0.5, 1.0}


def test_merged_units_share_searches(merged):
    """One search per live half-ply at most (the net moves at one colour,
    the random player at the other); with reuse on, each search takes both
    units' games."""
    mode, _, _, info = merged
    assert 0 < info["searches"] <= info["half_plies"] <= 2 * NUM_PAIRS
    per_search = 4 if mode == "root" else 2
    assert info["searched_games"] == per_search * info["searches"]


# PUCT searchers at 6 simulations over 3 levels, c_puct 1.5; with reuse
# the warm evidence is halved
PUCT_KW = {**KW, "algorithm": "puct", "num_simulations": 6, "max_depth": 3,
           "c_puct": 1.5, "tree_reuse_discount": 0.5}


@pytest.fixture(scope="module", params=["root", "off"])
def merged_puct(request, nets, draws):
    """(reuse mode, JAX per-unit scores, port per-unit scores, the port's
    play info) for PUCT searchers."""
    jnet, players = nets
    jvars, tnet = players[request.param]
    units = UNITS[request.param]
    jscores = jarena.play_units(jnet, (jvars, None), units,
                                KEYS[:len(units)],
                                random_mask=(False, True),
                                tree_reuse=request.param, **PUCT_KW)
    info = {}
    tscores = tarena.play_units([tnet, None], units,
                                sample_noise=draws[:len(units)],
                                tree_reuse=request.param, info=info,
                                device="cpu", **PUCT_KW)
    return request.param, jscores, tscores, info


def test_merged_puct_units_scores_exact(merged_puct):
    mode, jscores, tscores, _ = merged_puct
    assert len(tscores) == len(UNITS[mode])
    for u, (j, t) in enumerate(zip(jscores, tscores)):
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=f"unit {u}")


def test_merged_puct_units_share_searches(merged_puct):
    """As with Gumbel searchers: at most one search a half-ply, over both
    units' games when reuse is on."""
    mode, _, _, info = merged_puct
    per_search = 4 if mode == "root" else 2
    assert 0 < info["searches"] <= info["half_plies"]
    assert info["searched_games"] == per_search * info["searches"]


def test_tree_reuse_carry_is_live(merged):
    """With reuse on, some searches of the parity run start from non-zero
    warm statistics (the grandchild carry); with reuse off, none reads
    the carry."""
    mode, _, _, info = merged
    if mode == "root":
        assert len(info["warm"]) == info["searches"]
        assert max(info["warm"]) > 0
    else:
        assert info["warm"] == []


@pytest.fixture(scope="module")
def search_tree():
    """A finished port search over 6 positions (8 simulations over 2
    considered actions: two-level subtrees)."""
    _, _, tnet, _ = make_nets(23, 1, 8)
    roots = random_positions(6, 9, plies=[0, 4, 11, 20, 31, 44])
    return tgumbel.run_gumbel_search(
        tnet, roots, num_simulations=8, max_considered_actions=2,
        max_depth=4, gumbel_scale=0.0, num_stages=1, device="cpu").tree


def test_warm_stats_after_matches_jax(search_tree):
    """Two-level and one-level descents, ``a_self < 0``, and missing
    children at both levels: exact against the JAX function."""
    children = ttree.children_index(search_tree).numpy()  # [B, N, A]
    visits = ttree.visit_counts(search_tree).numpy()
    a_self = np.full(6, -1, np.int32)
    a_opp = np.full(6, -1, np.int32)
    for g in range(6):
        a1 = int(visits[g, 0].argmax())
        c1 = children[g, 0, a1]
        assert c1 > 0
        a_self[g] = a1
        if g in (0, 4):  # two levels, to an expanded grandchild
            a_opp[g] = int(np.flatnonzero(children[g, c1] > 0)[0])
        elif g == 1:  # two levels, grandchild missing
            a_opp[g] = int(np.flatnonzero(children[g, c1] == 0)[0])
    a_self[2] = -1  # no previous search
    a_self[3] = int(np.flatnonzero(children[3, 0] == 0)[0])  # no child
    stats = search_tree.stats
    got = ttree.warm_stats_after(stats, torch.from_numpy(a_self),
                                 torch.from_numpy(a_opp))
    want = jtree.warm_stats_after(jnp.asarray(stats.numpy()),
                                  jnp.asarray(a_self), jnp.asarray(a_opp))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    warm_v = got[0].numpy()
    assert warm_v[[0, 4, 5]].sum(-1).min() > 0  # two- and one-level
    assert not warm_v[[1, 2, 3]].any()  # missing child, a_self < 0


def test_sample_actions_with_jax_noise_exact():
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(A) * 0.3, 256).astype(np.float32)
    probs[rng.random(probs.shape) < 0.5] = 0.0
    probs[:, 7] += 1e-3  # every row keeps a legal action
    probs /= probs.sum(-1, keepdims=True)
    key = jax.random.PRNGKey(11)
    want = jsearch.sample_actions(key, jnp.asarray(probs))
    noise = jax.random.gumbel(key, probs.shape, jnp.float32)
    got = tsearch.sample_actions(torch.from_numpy(probs),
                                 noise=torch.from_numpy(np.array(noise)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (probs[np.arange(256), got.numpy()] > 0).all()


def test_sample_actions_generator_follows_probs():
    """200,000 draws of one distribution from a generator: a chi-square
    test at p > 1e-4, and no draw off the support."""
    probs = torch.zeros(A)
    probs[[3, 10, 20, 40, 64]] = torch.tensor([0.4, 0.3, 0.15, 0.1, 0.05])
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    draws = tsearch.sample_actions(probs.expand(n, A), generator=gen)
    counts = torch.bincount(draws.long(), minlength=A).numpy()
    support = probs.numpy() > 0
    assert counts[~support].sum() == 0
    expected = probs.double().numpy()[support]
    _, p = scipy.stats.chisquare(counts[support],
                                 n * expected / expected.sum())
    assert p > 1e-4


def test_play_units_rejects_bad_units():
    kw = dict(temperature=1.0, device="cpu", **{k: v for k, v in KW.items()
                                                if k != "temperature"})
    with pytest.raises(ValueError):
        tarena.play_units([None], [(0, 0, 0, BLACK)], **kw)
    with pytest.raises(ValueError):
        tarena.play_units([None], [(0, 1, 2, BLACK)], **kw)
    with pytest.raises(ValueError):
        tarena.play_units([None, None], [(0, 1, 2, 3)], **kw)
    net = make_nets(8, 1, 8)[2]
    with pytest.raises(ValueError, match="algorithm"):
        tarena.play_units([net, None], [(0, 1, 2, BLACK)],
                          **{**kw, "algorithm": "alphabeta"})
    # PUCT is a searcher like Gumbel
    (scores,) = tarena.play_units([net, None], [(0, 1, 2, BLACK)],
                                  **{**kw, "algorithm": "puct",
                                     "num_simulations": 2})
    assert scores.shape == (2,) and set(scores.tolist()) <= {0.0, 0.5, 1.0}


def test_play_pair_halves_are_units():
    """A pair is its two single-colour units: random players, black_games
    None, 0 and all."""
    kw = dict(num_simulations=2, temperature=1.0, device="cpu")
    gens = lambda k: [torch.Generator().manual_seed(s) for s in range(k)]
    both = tarena.play_pair(None, None, num_games=6, generators=gens(2),
                            **kw)
    units = tarena.play_units([None, None], [(0, 1, 3, BLACK),
                                             (0, 1, 3, WHITE)],
                              generators=gens(2), **kw)
    np.testing.assert_array_equal(both, np.concatenate(units))
    white = tarena.play_pair(None, None, num_games=3, black_games=0,
                             generators=gens(1), **kw)
    assert white.shape == (3,)
    with pytest.raises(ValueError, match="even"):
        tarena.play_pair(None, None, num_games=3, **kw)


def _rigged_scores(units):
    rng = np.random.default_rng(len(units))
    return [rng.choice(np.float32([0.0, 0.5, 1.0]), u[2]) for u in units]


def test_merged_tournament_elo_matches_jax(monkeypatch):
    """On the same per-unit scores, the port's merged tournament replays
    the ELO updates as JAX's does: the same leaderboard to 1e-9."""
    jcfg = JTournamentConfig(rounds=3, games_per_pair=2, merge_pairings=True)
    tcfg = TournamentConfig(rounds=3, games_per_pair=2, merge_pairings=True)
    jar = jarena.Arena(None, jcfg)
    tar = tarena.Arena(tcfg, device="cpu")
    for name in ("current", "best", "random"):
        jar.add_player(name, None)
        tar.add_player(name, None)
    monkeypatch.setattr(jar, "play_units_merged", _rigged_scores)
    monkeypatch.setattr(tar, "play_units_merged", _rigged_scores)
    jboard = jar.run_tournament(jax.random.PRNGKey(0))
    tboard = tar.run_tournament(0)
    assert [p["player_id"] for p in tboard] == \
        [p["player_id"] for p in jboard]
    for t, j in zip(tboard, jboard):
        assert t["games_played"] == j["games_played"] == 12
        assert abs(t["rating"] - j["rating"]) <= 1e-9
    # the unit list: same pairings, game counts and colours as JAX's
    tunits = tar._tournament_units(0, 3)
    junits = jar._tournament_units(jax.random.PRNGKey(0), 3)
    assert [u[:4] for u in tunits] == [u[:4] for u in junits]
    assert tunits == tar._tournament_units(0, 3)  # a pure function
    assert len({u[4] for u in tunits}) == len(tunits)


def test_tournament_paths_agree():
    """Deterministic play (temperature 0, two nets): the merged and
    batch_rounds paths give the same leaderboard, and the per-round path
    (where b moves first) the same score per pairing."""
    _, _, t0, _ = make_nets(24, 1, 8)
    _, _, t1, _ = make_nets(25, 1, 8)
    boards, totals = {}, {}
    for path in ("merged", "batch", "rounds"):
        cfg = TournamentConfig(
            rounds=1, games_per_pair=2, num_simulations=1,
            algorithm="gumbel", max_considered_actions=1, temperature=0.0,
            tree_reuse="root", merge_pairings=path == "merged",
            batch_rounds=path == "batch")
        ar = tarena.Arena(cfg, device="cpu")
        ar.add_player("a", t0)
        ar.add_player("b", t1)
        boards[path] = ar.run_tournament(seed=3)
        totals[path] = sum(h["score_a"] if h["player_a"] == "a"
                           else h["score_b"] for h in ar.elo.history)
    assert boards["merged"] == boards["batch"]
    assert totals["merged"] == totals["batch"] == totals["rounds"]
    assert [p["games_played"] for p in boards["rounds"]] == [2, 2]
