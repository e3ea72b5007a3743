"""Parity of the port's self-play (``alphazero_reversi_tpu_torch.selfplay``)
with the JAX package's ``play_games`` under tree reuse, Gumbel and PUCT,
with JAX's own per-move draws injected into the port."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu import selfplay as jselfplay
from alphazero_reversi_tpu.config import Config as JConfig
from alphazero_reversi_tpu.ops import random as jrandom
from alphazero_reversi_tpu_torch import selfplay as tselfplay
from alphazero_reversi_tpu_torch.config import Config
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from torch_parity import (assert_states_equal, make_nets, random_positions,
                          to_jax_state)

B, T = 4, 6
KW = dict(num_simulations=8, c_puct=1.0, dirichlet_alpha=0.3,
          dirichlet_epsilon=0.25, temp_threshold=2, temp_init=1.0,
          temp_final=0.1, max_depth=4, max_moves=T, num_stages=2,
          algorithm="gumbel", max_considered_actions=4, tree_reuse="root")


def _jax_draws(key, batch, moves):
    """The Gumbel draws JAX's play_games makes: the split chain
    selfplay.py play_games (step keys, then search key) -> gumbel.py
    run_gumbel_search (gkey)."""
    def draws(key):
        step_keys = jax.random.split(key, moves)

        def one(k):
            search_key, _ = jax.random.split(k)
            gkey, _ = jax.random.split(search_key)
            return jax.random.gumbel(gkey, (batch, 65), jnp.float32)

        return jax.vmap(one)(step_keys)

    return np.asarray(jax.jit(draws)(key))


@pytest.fixture(scope="module")
def games():
    jnet, variables, tnet, _ = make_nets(8, 1, 8)
    key = jax.random.PRNGKey(3)
    # one game starts two plies from its end, so the batch contains a game
    # that finishes early and games that run into the max_moves cut
    init = random_positions(B, 2, plies=[0, 5, 30, 58])
    jtraj = jselfplay.play_games(jnet, variables, key, num_games=B,
                                 init_states=to_jax_state(init), **KW)
    ttraj = tselfplay.play_games(
        tnet, num_games=B, init_states=init,
        gumbel_noise=torch.tensor(_jax_draws(key, B, T)), device="cpu",
        **KW)
    return jtraj, ttraj


@pytest.mark.parametrize("field", ["actions", "valid", "to_move", "value"])
def test_trajectory_fields_exact(games, field):
    jtraj, ttraj = games
    np.testing.assert_array_equal(getattr(ttraj, field).numpy(),
                                  np.asarray(getattr(jtraj, field)))


def test_final_state_exact(games):
    jtraj, ttraj = games
    assert_states_equal(jtraj.final_state, ttraj.final_state)
    assert ttraj.final_state.done.any() and not ttraj.final_state.done.all()


def test_planes_and_policy_on_valid_rows(games):
    jtraj, ttraj = games
    valid = ttraj.valid.numpy()
    np.testing.assert_array_equal(ttraj.planes.numpy()[valid],
                                  np.asarray(jtraj.planes)[valid])
    np.testing.assert_allclose(ttraj.policy.numpy()[valid],
                               np.asarray(jtraj.policy)[valid], atol=1e-5)


def test_flatten_trajectory_matches_jax(games):
    jtraj, ttraj = games
    jflat = jselfplay.flatten_trajectory(jtraj)
    tflat = tselfplay.flatten_trajectory(ttraj)
    for j, t in zip(jflat, tflat):
        assert tuple(t.shape) == j.shape
    np.testing.assert_array_equal(tflat[2].numpy(), np.asarray(jflat[2]))
    np.testing.assert_array_equal(tflat[3].numpy(), np.asarray(jflat[3]))


def test_outcome_value_scores_cutoff_games_by_count():
    s = random_positions(8, 1, plies=[10, 20, 30, 40, 50, 60, 60, 60])
    to_move = torch.tensor([[1, 2] * 4, [2, 1] * 4], dtype=torch.int32)
    want = jax.vmap(jselfplay._outcome_value, in_axes=(None, 0))(
        to_jax_state(s), jnp.asarray(to_move.numpy()))
    np.testing.assert_array_equal(
        tselfplay._outcome_value(s, to_move).numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["flagship_run", "gumbel_fast",
                                  "default_config"])
def test_search_kwargs_match_jax(name):
    path = str(pathlib.Path(__file__).resolve().parent.parent / "configs"
               / f"{name}.json")
    j, t = JConfig.load(path), Config.load(path)
    assert tselfplay.search_kwargs(t.mcts, t.self_play) == \
        jselfplay.search_kwargs(j.mcts, j.self_play)


# PUCT with the temperature schedule switching after 2 moves, tiny-alpha
# root noise and discounted tree reuse
PUCT_KW = {**KW, "algorithm": "puct", "dirichlet_alpha": 0.03,
           "tree_reuse_discount": 0.25}


def _jax_puct_draws(key, batch, moves, alpha):
    """The draws JAX's PUCT play_games makes: selfplay.py play_games (step
    keys, then search and sample keys) -> search.py run_search's Dirichlet
    noise (ops/random.py sample_log_gamma on the search key) and
    search.sample_actions' jax.random.categorical (a Gumbel draw on the
    sample key)."""
    def draws(key):
        def one(k):
            search_key, sample_key = jax.random.split(k)
            return (jrandom.sample_log_gamma(search_key, alpha, (batch, 65)),
                    jax.random.gumbel(sample_key, (batch, 65), jnp.float32))

        return jax.vmap(one)(jax.random.split(key, moves))

    return tuple(np.array(x) for x in jax.jit(draws)(key))


@pytest.fixture(scope="module")
def puct_games():
    jnet, variables, tnet, _ = make_nets(9, 1, 8)
    key = jax.random.PRNGKey(4)
    init = random_positions(B, 3, plies=[0, 5, 30, 58])
    jtraj = jselfplay.play_games(jnet, variables, key, num_games=B,
                                 init_states=to_jax_state(init), **PUCT_KW)
    log_gamma, sample = _jax_puct_draws(key, B, T, 0.03)
    ttraj = tselfplay.play_games(
        tnet, num_games=B, init_states=init, device="cpu",
        log_gamma=torch.from_numpy(log_gamma),
        sample_noise=torch.from_numpy(sample), **PUCT_KW)
    return jtraj, ttraj


@pytest.mark.parametrize("field", ["actions", "valid", "to_move", "value",
                                   "planes", "policy"])
def test_puct_trajectory_exact(puct_games, field):
    """Every recorded array equal to JAX's (policy targets are visit counts
    over the simulation count: exact too)."""
    jtraj, ttraj = puct_games
    np.testing.assert_array_equal(getattr(ttraj, field).numpy(),
                                  np.asarray(getattr(jtraj, field)))


def test_puct_final_state_exact(puct_games):
    jtraj, ttraj = puct_games
    assert_states_equal(jtraj.final_state, ttraj.final_state)
    assert ttraj.final_state.done.any() and not ttraj.final_state.done.all()
    # the visit targets sum to 1 on every live slot
    policy = ttraj.policy[ttraj.valid]
    torch.testing.assert_close(policy.sum(-1), torch.ones(len(policy)))


def test_puct_selfplay_draws_from_generator():
    """Without injected draws both come from the generator: the same seed
    plays the same games, another seed other games."""
    _, _, tnet, _ = make_nets(9, 1, 8)
    kw = {**PUCT_KW, "max_moves": 4, "temp_threshold": 4}

    def play(seed):
        return tselfplay.play_games(
            tnet, num_games=8, device="cpu",
            generator=torch.Generator().manual_seed(seed), **kw).actions

    a, b, c = play(0), play(0), play(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_selfplay_wrapper_runs_on_cpu():
    _, _, tnet, cfg = make_nets(8, 1, 8)
    conf = Config()
    mcts = dataclasses.replace(conf.mcts, algorithm="gumbel",
                               num_simulations=4, max_depth=4, num_stages=2)
    sp = dataclasses.replace(conf.self_play, max_moves=2)
    planes, policy, value, valid = tselfplay.SelfPlay(
        tnet, mcts, sp, device="cpu").generate_training_data(0, num_games=3)
    assert planes.shape == (6, 8, 8, 3) and valid.all()
    torch.testing.assert_close(policy.sum(-1), torch.ones(6))
    assert set(value.tolist()) <= {-1.0, 0.0, 1.0}
    assert tenv.NUM_ACTIONS == policy.shape[-1]
