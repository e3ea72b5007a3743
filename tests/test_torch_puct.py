"""Parity of the port's PUCT search (``alphazero_reversi_tpu_torch.mcts.
search.run_search``) with the JAX package's, noise-free and with JAX's own
log-gamma draw injected, cold and warm-rooted, at one and four leaves a
round; and the port's Dirichlet sampler by distribution."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu.mcts import search as jsearch
from alphazero_reversi_tpu.ops import random as jrandom
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.mcts import search as tsearch
from alphazero_reversi_tpu_torch.mcts import tree as ttree
from alphazero_reversi_tpu_torch.ops import random as trandom
from torch_parity import make_nets, random_positions, to_jax_state

A = ttree.A
B = 6
ALPHA = 0.03
KW = dict(num_simulations=8, c_puct=1.0, dirichlet_alpha=ALPHA,
          dirichlet_epsilon=0.25, max_depth=4)
# Values and probabilities go through the two frameworks' f32 convs,
# softmaxes and sums, which differ in the last bits.
ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jnet, variables, tnet, _ = make_nets(5, 1, 8)
    # five positions from random play plus one finished game
    roots = random_positions(B, 4, plies=[0, 7, 19, 33, 48, 60])
    rng = np.random.default_rng(6)
    legal = tenv.legal_action_mask(roots).numpy()
    wv = np.where(legal, rng.integers(0, 5, (B, A)), 0).astype(np.float32)
    warm = (wv, (wv * rng.uniform(-1, 1, (B, A))).astype(np.float32))
    key = jax.random.PRNGKey(9)
    # the draw JAX's run_search makes from its key: ops/random.py
    # dirichlet_noise -> sample_log_gamma(key, alpha, legal.shape)
    log_gamma = np.asarray(jax.jit(
        lambda k: jrandom.sample_log_gamma(k, ALPHA, (B, A)))(key))
    return dict(jnet=jnet, variables=variables, tnet=tnet, roots=roots,
                warm=warm, key=key, log_gamma=log_gamma)


def _port_search(setup, noise, leaf_batch, discount, num_stages=3):
    warm = None if discount is None else tuple(
        map(torch.from_numpy, setup["warm"]))
    return tsearch.run_search(
        setup["tnet"], setup["roots"], add_noise=noise,
        leaf_batch=leaf_batch, warm_root=warm,
        warm_discount=1.0 if discount is None else discount,
        log_gamma=torch.tensor(setup["log_gamma"]) if noise else None,
        num_stages=num_stages, device="cpu", **KW)


CASES = {"cold-L1": (False, 1, None), "cold-L4": (False, 4, None),
         "warm1-L1": (False, 1, 1.0), "warm025-L4": (False, 4, 0.25),
         "noise-L1": (True, 1, None)}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request, setup):
    """(JAX result, port result) for one (noise, leaf_batch, warm discount)
    case. JAX runs unstaged (one compiled round body), the port in 3
    stages (the stage-3 rounds unroll all 4 levels)."""
    noise, leaf_batch, discount = CASES[request.param]
    warm = None if discount is None else tuple(map(jnp.asarray,
                                                   setup["warm"]))
    jres = jsearch.run_search(
        setup["jnet"], setup["variables"], to_jax_state(setup["roots"]),
        setup["key"], add_noise=noise, leaf_batch=leaf_batch,
        warm_root=warm, warm_discount=1.0 if discount is None else discount,
        num_stages=1, **KW)
    return jres, _port_search(setup, noise, leaf_batch, discount)


def test_visits_and_value_match(pair):
    jres, tres = pair
    np.testing.assert_array_equal(tres.visit_counts.numpy(),
                                  np.asarray(jres.visit_counts))
    np.testing.assert_allclose(tres.action_probs.numpy(),
                               np.asarray(jres.action_probs), atol=1e-7)
    np.testing.assert_allclose(tres.root_value.numpy(),
                               np.asarray(jres.root_value), atol=ATOL)
    # the finished game's root takes no visit; the others all of theirs
    assert tres.visit_counts[-1].sum() == 0
    assert (tres.visit_counts[:-1].sum(-1) == KW["num_simulations"]).all()


def test_whole_tree_matches(pair):
    """Rows: env state words bit-exact, prior/value columns within ATOL.
    Stats: packed visits|child cells exact, value sums within ATOL."""
    jres, tres = pair
    jrows = np.asarray(jres.tree.rows)
    trows = tres.tree.rows.numpy()
    state = slice(A, ttree.S_VALUE)
    np.testing.assert_array_equal(trows[..., state].view(np.int32),
                                  jrows[..., state].view(np.int32))
    np.testing.assert_allclose(trows, jrows, atol=ATOL)
    jstats = np.asarray(jres.tree.stats).reshape(B, -1, ttree.STRIDE)
    tstats = tres.tree.stats.numpy().reshape(B, -1, ttree.STRIDE)
    np.testing.assert_array_equal(tstats[..., :A], jstats[..., :A])
    np.testing.assert_allclose(tstats, jstats, atol=ATOL)
    np.testing.assert_array_equal(tres.tree.root_visit.numpy(),
                                  np.asarray(jres.tree.root_visit))


@pytest.mark.parametrize("case", ["warm025-L4", "noise-L1"])
def test_staged_matches_unstaged(setup, case):
    """The stage count only changes the select unroll: results identical."""
    noise, leaf_batch, discount = CASES[case]
    ref = _port_search(setup, noise, leaf_batch, discount, num_stages=1)
    got = _port_search(setup, noise, leaf_batch, discount, num_stages=6)
    for x, y in ((got.tree.rows, ref.tree.rows),
                 (got.tree.stats, ref.tree.stats),
                 (got.visit_counts, ref.visit_counts),
                 (got.root_value, ref.root_value)):
        assert torch.equal(x, y)


def test_dirichlet_noise_with_injected_draw_matches_jax(setup):
    legal = tenv.legal_action_mask(setup["roots"])
    got = trandom.dirichlet_noise(ALPHA, legal,
                                  log_gamma=torch.tensor(setup["log_gamma"]))
    want = jax.jit(lambda k, lg: jrandom.dirichlet_noise(k, ALPHA, lg))(
        setup["key"], jnp.asarray(legal.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("alpha", [0.3, 0.5, 1.0, 2.5])
def test_log_gamma_moments(alpha):
    """Gamma(alpha, 1) has mean and variance alpha: 200,000 draws hold the
    mean within 5 standard errors and the variance within 5%, the bounds
    of the JAX sampler's own test."""
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    g = trandom.sample_log_gamma(alpha, (n,), gen).double().exp()
    assert abs(g.mean().item() - alpha) < 5 * np.sqrt(alpha / n)
    assert abs(g.var().item() - alpha) < 0.05 * alpha


def test_dirichlet_noise_marginals():
    """100,000 masked draws at alpha 0.3 over 10 legal actions of 16: each
    component's mean is 1/10 within 0.003 and its standard deviation that
    of Beta(alpha, 9 alpha) within 3%."""
    n, k, alpha = 100_000, 10, 0.3
    legal = torch.zeros(n, 16, dtype=torch.bool)
    legal[:, :k] = True
    gen = torch.Generator().manual_seed(5)
    noise = trandom.dirichlet_noise(alpha, legal, generator=gen).double()
    assert (noise[:, k:] == 0).all()
    torch.testing.assert_close(noise.sum(-1), torch.ones(n, dtype=torch.
                                                          double),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(noise[:, :k].mean(0).numpy(), 1.0 / k,
                               atol=0.003)
    a0 = k * alpha
    std = np.sqrt(alpha * (a0 - alpha) / (a0 * a0 * (a0 + 1)))
    assert noise[:, :k].std(0).mean().item() == pytest.approx(std, rel=0.03)


def test_tiny_alpha_noise_is_finite_and_normalised():
    """alpha = 0.03 (the default config's) underflows float32 outside log
    space: the noise stays finite, sums to 1 over the legal actions, is 0
    off them, and a row with no legal action is all 0."""
    gen = torch.Generator().manual_seed(1)
    legal = torch.from_numpy(np.random.default_rng(2).random((512, A)) < 0.2)
    legal[0] = False
    noise = trandom.dirichlet_noise(0.03, legal, generator=gen)
    assert torch.isfinite(noise).all()
    assert (noise[~legal] == 0).all() and (noise[0] == 0).all()
    torch.testing.assert_close(noise[1:].sum(-1), torch.ones(511),
                               rtol=0, atol=1e-5)
    # concentrated draws: most rows put over half their mass on one action
    assert (noise[1:].max(-1).values > 0.5).float().mean() > 0.5


def test_add_dirichlet_noise_mixes_and_renormalises():
    rng = np.random.default_rng(3)
    legal = torch.from_numpy(rng.random((64, A)) < 0.3)
    legal[:, 64] |= ~legal.any(-1)
    prior = torch.where(legal, torch.from_numpy(rng.random((64, A))), 0.0)
    prior = (prior / prior.sum(-1, keepdim=True)).float()
    gen = torch.Generator().manual_seed(4)
    mixed = tsearch.add_dirichlet_noise(prior, legal, 0.3, 0.25,
                                        generator=gen)
    torch.testing.assert_close(mixed.sum(-1), torch.ones(64))
    assert (mixed[~legal] == 0).all()
    assert ((mixed - 0.75 * prior)[legal] >= -1e-6).all()


def test_puct_search_rejects_bad_leaf_batch(setup):
    with pytest.raises(ValueError, match="multiple"):
        tsearch.run_search(setup["tnet"], setup["roots"], leaf_batch=5,
                           device="cpu", **KW)
