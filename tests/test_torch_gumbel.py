"""Parity of the port's Gumbel search (``alphazero_reversi_tpu_torch.mcts.
gumbel`` over ``mcts.search`` and ``mcts.tree``) with the JAX package, with
noise-free and injected Gumbel draws, cold and warm-rooted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu.mcts import gumbel as jgumbel
from alphazero_reversi_tpu.mcts import search as jsearch
from alphazero_reversi_tpu_torch.mcts import gumbel as tgumbel
from alphazero_reversi_tpu_torch.mcts import search as tsearch
from alphazero_reversi_tpu_torch.mcts import tree as ttree
from torch_parity import make_nets, random_positions, to_jax_state

A = ttree.A
B = 6
KW = dict(num_simulations=8, max_considered_actions=4, c_visit=50.0,
          c_scale=0.1, max_depth=4)
# Values and probabilities go through the two frameworks' f32 convs,
# softmaxes and sums, which differ in the last bits.
ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jnet, variables, tnet, _ = make_nets(5, 1, 8)
    # five positions from random play plus one finished game
    roots = random_positions(B, 4, plies=[0, 7, 19, 33, 48, 60])
    rng = np.random.default_rng(6)
    legal = tgumbel.env.legal_action_mask(roots).numpy()
    wv = np.where(legal, rng.integers(0, 4, (B, A)), 0).astype(np.float32)
    warm = (wv, (wv * rng.uniform(-1, 1, (B, A))).astype(np.float32))
    key = jax.random.PRNGKey(9)
    draw = np.asarray(jax.jit(lambda k: jax.random.gumbel(
        jax.random.split(k)[0], (B, A), jnp.float32))(key))
    return dict(jnet=jnet, variables=variables, tnet=tnet, roots=roots,
                warm=warm, key=key, draw=draw)


def _port_search(setup, scale, warm, **kw):
    warm_t = None if warm is None else tuple(map(torch.from_numpy, warm))
    gen = torch.Generator().manual_seed(0)
    return tgumbel.run_gumbel_search(
        setup["tnet"], setup["roots"], gumbel_scale=scale, warm_root=warm_t,
        gumbel=torch.tensor(setup["draw"]) if scale else None,
        generator=gen, device="cpu", **{**KW, "num_stages": 2, **kw})


@pytest.fixture(scope="module", params=[(0.0, False), (0.0, True),
                                        (1.0, False), (1.0, True)],
                ids=["noisefree-cold", "noisefree-warm", "injected-cold",
                     "injected-warm"])
def pair(request, setup):
    """(JAX result, port result) for one (gumbel_scale, warm_root) case; the
    port gets JAX's own Gumbel draw for scale 1. JAX runs unstaged (one
    compiled round body), the port in 2 stages."""
    scale, use_warm = request.param
    warm = setup["warm"] if use_warm else None
    jres = jgumbel.run_gumbel_search(
        setup["jnet"], setup["variables"], to_jax_state(setup["roots"]),
        setup["key"], gumbel_scale=scale,
        warm_root=None if warm is None else tuple(map(jnp.asarray, warm)),
        num_stages=1, **KW)
    return jres, _port_search(setup, scale, warm)


def test_chosen_action_and_visits_exact(pair):
    jres, tres = pair
    np.testing.assert_array_equal(tres.chosen_action.numpy(),
                                  np.asarray(jres.chosen_action))
    np.testing.assert_array_equal(tres.visit_counts.numpy(),
                                  np.asarray(jres.visit_counts))


def test_policy_and_value_close(pair):
    jres, tres = pair
    np.testing.assert_allclose(tres.action_probs.numpy(),
                               np.asarray(jres.action_probs), atol=ATOL)
    np.testing.assert_allclose(tres.root_value.numpy(),
                               np.asarray(jres.root_value), atol=ATOL)


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


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_staged_matches_unstaged(setup, warm):
    """The stage count only changes the select unroll: results identical."""
    w = setup["warm"] if warm else None
    ref = _port_search(setup, 1.0, w, num_stages=1)
    for stages in (2, 4):
        got = _port_search(setup, 1.0, w, num_stages=stages)
        for x, y in ((got.tree.rows, ref.tree.rows),
                     (got.tree.stats, ref.tree.stats),
                     (got.action_probs, ref.action_probs),
                     (got.chosen_action, ref.chosen_action),
                     (got.root_value, ref.root_value)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("sims", [1, 5, 8, 16, 32, 50])
def test_schedule_table_matches_jax(sims):
    np.testing.assert_array_equal(tgumbel.schedule_table(16, sims),
                                  jgumbel.schedule_table(16, sims))


@pytest.mark.parametrize("seed", range(3))
def test_completed_q_sigma_matches_jax(seed):
    rng = np.random.default_rng(seed)
    visits = rng.integers(0, 5, (4, A)).astype(np.float32)
    vsum = (visits * rng.uniform(-1, 1, (4, A))).astype(np.float32)
    prior = rng.dirichlet(np.ones(A), 4).astype(np.float32)
    legal = rng.random((4, A)) < 0.6
    raw = rng.uniform(-1, 1, 4).astype(np.float32)
    want = jgumbel.completed_q_sigma(*map(jnp.asarray, (visits, vsum, prior,
                                                        legal, raw)),
                                     50.0, 0.1)
    got = tgumbel.completed_q_sigma(*map(torch.from_numpy, (
        visits, vsum, prior, legal, raw)), 50.0, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("tau", [0.0, 0.25, 1.0])
def test_probs_with_temperature_matches_jax(tau):
    counts = np.array([[0, 10, 5, 0], [0, 0, 0, 0], [3, 3, 1, 0]], np.int32)
    want = jsearch.probs_with_temperature(jnp.asarray(counts),
                                          jnp.float32(tau))
    got = tsearch.probs_with_temperature(torch.from_numpy(counts), tau)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("tau", [0.0, 0.5, 1.0])
def test_play_probs_matches_jax(setup, tau):
    res = _port_search(setup, 1.0, None)
    jres = jgumbel.GumbelResult(
        visit_counts=None, action_probs=jnp.asarray(res.action_probs.numpy()),
        chosen_action=jnp.asarray(res.chosen_action.numpy()),
        root_value=None, tree=None)
    np.testing.assert_allclose(tgumbel.play_probs(res, tau).numpy(),
                               np.asarray(jgumbel.play_probs(jres, tau)),
                               atol=1e-6)
