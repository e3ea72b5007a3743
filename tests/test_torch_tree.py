"""Parity of the port's packed tree (``alphazero_reversi_tpu_torch.mcts.tree``)
and of the backup+link kernel's plain version with the JAX package. The
kernel itself is held against the plain version in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu.mcts import pallas_backup
from alphazero_reversi_tpu.mcts import tree as jtree
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.mcts import cuda_backup
from alphazero_reversi_tpu_torch.mcts import tree as ttree
from torch_parity import random_positions, to_jax_state

A, S, K = ttree.A, ttree.STRIDE, ttree.K


def test_layout_constants_match_jax():
    assert (ttree.K, ttree.STRIDE, ttree.PACK, ttree.VISITS_OFF,
            ttree.VSUM_OFF, ttree.S_VALUE) == (
        jtree.K, jtree.STRIDE, jtree.PACK, jtree.VISITS_OFF, jtree.VSUM_OFF,
        jtree.S_VALUE)


# 32-bit words whose f32 reading is a signalling NaN, a quiet NaN with a
# payload, -inf, a denormal, a negative denormal, -0.0 and the largest NaN
_SPECIAL = [0x7F800001, 0xFFC00123, 0xFF800000, 0x00000001, 0x807FFFFF,
            0x80000000, 0x7FFFFFFF]


@pytest.mark.parametrize("word", _SPECIAL, ids=hex)
def test_bitcast_rows_survive_row_ops(word):
    """Bitboards whose words are NaN/denormal patterns round-trip through
    make_row -> init_root/write_children_rows -> gather_node -> torch.where
    -> unpack_state unchanged, and pack like the JAX package's rows."""
    s = random_positions(4, 3)
    black = (s.black & 0xFFFFFFFF) | (word << 32)
    white = torch.full_like(s.white, (word ^ 0x00000100) - (1 << 32)
                            if word >= 1 << 31 else word ^ 0x00000100)
    s = s._replace(black=black, white=white)
    prior = torch.full((4, A), 1 / A)
    legal = tenv.legal_action_mask(s)
    value = np.array([-1.0, -0.3, 0.6, 1.0], np.float32)
    rows = ttree.make_row(s, prior, legal, torch.from_numpy(value))

    want = np.asarray(jtree.make_row(to_jax_state(s), jnp.asarray(prior),
                                     jnp.asarray(legal.numpy()),
                                     jnp.asarray(value)))
    np.testing.assert_array_equal(rows.numpy().view(np.int32),
                                  want.view(np.int32))

    t = ttree.make_tree(4, 3)
    t = ttree.init_root(t, s, prior, legal)
    t = ttree.write_children_rows(t, 1, rows[:, None].expand(4, 2, K))
    got, _ = ttree.gather_node(t, torch.tensor([[1], [2], [0], [2]]))
    got = torch.where(torch.ones(4, 1, dtype=torch.bool), got[:, 0],
                      torch.zeros(4, K))
    back = ttree.unpack_state(got[:, A:])
    for x, y in zip(back, s):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def _backup_inputs(rng, b, n, p, links, distinct=False):
    """Random backup+link arguments. ``distinct`` gives every game distinct
    path nodes, as a single-leaf descent does."""
    if distinct:
        nodes = np.stack([rng.permutation(n)[:p] for _ in range(b)])
        nodes = np.where(rng.random((b, p)) < 0.75, nodes, -1)
    else:
        nodes = np.where(rng.random((b, p)) < 0.75,
                         rng.integers(0, n, (b, p)), -1)
    return dict(
        stats=(rng.integers(0, 50, (b, n * S)) * 1024.0
               + rng.normal(0, 1, (b, n * S))).astype(np.float32),
        nodes=nodes.astype(np.int32),
        actions=rng.integers(0, A, (b, p)).astype(np.int32),
        incs=rng.normal(0, 1, (b, p)).astype(np.float32),
        link_nodes=rng.integers(0, n, (b, links)).astype(np.int32),
        link_actions=rng.integers(0, A, (b, links)).astype(np.int32),
        link_slots=rng.integers(1, n, (b, links)).astype(np.int32),
        do_link=rng.random((b, links)) < 0.8)


def _torch_backup(d):
    stats = torch.from_numpy(d["stats"].copy())
    cuda_backup.backup_and_link(
        stats, *(torch.from_numpy(d[k]) for k in (
            "nodes", "actions", "incs", "link_nodes", "link_actions",
            "link_slots", "do_link")))
    return stats.numpy()


def _jax_backup(d):
    b, m = d["stats"].shape
    t = jtree.Tree(rows=jnp.zeros((b, m // S, K)),
                   stats=jnp.asarray(d["stats"]),
                   root_visit=jnp.zeros(b, jnp.int32),
                   root_vsum=jnp.zeros(b))
    return np.asarray(jtree.backup_and_link(
        t, *(jnp.asarray(d[k]) for k in (
            "nodes", "actions", "incs", "link_nodes", "link_actions",
            "link_slots", "do_link"))).stats)


@pytest.mark.parametrize("seed", range(3))
def test_backup_reference_single_leaf_exact(seed):
    """L=1: the plain version equals JAX ``backup_and_link`` and the Pallas
    kernel (interpret mode) exactly."""
    rng = np.random.default_rng(seed)
    d = _backup_inputs(rng, 8, 33, 8, 1, distinct=True)
    got = _torch_backup(d)
    np.testing.assert_array_equal(got, _jax_backup(d))
    link = np.stack([d["link_nodes"][:, 0], d["link_actions"][:, 0],
                     np.where(d["do_link"][:, 0], d["link_slots"][:, 0], -1)],
                    -1).astype(np.int32)
    pallas = pallas_backup.backup_and_link_tpu(
        jnp.asarray(d["stats"]), jnp.float32(jtree.PACK),
        jnp.asarray(d["nodes"]), jnp.asarray(d["actions"]),
        jnp.asarray(d["incs"]), jnp.asarray(link), games_per_block=8,
        interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("seed", range(3))
def test_backup_reference_multi_leaf(seed):
    """L=4 with colliding cells: equal to the jnp scatter within rtol 1e-6
    (the two may add a collided vsum cell's increments in another order)."""
    rng = np.random.default_rng(10 + seed)
    d = _backup_inputs(rng, 8, 9, 4 * 6, 4)
    np.testing.assert_allclose(_torch_backup(d), _jax_backup(d), rtol=1e-6,
                               atol=1e-6)


def test_backup_drops_out_of_range_updates():
    """Flat indices past the row are dropped, as JAX's mode='drop' does."""
    stats = torch.zeros(1, 2 * S)
    i32 = lambda *v: torch.tensor([v], dtype=torch.int32)
    cuda_backup.backup_and_link(
        stats, i32(2, 1), i32(0, 64), torch.tensor([[5.0, 7.0]]), i32(2),
        i32(0), i32(3), torch.tensor([[True]]))
    want = torch.zeros(1, 2 * S)
    want[0, S + 64] = ttree.PACK
    want[0, S + 64 + A] = 7.0
    np.testing.assert_array_equal(stats.numpy(), want.numpy())


@pytest.mark.parametrize("field,bad", [
    ("stats", torch.zeros(2, S, dtype=torch.float64)),
    ("stats", torch.zeros(2, S + 1)),
    ("nodes", torch.zeros(2, 3, dtype=torch.int64)),
    ("actions", torch.zeros(2, 4, dtype=torch.int32)),
    ("value_incs", torch.zeros(3, 3)),
    ("do_link", torch.zeros(2, 1, dtype=torch.int32)),
    ("link_slots", torch.zeros(2, 2, dtype=torch.int32)[:, :1]),
])
def test_backup_wrapper_rejects_bad_arguments(field, bad):
    args = dict(stats=torch.zeros(2, S),
                nodes=torch.zeros(2, 3, dtype=torch.int32),
                actions=torch.zeros(2, 3, dtype=torch.int32),
                value_incs=torch.zeros(2, 3),
                link_nodes=torch.zeros(2, 1, dtype=torch.int32),
                link_actions=torch.zeros(2, 1, dtype=torch.int32),
                link_slots=torch.zeros(2, 1, dtype=torch.int32),
                do_link=torch.zeros(2, 1, dtype=torch.bool))
    args[field] = bad
    before = cuda_backup.LAUNCHES
    with pytest.raises(ValueError):
        cuda_backup.backup_and_link(**args)
    assert cuda_backup.LAUNCHES == before


def test_cpu_tensors_take_the_plain_version():
    d = _backup_inputs(np.random.default_rng(0), 4, 5, 6, 1)
    before = cuda_backup.LAUNCHES
    _torch_backup(d)
    assert cuda_backup.LAUNCHES == before


def _random_tree(rng, b, n):
    """A JAX/torch tree pair with integral visits, child links and vsums."""
    stats = np.zeros((b, n, S), np.float32)
    visits = rng.integers(0, 6, (b, n, A))
    child = np.where(rng.random((b, n, A)) < 0.2,
                     rng.integers(1, n, (b, n, A)), 0)
    stats[:, :, :A] = visits * ttree.PACK + child
    stats[:, :, A:] = rng.normal(0, 1, (b, n, A)) * visits
    stats = stats.reshape(b, n * S)
    rv = rng.integers(0, 40, b).astype(np.int32)
    rs = rng.normal(0, 5, b).astype(np.float32)
    jt = jtree.Tree(rows=jnp.zeros((b, n, K)), stats=jnp.asarray(stats),
                    root_visit=jnp.asarray(rv), root_vsum=jnp.asarray(rs))
    tt = ttree.Tree(rows=torch.zeros(b, n, K), stats=torch.from_numpy(stats),
                    root_visit=torch.from_numpy(rv),
                    root_vsum=torch.from_numpy(rs))
    return jt, tt


@pytest.mark.parametrize("seed", range(2))
def test_read_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    jt, tt = _random_tree(rng, 6, 7)
    for name in ("root_visit_counts", "children_index", "visit_counts"):
        np.testing.assert_array_equal(getattr(ttree, name)(tt).numpy(),
                                      np.asarray(getattr(jtree, name)(jt)))
    np.testing.assert_allclose(ttree.root_value(tt).numpy(),
                               np.asarray(jtree.root_value(jt)), rtol=1e-6)
    act = rng.integers(0, A, 6)
    jw = jtree.root_child_warm_stats(jt, jnp.asarray(act, jnp.int32))
    tw = ttree.root_child_warm_stats(tt, torch.from_numpy(act))
    for j, t in zip(jw, tw):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jd = jtree.discount_warm(*jw, 0.37)
    td = ttree.discount_warm(*tw, 0.37)
    for j, t in zip(jd, td):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    legal = rng.random((6, A)) < 0.5
    js = jtree.seed_root_stats(jt, *jw, jnp.asarray(legal))
    ts = ttree.seed_root_stats(tt, *tw, torch.from_numpy(legal))
    np.testing.assert_array_equal(ts.stats.numpy(), np.asarray(js.stats))
    np.testing.assert_array_equal(ts.root_visit.numpy(),
                                  np.asarray(js.root_visit))
    np.testing.assert_allclose(ts.root_vsum.numpy(), np.asarray(js.root_vsum),
                               rtol=1e-6)
