"""Parity of the port's packed tree (``alphazero_reversi_tpu_torch.mcts.tree``)
and of the backup+link kernel's plain versions (the JAX-shaped
``backup_and_link`` and the round tail ``round_backup``) with the JAX
package. The kernel itself is held against the plain versions in
test_torch_cuda.py."""
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
from torch_round_inputs import ROUND_ARGS, round_inputs

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


def _torch_round_backup(d):
    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()
         if k != "slot0"}
    tree = ttree.Tree(rows=torch.zeros(0), stats=t["stats"],
                      root_visit=t["root_visit"], root_vsum=t["root_vsum"])
    out = ttree.round_backup(tree, *(t[k] for k in ROUND_ARGS), d["slot0"],
                             t["root_to_move"])
    return out.stats.numpy(), out.root_visit.numpy(), out.root_vsum.numpy()


def _jax_round_backup(d):
    """numpy transcription of JAX search.py:167-193 around JAX
    ``tree.backup_and_link`` (int32 indices, as JAX holds them)."""
    leaves, acts = d["leaves"], d["leaf_acts"]
    b, L = leaves.shape
    levels = d["pn"].shape[1] // L
    et_expand = np.repeat(d["eval_tomove"], levels, axis=1)
    v_expand = np.repeat(d["value"], levels, axis=1)
    sign = np.where(d["pt"] == et_expand.astype(np.float32), 1.0, -1.0)
    same = ((leaves[:, :, None] == leaves[:, None, :])
            & (acts[:, :, None] == acts[:, None, :]))
    earlier = np.tril(np.ones((L, L), bool), k=-1)[None]
    do_link = (acts >= 0) & ~(same & earlier).any(-1)
    slots = d["slot0"] + np.arange(L, dtype=np.int32)[None]
    stats = _jax_backup(dict(
        stats=d["stats"], nodes=d["pn"].astype(np.int32),
        actions=d["pa"].astype(np.int32),
        incs=(sign * v_expand).astype(np.float32),
        link_nodes=leaves.astype(np.int32),
        link_actions=np.maximum(acts, 0).astype(np.int32),
        link_slots=np.broadcast_to(slots, (b, L)).astype(np.int32),
        do_link=do_link))
    rsign = np.where(d["eval_tomove"] == d["root_to_move"][:, None], 1.0,
                     -1.0).astype(np.float32)
    return (stats, d["root_visit"] + np.int32(L),
            d["root_vsum"] + (rsign * d["value"]).sum(-1))


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("links", [1, 4])
def test_round_backup_reference_matches_jax(links, seed):
    """The round tail's plain version (what ``round_backup`` runs on the
    CPU) against JAX: stats and root visits exact, with in-round duplicate
    picks and shared root edges at L=4; root_vsum exact at L=1 and within
    1e-6 relative at L=4 (numpy sums the lanes in another order). Shapes
    are those of the backup tests above, so JAX compiles nothing new."""
    rng = np.random.default_rng(30 + 2 * links + seed)
    n, levels = (33, 8) if links == 1 else (9, 6)
    d = round_inputs(rng, 8, n, levels, links)
    got = _torch_round_backup(d)
    want = _jax_round_backup(d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if links == 1:
        np.testing.assert_array_equal(got[2], want[2])
    else:
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


@pytest.mark.parametrize("links", [8, 16, 32])
def test_round_backup_reference_sums_root_values_in_lane_order(links):
    """The plain version adds the lanes' signed values to ``root_vsum`` in
    lane order, one float32 add at a time, as the kernel's lane 0 does (the
    kernel is held bit for bit against it at the bench's L=8 and L=16)."""
    d = round_inputs(np.random.default_rng(links), 256, 65, 4, links)
    _, _, got = _torch_round_backup(d)
    rsign = np.where(d["eval_tomove"] == d["root_to_move"][:, None], 1.0,
                     -1.0).astype(np.float32)
    signed = rsign * d["value"]
    total = signed[:, 0].copy()
    for lane in range(1, links):
        total = (total + signed[:, lane]).astype(np.float32)
    np.testing.assert_array_equal(got, d["root_vsum"] + total)


def _round_args():
    return dict(stats=torch.zeros(2, S), pn=torch.zeros(2, 6, dtype=torch.long),
                pa=torch.zeros(2, 6, dtype=torch.long), pt=torch.zeros(2, 6),
                eval_tomove=torch.ones(2, 2, dtype=torch.int32),
                value=torch.zeros(2, 2),
                leaves=torch.zeros(2, 2, dtype=torch.long),
                leaf_acts=torch.zeros(2, 2, dtype=torch.long), slot0=1,
                root_to_move=torch.ones(2, dtype=torch.int32),
                root_visit=torch.zeros(2, dtype=torch.int32),
                root_vsum=torch.zeros(2))


@pytest.mark.parametrize("field,bad", [
    ("stats", torch.zeros(2, S, dtype=torch.float64)),
    ("pn", torch.zeros(2, 6, dtype=torch.int32)),
    ("pa", torch.zeros(2, 5, dtype=torch.long)),
    ("pt", torch.zeros(2, 6, dtype=torch.float64)),
    ("pn", torch.zeros(2, 5, dtype=torch.long)),
    ("eval_tomove", torch.ones(2, 2, dtype=torch.long)),
    ("value", torch.zeros(2, 3)),
    ("leaves", torch.zeros(2, 4, dtype=torch.long)[:, ::2]),
    ("leaf_acts", torch.zeros(3, 2, dtype=torch.long)),
    ("root_to_move", torch.ones(2, 1, dtype=torch.int32)),
    ("root_visit", torch.zeros(2)),
    ("root_vsum", torch.zeros(2, device="meta")),
])
def test_round_backup_rejects_bad_arguments(field, bad):
    """Bad arguments raise even after good ones of the same shapes passed
    (validation is cached per signature), and launch nothing."""
    cuda_backup.round_backup(**_round_args())
    args = _round_args()
    args[field] = bad
    before = cuda_backup.ROUND_LAUNCHES
    with pytest.raises(ValueError):
        cuda_backup.round_backup(**args)
    assert cuda_backup.ROUND_LAUNCHES == before


def test_round_backup_cpu_tensors_take_the_plain_version():
    d = round_inputs(np.random.default_rng(0), 4, 5, 3, 2)
    before = (cuda_backup.LAUNCHES, cuda_backup.ROUND_LAUNCHES)
    _torch_round_backup(d)
    assert (cuda_backup.LAUNCHES, cuda_backup.ROUND_LAUNCHES) == before


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
