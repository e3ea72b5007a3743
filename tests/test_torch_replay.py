"""Parity of the port's replay buffer (``alphazero_reversi_tpu_torch.
replay``) with the JAX package's: contents, cursor and size after several
inserts (one wraps the ring), and the gather on given indices."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu import replay as jreplay
from alphazero_reversi_tpu_torch import replay as treplay

CAPACITY, BATCH = 64, 40


def _batches(seed: int, n: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield ((rng.random((BATCH, 8, 8, 3)) < 0.3).astype(np.float32),
               rng.dirichlet(np.ones(65), BATCH).astype(np.float32),
               rng.integers(-1, 2, BATCH).astype(np.float32),
               rng.random(BATCH) < 0.7)


def _assert_same(tbuf, jbuf):
    np.testing.assert_array_equal(tbuf.planes.numpy(), np.asarray(jbuf.planes))
    np.testing.assert_array_equal(tbuf.policy.numpy(), np.asarray(jbuf.policy))
    np.testing.assert_array_equal(tbuf.value.numpy(), np.asarray(jbuf.value))
    assert (tbuf.cursor, tbuf.size) == (int(jbuf.cursor), int(jbuf.size))


@pytest.fixture(scope="module")
def buffers():
    """Both buffers after four inserts of 40 rows (~28 valid each): the
    third insert wraps the 64-row ring. Returns the states after each."""
    tbuf = treplay.create(CAPACITY, device="cpu")
    jbuf = jreplay.create(CAPACITY)
    states = []
    for planes, policy, value, valid in _batches(0, 4):
        tbuf = treplay.add(tbuf, *(torch.from_numpy(x) for x in
                                   (planes, policy, value, valid)))
        jbuf = jreplay.add(jbuf, *(jnp.asarray(x) for x in
                                   (planes, policy, value, valid)))
        states.append((tbuf._replace(
            planes=tbuf.planes.clone(), policy=tbuf.policy.clone(),
            value=tbuf.value.clone()), jbuf))
    return states


def test_create_matches_jax():
    tbuf = treplay.create(8, device="cpu")
    jbuf = jreplay.create(8)
    assert tbuf.planes.dtype == torch.int8 and tbuf.planes.shape == (8, 8, 8,
                                                                     3)
    assert tbuf.policy.shape == (8, 65) and tbuf.value.shape == (8,)
    _assert_same(tbuf, jbuf)


@pytest.mark.parametrize("inserts", [1, 2, 3, 4])
def test_add_matches_jax(buffers, inserts):
    tbuf, jbuf = buffers[inserts - 1]
    _assert_same(tbuf, jbuf)
    if inserts >= 3:
        assert tbuf.size == CAPACITY


def test_gather_matches_jax(buffers):
    tbuf, jbuf = buffers[-1]
    idx = np.random.default_rng(1).integers(0, CAPACITY, 32)
    got = treplay.gather(tbuf, torch.from_numpy(idx))
    jidx = jnp.asarray(idx)
    want = (jbuf.planes[jidx].astype(jnp.float32), jbuf.policy[jidx],
            jbuf.value[jidx])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_draws_filled_rows(buffers):
    tbuf, _ = buffers[0]
    gen = torch.Generator().manual_seed(0)
    planes, policy, value = treplay.sample(tbuf, gen, 256)
    assert planes.dtype == policy.dtype == value.dtype == torch.float32
    assert planes.shape == (256, 8, 8, 3) and policy.shape == (256, 65)
    # every sampled row is one of the `size` filled rows
    filled = tbuf.policy[:tbuf.size]
    assert (policy[:, None, :] == filled[None]).all(-1).any(-1).all()
    gen.manual_seed(0)
    again = treplay.sample(tbuf, gen, 256)
    assert all(torch.equal(a, b) for a, b in zip((planes, policy, value),
                                                 again))


def test_reset_and_oversized_insert():
    """``reset`` empties the buffer; an insert with more valid rows than
    the capacity keeps the last ``capacity`` of them, each in its ring
    slot (the later row wins)."""
    tbuf = treplay.create(4, device="cpu")
    value = torch.arange(10, dtype=torch.float32)
    valid = torch.ones(10, dtype=torch.bool)
    valid[3] = False
    tbuf = treplay.add(tbuf, torch.zeros(10, 8, 8, 3), torch.zeros(10, 65),
                       value, valid)
    # the 9 valid rows (values 0,1,2,4,...,9) take ring offsets 0..8 from
    # cursor 0; offsets 5..8 (values 6..9) are the last writes to slots
    # 1, 2, 3, 0
    assert (tbuf.cursor, tbuf.size) == (1, 4)
    assert tbuf.value.tolist() == [9.0, 6.0, 7.0, 8.0]
    tbuf = treplay.reset(tbuf)
    assert (tbuf.cursor, tbuf.size) == (0, 0)
