"""Parity of the port's bitboard env (``alphazero_reversi_tpu_torch.env``,
``ops.u64``) with the JAX package, bit for bit, in both rule modes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu.env import bitboard as jenv
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.ops import u64
from torch_parity import assert_states_equal, to_jax_state, to_torch_state

B = 32
PLIES = 64


def _env_outputs(env, state, action, compat):
    nxt, valid = env.step(state, action, compat=compat)
    return (nxt, valid, env.legal_action_mask(state, compat=compat),
            env.canonical_planes(state, compat=compat),
            env.terminal_value(state, state.to_move), env.score(state))


@pytest.fixture(scope="module", params=[False, True],
                ids=["correct", "compat"])
def mode(request):
    """(compat, one jitted JAX function of the whole env surface)."""
    compat = request.param
    fn = jax.jit(lambda s, a: _env_outputs(jenv, s, a, compat))
    return compat, fn


@pytest.mark.parametrize("seed", range(8))
def test_random_games_match_jax(mode, seed):
    """Random games (legal moves, plus 10% arbitrary actions that exercise
    the invalid-action no-op, the pass action and finished games): every
    ply's next state, validity, legal mask, planes, terminal value and score
    are bit-identical."""
    compat, jfn = mode
    rng = np.random.default_rng(seed)
    ts = tenv.initial_state((B,))
    js = to_jax_state(ts)
    for _ in range(PLIES):
        mask = tenv.legal_action_mask(ts, compat=compat).numpy()
        act = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 64
                        for m in mask], np.int32)
        wild = rng.random(B) < 0.1
        act = np.where(wild, rng.integers(0, 65, B), act).astype(np.int32)
        jout = jfn(js, jnp.asarray(act))
        tout = _env_outputs(tenv, ts, torch.from_numpy(act), compat)
        assert_states_equal(jout[0], tout[0])
        for j, t in zip(jout[1:5], tout[1:5]):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
        for j, t in zip(jout[5], tout[5]):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
        js, ts = jout[0], tout[0]
    assert ts.done.any()


def test_initial_state_matches_jax():
    assert_states_equal(jenv.initial_state((3,)), tenv.initial_state((3,)))


def test_state_roundtrip_through_jax_helpers():
    rng = np.random.default_rng(0)
    bits = rng.integers(-2**63, 2**63 - 1, size=(5,), dtype=np.int64)
    s = tenv.initial_state((5,))._replace(black=torch.from_numpy(bits))
    back = to_torch_state(to_jax_state(s))
    np.testing.assert_array_equal(back.black.numpy(), bits)


# ---- ops.u64 against Python's unbounded integers ------------------------

_WORDS = [0, 1, 0x8000000000000000, 0xFFFFFFFFFFFFFFFF, 0x0000000810000000,
          0xFEFEFEFEFEFEFEFE, 0x7F7F7F7F7F7F7F7F, 0x8000000100000001,
          0x123456789ABCDEF0]


_DIRS = (1, -1, 8, -8, 9, -9, 7, -7)  # the env's direction order


def _unsigned(v: int) -> int:
    return v % 2**64


@pytest.mark.parametrize("word", _WORDS, ids=hex)
def test_u64_ops_match_python_ints(word):
    """popcount, board expansion, word split and the env's 8-direction
    logical shift (the arithmetic-``>>`` hazard) against Python ints."""
    x = u64.from_int(word, (1,))
    assert int(u64.popcount(x)) == bin(word).count("1")
    assert [int(b) for b in u64.to_board(x).reshape(-1)] == \
        [(word >> i) & 1 for i in range(64)]
    hi, lo = u64.split_words(x)
    assert _unsigned(int(u64.join_words(hi, lo))) == word
    assert (int(hi) & 0xFFFFFFFF, int(lo) & 0xFFFFFFFF) == \
        (word >> 32, word & 0xFFFFFFFF)
    tb = tenv._tables(x.device)
    shifted = tenv._shift8(x.unsqueeze(-1), tb, tb.raw)[0]
    assert [_unsigned(int(v)) for v in shifted] == \
        [(word << d) % 2**64 if d > 0 else word >> -d for d in _DIRS]


def test_u64_bit_at():
    bits = u64.bit_at(torch.arange(64))
    assert [_unsigned(int(b)) for b in bits] == [1 << i for i in range(64)]
