"""Helpers shared by the ``test_torch_*`` parity tests: moving env states,
weights and nets between the JAX package and its PyTorch port as numpy."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_reversi_tpu.env import bitboard as jenv
from alphazero_reversi_tpu.models import resnet as jresnet
from alphazero_reversi_tpu.ops.u64 import U64
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.models import resnet as tresnet
from alphazero_reversi_tpu_torch.models.weights import state_dict_from_flax

# The port's CPU tests run eager ops on tiny tensors, where torch's
# intra-op thread pool costs far more than it gains (a tiny self-play batch
# runs over ten times slower with it), most of all when test workers share
# the host's cores.
torch.set_num_threads(1)


def u64_to_int64(x: U64) -> np.ndarray:
    hi = np.asarray(x.hi).astype(np.uint64)
    lo = np.asarray(x.lo).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


def int64_to_u64(x) -> U64:
    u = np.asarray(x, np.int64).view(np.uint64)
    return U64(hi=jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
               lo=jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def to_torch_state(s: jenv.EnvState, device="cpu") -> tenv.EnvState:
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    return tenv.EnvState(black=t(u64_to_int64(s.black)),
                         white=t(u64_to_int64(s.white)),
                         to_move=t(s.to_move), passed=t(s.passed),
                         done=t(s.done), winner=t(s.winner))


def to_jax_state(s: tenv.EnvState) -> jenv.EnvState:
    n = lambda a: jnp.asarray(a.cpu().numpy())
    return jenv.EnvState(black=int64_to_u64(s.black.cpu().numpy()),
                         white=int64_to_u64(s.white.cpu().numpy()),
                         to_move=n(s.to_move), passed=n(s.passed),
                         done=n(s.done), winner=n(s.winner))


def assert_states_equal(js: jenv.EnvState, ts: tenv.EnvState) -> None:
    np.testing.assert_array_equal(u64_to_int64(js.black), ts.black.numpy())
    np.testing.assert_array_equal(u64_to_int64(js.white), ts.white.numpy())
    for name in ("to_move", "passed", "done", "winner"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy(), err_msg=name)


def random_positions(batch: int, seed: int, compat: bool = False,
                     plies=None) -> tenv.EnvState:
    """``batch`` positions reached by random play of ``plies`` plies (default
    0..60 at random; 60 plies always finish a game), made with the port's
    env and numpy's generator."""
    rng = np.random.default_rng(seed)
    if plies is None:
        plies = rng.integers(0, 61, size=batch)
    plies = np.asarray(plies)
    s = tenv.initial_state((batch,))
    for t in range(60):
        mask = tenv.legal_action_mask(s, compat=compat).numpy()
        act = np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                        for m in mask])
        s_next, _ = tenv.step(s, torch.from_numpy(act), compat=compat)
        s = tenv.where_state(torch.from_numpy(t < plies), s_next, s)
    return s


@functools.lru_cache(maxsize=None)
def _flax_variables(seed: int, blocks: int, filters: int, bn: bool):
    """Random Flax ``{'params', 'batch_stats'}`` for the JAX net, BN
    statistics included, drawn with numpy in the net's own tree layout (no
    Flax init to compile; a wrong layout makes ``apply`` raise)."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}

    def dense(shape, fan_in):
        return jnp.asarray(rng.normal(0, fan_in ** -0.5, shape), jnp.float32)

    def conv(k, cin, cout):
        p = {"kernel": dense((k, k, cin, cout), k * k * cin)}
        if not bn:
            p["bias"] = dense((cout,), 10.0)
        return p

    def norm(c):
        return ({"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
                 "bias": dense((c,), 10.0)},
                {"mean": jnp.asarray(rng.normal(0, 0.3, c), jnp.float32),
                 "var": jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)})

    def conv_bn(path, conv_name, bn_name, k, cin, cout):
        pscope, sscope = params, stats
        for key in path:
            pscope = pscope.setdefault(key, {})
            if bn:
                sscope = sscope.setdefault(key, {})
        pscope[conv_name] = conv(k, cin, cout)
        if bn:
            pscope[bn_name], sscope[bn_name] = norm(cout)

    f, hidden = filters, 16
    conv_bn((), "stem_conv", "stem_bn", 3, 3, f)
    for i in range(blocks):
        for j in (1, 2):
            conv_bn((f"res{i}",), f"conv{j}", f"bn{j}", 3, f, f)
    conv_bn((), "policy_conv", "policy_bn", 1, f, 2)
    conv_bn((), "value_conv", "value_bn", 1, f, 1)
    for name, cin, cout in (("policy_fc", 2 * 64, 65),
                            ("value_fc1", 64, hidden),
                            ("value_fc2", hidden, 1)):
        params[name] = {"kernel": dense((cin, cout), cin),
                        "bias": dense((cout,), 10.0)}
    return {"params": params, "batch_stats": stats}


def make_nets(seed: int, blocks: int, filters: int, dtype: str = "float32",
              bn: bool = True):
    """A JAX net with random weights and BN statistics, and the port's net
    carrying the same weights. Returns (jnet, variables, tnet, cfg)."""
    from alphazero_reversi_tpu.config import ModelConfig as JModelConfig
    from alphazero_reversi_tpu_torch.config import ModelConfig

    kw = dict(num_res_blocks=blocks, num_filters=filters,
              value_head_hidden_size=16, compute_dtype=dtype,
              use_batch_norm=bn)
    jnet = jresnet.build_network(JModelConfig(**kw))
    variables = _flax_variables(seed, blocks, filters, bn)
    cfg = ModelConfig(**kw)
    tnet = tresnet.build_network(cfg)
    tnet.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables), cfg))
    return jnet, variables, tnet, cfg
