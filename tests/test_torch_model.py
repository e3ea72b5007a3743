"""Parity of the port's ResNet and weight carry
(``alphazero_reversi_tpu_torch.models``) with the JAX package's Flax net."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_reversi_tpu.models import resnet as jresnet
from alphazero_reversi_tpu_torch.env import bitboard as tenv
from alphazero_reversi_tpu_torch.models import resnet as tresnet
from torch_parity import make_nets, random_positions

# f32: both frameworks sum the same products in different orders (~1e-6);
# bf16: the two round activations to bf16 at different points, and one bf16
# ulp at |x| ~ 1 is 8e-3.
ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _planes(batch: int, seed: int) -> np.ndarray:
    s = random_positions(batch, seed)
    return tenv.canonical_planes(s).numpy()


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "nobn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks,filters", [(1, 8), (2, 16)])
def test_apply_eval_matches_flax(bn, dtype, blocks, filters):
    """Random weights AND random BN statistics carried by
    ``state_dict_from_flax``: logits and value match JAX ``apply_eval``."""
    jnet, variables, tnet, _ = make_nets(blocks, blocks, filters, dtype,
                                         bn)
    planes = _planes(12, blocks)
    jl, jv = jresnet.apply_eval(jnet, variables, jnp.asarray(planes))
    tl, tv = tresnet.apply_eval(tnet, torch.from_numpy(planes))
    assert tl.dtype == tv.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL[dtype])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL[dtype])


def test_state_dict_covers_every_parameter():
    """The carry fills every entry of the port's state_dict (BN and BN-free),
    and with the right shapes (``make_nets`` loads it strictly)."""
    from alphazero_reversi_tpu_torch.models.weights import \
        state_dict_from_flax
    for bn in (True, False):
        _, variables, tnet, cfg = make_nets(1, 1, 8, bn=bn)
        sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                         variables), cfg)
        assert set(sd) == set(tnet.state_dict())


def test_apply_eval_refuses_train_mode():
    net = tresnet.build_network(tresnet.ModelConfig(num_res_blocks=0,
                                                    num_filters=4))
    net.train()
    with pytest.raises(ValueError):
        tresnet.apply_eval(net, torch.zeros(1, 8, 8, 3))


@pytest.mark.parametrize("seed", range(3))
def test_masked_policy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (6, 65)).astype(np.float32)
    legal = rng.random((6, 65)) < 0.3
    legal[0] = False  # all-illegal row: uniform fallback
    legal[1] = True
    want = np.asarray(jresnet.masked_policy(jnp.asarray(logits),
                                            jnp.asarray(legal)))
    got = tresnet.masked_policy(torch.from_numpy(logits),
                                torch.from_numpy(legal)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[0], np.full(65, 1 / 65, np.float32))
    assert (got[2:][~legal[2:]] == 0).all()


def _old_eval_forward(net, planes):
    """The eval forward as the net wrote it before its BatchNorm sites went
    through ``cuda_bn.bn_act``: float32 BN on the running averages, then
    ReLU, and the residual add between them in a block's second site."""
    import torch.nn.functional as F

    def bn(m, x):
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(m.running_var + m.eps) * m.weight
        y = (x.float() - m.running_mean.view(shape)) * mul.view(shape)
        return (y + m.bias.view(shape)).to(x.dtype)

    x = planes.permute(0, 3, 1, 2).to(net.dtype)
    x = F.relu(bn(net.stem_bn, net.stem_conv(x)))
    for block in net.res:
        y = F.relu(bn(block.bn1, block.conv1(x)))
        x = F.relu(bn(block.bn2, block.conv2(y)) + x)
    p = F.relu(bn(net.policy_bn, net.policy_conv(x)))
    logits = net.policy_fc(net._flatten_nhwc(p))
    v = F.relu(bn(net.value_bn, net.value_conv(x)))
    v = F.relu(net.value_fc1(net._flatten_nhwc(v)))
    return logits, torch.tanh(net.value_fc2(v)).squeeze(-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_keeps_the_old_composition(dtype):
    """On the CPU the BatchNorm sites run the eager composition: the eval
    forward gives the old forward's bits, and no kernel is launched."""
    from alphazero_reversi_tpu_torch.models import cuda_bn

    torch.manual_seed(3)
    net = tresnet.build_network(tresnet.ModelConfig(
        num_res_blocks=2, num_filters=8, value_head_hidden_size=16,
        compute_dtype=dtype))
    for name, buf in net.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn_like(buf))
        elif name.endswith("running_var"):
            buf.copy_(torch.rand_like(buf) + 0.1)
    for name, p in net.named_parameters():
        if "bn" in name:
            p.data.copy_(torch.randn_like(p))
    planes = torch.from_numpy(_planes(6, 4))
    before = cuda_bn.LAUNCHES
    got = tresnet.apply_eval(net, planes)
    with torch.no_grad():
        want = _old_eval_forward(net, planes)
    assert cuda_bn.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
