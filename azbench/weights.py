"""The net's weights, made on the device from the seed.

One ``torch.Generator`` on the device and one normal draw for every value,
split into the tensors; float32, the type the net keeps its parameters in.
Convolutions and dense layers get He-scaled normals, BatchNorm scales 1 +
0.1 N, biases and running means 0.1 N, running variances 1 + 0.1 |N|. The
same dict goes to the program (``load_state_dict``) and to the reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def shapes(model: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every tensor of the net ``model`` (the
    config's ``model`` group) describes."""
    f, blocks = model["num_filters"], model["num_res_blocks"]
    pc, vc = model["policy_head_channels"], model["value_head_channels"]
    hidden, n = model["value_head_hidden_size"], model["board_size"]
    out: List[Tuple[str, tuple, str]] = []

    def conv(name, cout, cin, k):
        out.append((name + ".weight", (cout, cin, k, k), "he"))

    def bn(name, c):
        out.extend([(name + ".weight", (c,), "scale"),
                    (name + ".bias", (c,), "small"),
                    (name + ".running_mean", (c,), "small"),
                    (name + ".running_var", (c,), "var")])

    def dense(name, cout, cin):
        out.extend([(name + ".weight", (cout, cin), "he"),
                    (name + ".bias", (cout,), "small")])

    conv("stem_conv", f, 3, 3)
    bn("stem_bn", f)
    for i in range(blocks):
        conv(f"res.{i}.conv1", f, f, 3)
        bn(f"res.{i}.bn1", f)
        conv(f"res.{i}.conv2", f, f, 3)
        bn(f"res.{i}.bn2", f)
    conv("policy_conv", pc, f, 1)
    bn("policy_bn", pc)
    dense("policy_fc", n * n + 1, pc * n * n)
    conv("value_conv", vc, f, 1)
    bn("value_bn", vc)
    dense("value_fc1", hidden, vc * n * n)
    dense("value_fc2", 1, hidden)
    return out


def make(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of the net from ``seed``, on ``device``."""
    spec = shapes(model)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, kind), part in zip(spec, flat.split(sizes)):
        x = part.view(shape)
        if kind == "he":
            fan_in = int(torch.Size(shape[1:]).numel())
            x = x * (2.0 / fan_in) ** 0.5
        elif kind == "scale":
            x = 1.0 + 0.1 * x
        elif kind == "small":
            x = 0.1 * x
        else:
            x = 1.0 + 0.1 * x.abs()
        out[name] = x.contiguous()
    return out
