"""Plain PyTorch forward pass of the AlphaZero ResNet, in float32.

The benchmark's reference net: NHWC planes ``[B, 8, 8, 3]`` -> (policy
logits ``[B, 65]``, value ``[B]``), from a dict of float32 tensors named as
the weights the benchmark makes (``azbench/weights.py``). A stem 3x3 conv,
``blocks`` residual blocks of two 3x3 convs, a 1x1 policy conv and a dense
layer, a 1x1 value conv and two dense layers with ``tanh``; BatchNorm after
each conv: ``(x - mean) * rsqrt(var + 1e-5) * scale + bias``, on the running
averages (eval) or on the batch's statistics (train, variance ``E[x^2] -
E[x]^2`` clipped at 0, running averages moved by 1% towards the batch's).
Head activations are flattened in (row, column, channel) order.

``quant="fp8"`` rounds to float8 e4m3, one scale per tensor, every tensor
that the program's trunk holds in bfloat16 (the input, each conv's weight
and output, each BatchNorm's output, each residual sum, up to the heads'
dense layers), and in a backward pass each of their gradients: the control,
a trunk one precision below the configuration's bfloat16. ``quant="bf16"``
rounds the same tensors to bfloat16: what the configuration's own precision
costs, the yardstick that a check divides the program's error by. TF32 is switched off while a
reference runs (``exact_matmul``). Nothing here imports the program.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_matmul():
    """float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, as float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8(torch.autograd.Function):
    """Rounds to float8 on the way forward and the gradient on the way
    back: a tensor that a float8 trunk would hold, in both passes."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad)


class _Bf16(torch.autograd.Function):
    """The same at bfloat16: the configuration's own trunk precision, whose
    error against the float32 reference is the yardstick of a check."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).float()


ROUND = {None: lambda x: x, "fp8": _Fp8.apply, "bf16": _Bf16.apply}


def _conv(x, w, q):
    return q(F.conv2d(x, q(w), padding=w.shape[-1] // 2))


def _bn(x, p, name, train, stats):
    if train:
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        stats.append((name, mean.detach(), var.detach()))
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    mul = torch.rsqrt(var + EPS) * p[name + ".weight"]
    shape = (1, -1, 1, 1)
    return (x - mean.view(shape)) * mul.view(shape) \
        + p[name + ".bias"].view(shape)


def _flat(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def forward(p: Dict[str, torch.Tensor], planes: torch.Tensor, blocks: int,
            train: bool = False, quant: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor,
                       List[Tuple[str, torch.Tensor, torch.Tensor]]]:
    """``(logits, value, batch_stats)``; ``batch_stats`` lists each
    BatchNorm's ``(name, mean, var)`` of this batch in train mode."""
    stats: list = []
    q = ROUND[quant]
    x = q(planes.float().permute(0, 3, 1, 2))
    x = F.relu(q(_bn(_conv(x, p["stem_conv.weight"], q), p, "stem_bn",
                     train, stats)))
    for i in range(blocks):
        pre = f"res.{i}."
        y = F.relu(q(_bn(_conv(x, p[pre + "conv1.weight"], q), p,
                         pre + "bn1", train, stats)))
        y = q(_bn(_conv(y, p[pre + "conv2.weight"], q), p, pre + "bn2",
                  train, stats))
        x = F.relu(q(y + x))
    pol = F.relu(q(_bn(_conv(x, p["policy_conv.weight"], q), p,
                       "policy_bn", train, stats)))
    logits = F.linear(_flat(pol), p["policy_fc.weight"], p["policy_fc.bias"])
    v = F.relu(q(_bn(_conv(x, p["value_conv.weight"], q), p, "value_bn",
                     train, stats)))
    v = F.relu(F.linear(_flat(v), p["value_fc1.weight"],
                        p["value_fc1.bias"]))
    v = torch.tanh(F.linear(v, p["value_fc2.weight"], p["value_fc2.bias"]))
    return logits, v.squeeze(-1), stats


def logit_sq(logits: torch.Tensor, ref: torch.Tensor, legal: torch.Tensor):
    """Per row, the squared error of the logits over the legal actions
    after removing each row's mean (softmax ignores it)."""
    n = legal.sum(-1).clamp_min(1)

    def centred(z):
        z = torch.where(legal, z.double(), 0.0)
        return torch.where(legal, z - z.sum(-1, keepdim=True) / n[:, None],
                           0.0)
    a, b = centred(logits), centred(ref)
    return (a - b).pow(2).sum(-1)
