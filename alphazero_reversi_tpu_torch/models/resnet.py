"""AlphaZero ResNet policy/value network as a ``torch.nn.Module``.

Port of ``alphazero_reversi_tpu/models/resnet.py`` (Flax). Same layers, same
parameter names, same numerics where it matters:

* the public input is NHWC ``[B, 8, 8, 3]``, as in the JAX package; the trunk
  runs NCHW (a permuted view, so cuDNN sees channels-last memory);
* the trunk computes in ``ModelConfig.compute_dtype`` (bf16 by default) with
  float32 parameters cast at use, and the heads' dense layers in float32;
* BatchNorm is evaluated as Flax does: in float32, ``(x - mean) *
  (rsqrt(var + eps) * scale) + bias``, eps 1e-5, then cast to the compute
  dtype. Only inference is ported here (running averages);
* the head activations are flattened in NHWC order, so the Flax Dense
  kernels carry over by transposition alone (``models.weights``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

BN_EPS = 1e-5

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _BatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm with the Flax evaluation order (float32)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        shape = (1, -1, 1, 1)
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


class _Conv(nn.Conv2d):
    """Conv whose float32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias,
                        padding=self.padding)


def _conv(cin: int, cout: int, k: int, bias: bool) -> _Conv:
    # Flax "SAME" for a 3x3 kernel is padding 1
    return _Conv(cin, cout, k, padding=k // 2, bias=bias)


class ResBlock(nn.Module):
    def __init__(self, filters: int, use_batch_norm: bool):
        super().__init__()
        self.conv1 = _conv(filters, filters, 3, not use_batch_norm)
        self.conv2 = _conv(filters, filters, 3, not use_batch_norm)
        if use_batch_norm:
            self.bn1 = _BatchNorm(filters)
            self.bn2 = _BatchNorm(filters)
        else:
            self.bn1 = self.bn2 = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + x)


class AlphaZeroNet(nn.Module):
    """Policy/value net: NHWC planes -> (logits [B, 65] f32, value [B] f32)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        bn = cfg.use_batch_norm
        f, board = cfg.num_filters, cfg.board_size
        pc, vc = cfg.policy_head_channels, cfg.value_head_channels

        def norm(c):
            return _BatchNorm(c) if bn else nn.Identity()

        self.stem_conv = _conv(3, f, 3, not bn)
        self.stem_bn = norm(f)
        self.res = nn.ModuleList(ResBlock(f, bn)
                                 for _ in range(cfg.num_res_blocks))
        self.dropout = nn.Dropout(cfg.dropout)
        self.policy_conv = _conv(f, pc, 1, not bn)
        self.policy_bn = norm(pc)
        self.policy_fc = nn.Linear(pc * board * board, board * board + 1)
        self.value_conv = _conv(f, vc, 1, not bn)
        self.value_bn = norm(vc)
        self.value_fc1 = nn.Linear(vc * board * board,
                                   cfg.value_head_hidden_size)
        self.value_fc2 = nn.Linear(cfg.value_head_hidden_size, 1)

    @staticmethod
    def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()

    def forward(self, planes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = planes.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        for block in self.res:
            x = block(x)
        x = self.dropout(x)
        p = F.relu(self.policy_bn(self.policy_conv(x)))
        logits = self.policy_fc(self._flatten_nhwc(p))
        v = F.relu(self.value_bn(self.value_conv(x)))
        v = F.relu(self.value_fc1(self._flatten_nhwc(v)))
        v = torch.tanh(self.value_fc2(v))
        return logits, v.squeeze(-1)


def build_network(cfg: ModelConfig) -> AlphaZeroNet:
    """The net for ``cfg``, in eval mode (this slice ports inference only)."""
    return AlphaZeroNet(cfg).eval()


@torch.no_grad()
def apply_eval(net: AlphaZeroNet, planes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference forward pass: planes [B,8,8,3] -> (logits [B,65], value [B])
    with BatchNorm on running averages."""
    if net.training:
        raise ValueError("apply_eval needs the net in eval mode (net.eval())")
    return net(planes)


def masked_policy(logits: torch.Tensor, legal_mask: torch.Tensor
                  ) -> torch.Tensor:
    """Softmax over legal actions only; illegal actions get probability 0,
    and rows with no legal action (terminal states) fall back to uniform."""
    neg = torch.finfo(logits.dtype).min
    probs = torch.softmax(torch.where(legal_mask, logits, neg), -1)
    any_legal = legal_mask.any(-1, keepdim=True)
    return torch.where(any_legal, probs, 1.0 / probs.shape[-1])
