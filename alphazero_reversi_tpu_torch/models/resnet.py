"""AlphaZero ResNet policy/value network as a ``torch.nn.Module``.

Port of ``alphazero_reversi_tpu/models/resnet.py`` (Flax). Same layers, same
parameter names, same numerics where it matters:

* the public input is NHWC ``[B, 8, 8, 3]``, as in the JAX package; the trunk
  runs NCHW (a permuted view, so cuDNN sees channels-last memory);
* the trunk computes in ``ModelConfig.compute_dtype`` (bf16 by default) with
  float32 parameters cast at use, and the heads' dense layers in float32;
* BatchNorm is evaluated as Flax does: in float32, ``(x - mean) *
  (rsqrt(var + eps) * scale) + bias``, eps 1e-5, then cast to the compute
  dtype. In eval mode it uses the running averages; in train mode
  (``apply_train``) it does what ``nn.BatchNorm(use_running_average=False)``
  does, which ``torch.nn.BatchNorm2d`` does not: float32 batch statistics
  over N, H, W with the fast variance ``mean(x^2) - mean(x)^2`` clipped at
  0, normalisation by that biased variance, and running averages updated
  with momentum 0.99 (``ra = 0.99 ra + 0.01 batch``, biased variance);
* each BatchNorm site (the BN, its ReLU and in a residual block's second
  site the residual add) goes through ``cuda_bn.bn_act``: one launch of a
  hand-written CUDA kernel in an eval forward on the card, the eager
  composition in train mode and on the CPU, with the same bits either way;
* dropout draws its mask from an explicit ``torch.Generator``, as Flax's
  ``nn.Dropout`` keeps ``x / (1 - rate)`` where a Bernoulli draw says so;
* the head activations are flattened in NHWC order, so the Flax Dense
  kernels carry over by transposition alone (``models.weights``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from .cuda_bn import bn_act

BN_EPS = 1e-5
BN_MOMENTUM = 0.99  # Flax's convention: weight of the old running average

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _BatchNorm(nn.BatchNorm2d):
    """BatchNorm with Flax's numerics (float32). Eval mode normalises with
    the running averages; train mode with the batch's statistics, and it
    updates the running averages in place (module docstring)."""

    # ``cuda_bn.bn_act``'s kernel copies this class's eval arithmetic step
    # by step, so its eval forward on the card takes the kernel
    BN_ACT_KERNEL = True

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                for run, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                    run.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * batch)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
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
        y = bn_act(self.conv1(x), self.bn1)
        return bn_act(self.conv2(y), self.bn2, residual=x)


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

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator],
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        rate = self.cfg.dropout
        if not self.training or rate <= 0.0:
            return x
        if rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - rate
        if rows is None:
            mask = torch.rand(x.shape, generator=generator, device=x.device)
        else:  # this batch's rows of a draw at the global batch's shape
            first, total = rows
            mask = torch.rand((total, *x.shape[1:]), generator=generator,
                              device=x.device)[first:first + x.shape[0]]
        return torch.where(mask < keep, x / keep, torch.zeros_like(x))

    def forward(self, planes: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``rows`` ``(first, total)``: ``planes`` are rows ``[first, first
        + B)`` of a batch of ``total``; the dropout mask is drawn at the
        whole batch's shape and these rows kept."""
        x = planes.permute(0, 3, 1, 2).to(self.dtype)
        x = bn_act(self.stem_conv(x), self.stem_bn)
        for block in self.res:
            x = block(x)
        x = self._dropout(x, generator, rows)
        p = bn_act(self.policy_conv(x), self.policy_bn)
        logits = self.policy_fc(self._flatten_nhwc(p))
        v = bn_act(self.value_conv(x), self.value_bn)
        v = F.relu(self.value_fc1(self._flatten_nhwc(v)))
        v = torch.tanh(self.value_fc2(v))
        return logits, v.squeeze(-1)


def build_network(cfg: ModelConfig) -> AlphaZeroNet:
    """The net for ``cfg``, in eval mode (``net.train()`` for
    ``apply_train``)."""
    return AlphaZeroNet(cfg).eval()


@torch.no_grad()
def apply_eval(net: AlphaZeroNet, planes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference forward pass: planes [B,8,8,3] -> (logits [B,65], value [B])
    with BatchNorm on running averages."""
    if net.training:
        raise ValueError("apply_eval needs the net in eval mode (net.eval())")
    return net(planes)


def apply_train(net: AlphaZeroNet, planes: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                           Dict[str, torch.Tensor]]:
    """Training forward pass (the net in train mode): BatchNorm on batch
    statistics, dropout drawn from ``generator`` (``rows`` as in
    ``AlphaZeroNet.forward``). Returns ``((logits, value), batch_stats)``:
    ``batch_stats`` maps each BatchNorm buffer name
    (``<layer>.running_mean`` / ``.running_var``) to the net's running
    average, updated in place by this pass (empty for a BN-free net)."""
    if not net.training:
        raise ValueError("apply_train needs the net in train mode "
                         "(net.train())")
    return net(planes, generator=generator, rows=rows), batch_stats(net)


def batch_stats(net: AlphaZeroNet) -> Dict[str, torch.Tensor]:
    """Each BatchNorm buffer name (``<layer>.running_mean`` /
    ``.running_var``) -> the net's running average (empty for a BN-free
    net)."""
    return {name: buf for name, buf in net.named_buffers()
            if name.endswith((".running_mean", ".running_var"))}


def masked_policy(logits: torch.Tensor, legal_mask: torch.Tensor
                  ) -> torch.Tensor:
    """Softmax over legal actions only; illegal actions get probability 0,
    and rows with no legal action (terminal states) fall back to uniform."""
    neg = torch.finfo(logits.dtype).min
    probs = torch.softmax(torch.where(legal_mask, logits, neg), -1)
    any_legal = legal_mask.any(-1, keepdim=True)
    return torch.where(any_legal, probs, 1.0 / probs.shape[-1])
