"""Eval-mode BatchNorm, residual add and ReLU in one launch: the CUDA
kernel's wrapper and its plain version.

The kernel is ``csrc/bn_act.cu``; its source note gives the arithmetic and
what bounds it on an H100. It replaces no TPU kernel: the JAX package leaves
BatchNorm to XLA, while the port's eager composition cost 9-11 launches at
each of the net's BatchNorm sites.

``bn_act(x, bn, residual=None)`` is ``relu(bn(x))``, or ``relu(bn(x) +
residual)``, at one BatchNorm site of ``models/resnet.py``. It launches the
kernel when ``x`` is a CUDA tensor in bf16 or float32, ``bn`` is a module
whose class sets ``BN_ACT_KERNEL`` (``resnet._BatchNorm``, whose eval
arithmetic the kernel copies step by step) in eval mode, and autograd is off
(the kernel has no backward). Otherwise it runs the plain version
``bn_act_reference``, the eager composition: train mode (``apply_train``),
every CPU run, a BN-free net (``bn`` an ``nn.Identity``) and any other
BatchNorm (a stock ``nn.BatchNorm2d`` rounds differently) take it. The
kernel keeps every rounding step of the eager path, so on the card both
give the same bits.

A call validates its arguments (dtypes, shapes, strides, devices), then
costs the output's allocation, the ``data_ptr()``s, the current stream and
one ctypes call, with no host sync, so a forward can be captured in a CUDA
graph. ``LAUNCHES`` counts kernel launches: 13 per eval forward of the 5x128
BN net on the card (the stem, two per residual block, the two heads).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/bn_act.cu's


def bn_act_reference(x: torch.Tensor, bn: nn.Module,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``F.relu(bn(x))``, or ``F.relu(bn(x) + residual)``."""
    y = bn(x)
    return F.relu(y if residual is None else y + residual)


def _params(bn: nn.Module) -> tuple:
    return bn.running_mean, bn.running_var, bn.weight, bn.bias


def _channel_divisor(x: torch.Tensor, bn: nn.Module,
                     residual: Optional[torch.Tensor]) -> int:
    """Raise ValueError unless the kernel takes these arguments; return the
    divisor that maps a flat index to its channel (``(i // div) % C``): 1
    for channels-last memory, H*W for NCHW-contiguous."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    c, device = x.shape[1], x.get_device()
    for name, p in zip(("running_mean", "running_var", "weight", "bias"),
                       _params(bn)):
        if p is None or p.dtype != torch.float32 or p.shape != (c,) \
                or p.get_device() != device or not p.is_contiguous():
            raise ValueError(f"BatchNorm {name} must be a contiguous float32 "
                             f"[{c}] on {x.device}")
    if residual is not None and (
            residual.dtype != x.dtype or residual.shape != x.shape
            or residual.stride() != x.stride()
            or residual.get_device() != device):
        raise ValueError("residual must have x's dtype, shape, strides and "
                         "device")
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    if x.is_contiguous():
        return x.shape[2] * x.shape[3]
    raise ValueError(f"x must be channels-last or NCHW-contiguous, got "
                     f"strides {x.stride()}")


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _I64, _I, _I64, _I,
             _I, _P]  # azr_bn_act's C signature in csrc/bn_act.cu


@functools.lru_cache(maxsize=None)
def _entry():
    """The built kernel's C entry point, with its ctypes types."""
    from ..kernels import build

    fn = build.load("bn_act").azr_bn_act
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def bn_act(x: torch.Tensor, bn: nn.Module,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(bn(x) [+ residual])`` for ``x`` [N, C, H, W]: one kernel
    launch for a bf16 or float32 CUDA tensor with ``bn`` a
    ``BN_ACT_KERNEL`` BatchNorm in eval mode and autograd off; the plain
    version otherwise. The output has ``x``'s memory format."""
    global LAUNCHES
    if (not getattr(bn, "BN_ACT_KERNEL", False) or bn.training
            or not x.is_cuda or x.dtype not in _DTYPE_CODES
            or torch.is_grad_enabled()):
        return bn_act_reference(x, bn, residual)
    div = _channel_divisor(x, bn, residual)
    mean, var, weight, bias = _params(bn)
    out = torch.empty_like(x)
    device = x.get_device()
    err = _entry()(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        out.data_ptr(), mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), bn.eps, x.numel(), x.shape[1], div,
        _DTYPE_CODES[x.dtype], _sms(device),
        torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
