"""Checkpoint interop with the reference's PyTorch models.

Port of ``alphazero_reversi_tpu/interop.py``. The reference trains an
architecturally identical net and saves a raw ``state_dict`` or a
``{'model_state_dict': ...}`` wrapper, sometimes with duplicated
``_script_module.``-prefixed keys from TorchScript. Both sides are torch
here, so importing is a key remap:

* ``conv``/``bn`` -> ``stem_conv``/``stem_bn``; ``res_blocks.{i}`` ->
  ``res.{i}``; the head layers keep their names. Conv weights are OIHW on
  both sides.
* The head FCs' input columns are permuted: the reference flattens NCHW
  activations (index ``c*H*W + h*W + w``), this net flattens NHWC
  (``h*W*C + w*C + c``; ``models.resnet.AlphaZeroNet._flatten_nhwc``). The
  value head flattens one channel, where both orders coincide.

The reference form has BatchNorm layers only: a BN-free net
(``use_batch_norm=False``) has no reference form, and both directions raise
on it.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import checkpoint as ckpt_lib
from .config import ModelConfig

_ARCH_FIELDS = ("num_res_blocks", "num_filters", "value_head_hidden_size",
                "policy_head_channels", "value_head_channels", "board_size")
_BN_BUFFERS = ("weight", "bias", "running_mean", "running_var")


def _numpy_scalar_globals() -> List[Any]:
    """What unpickling a numpy scalar needs: numpy's scalar constructor
    (under both its numpy 1 and numpy 2 module names) and the numeric dtype
    classes. A reference full-state checkpoint holds such scalars in
    ``best_elo`` and ``metrics``."""
    scalar = np.float64(0).__reduce__()[0]
    named = [(scalar, f"numpy.{core}.multiarray.scalar")
             for core in ("core", "_core")]
    kinds = (np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8,
             np.uint16, np.uint32, np.uint64, np.float16, np.float32,
             np.float64)
    return [scalar, *named, np.dtype, *(type(np.dtype(k)) for k in kinds)]


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` as ``{key: tensor}``: a raw ``state_dict`` or
    the ``{'model_state_dict': ...}`` wrapper (the reference's full-state
    checkpoint, whose other entries are dropped); ``_script_module.`` keys
    are kept only where the plain key is absent. Loads with
    ``weights_only=True``, allowing numpy scalars besides tensors and plain
    containers: a file that needs any other unpickling raises."""
    try:
        with torch.serialization.safe_globals(_numpy_scalar_globals()):
            obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: not a tensors-only checkpoint (a raw state_dict or "
            f"a {{'model_state_dict': ...}} wrapper): {e}") from None
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    out: Dict[str, torch.Tensor] = {}
    deferred: Dict[str, torch.Tensor] = {}
    for k, v in obj.items():
        if not isinstance(v, torch.Tensor):
            continue
        if k.startswith("_script_module."):
            deferred[k[len("_script_module."):]] = v
        else:
            out[k] = v
    for k, v in deferred.items():
        out.setdefault(k, v)
    return out


def _flatten_perm(channels: int, board: int) -> np.ndarray:
    """``perm[j_nhwc] = j_nchw`` for the head FCs' input flatten orders."""
    j = np.arange(channels * board * board)
    h, rem = j // (board * channels), j % (board * channels)
    w, c = rem // channels, rem % channels
    return c * board * board + h * board + w


def _infer_config(sd: Dict[str, Any]) -> ModelConfig:
    """The architecture of a reference state dict, from its shapes."""
    num_filters = sd["conv.weight"].shape[0]
    blocks = {int(k.split(".")[1]) for k in sd if k.startswith("res_blocks.")}
    value_channels = sd["value_conv.weight"].shape[0]
    board2 = sd["value_fc1.weight"].shape[1] // value_channels
    board = int(round(board2 ** 0.5))
    if board * board != board2:
        raise ValueError(
            f"cannot infer board size: value_fc1 in={board2 * value_channels}"
            f" with {value_channels} value channels")
    return ModelConfig(
        num_res_blocks=(max(blocks) + 1) if blocks else 0,
        num_filters=num_filters,
        value_head_hidden_size=sd["value_fc1.weight"].shape[0],
        policy_head_channels=sd["policy_conv.weight"].shape[0],
        value_head_channels=value_channels,
        board_size=board,
    )


def _layer_map(cfg: ModelConfig):
    """(reference prefix, port prefix, kind) for every layer."""
    out = [("conv", "stem_conv", "conv"), ("bn", "stem_bn", "bn")]
    for i in range(cfg.num_res_blocks):
        for j in (1, 2):
            out.append((f"res_blocks.{i}.conv{j}", f"res.{i}.conv{j}",
                        "conv"))
            out.append((f"res_blocks.{i}.bn{j}", f"res.{i}.bn{j}", "bn"))
    for head in ("policy", "value"):
        out.append((f"{head}_conv", f"{head}_conv", "conv"))
        out.append((f"{head}_bn", f"{head}_bn", "bn"))
    out += [("policy_fc", "policy_fc", "fc"), ("value_fc1", "value_fc1", "fc"),
            ("value_fc2", "value_fc2", "fc")]
    return out


def _fc_perm(name: str, cfg: ModelConfig) -> Optional[np.ndarray]:
    if name == "policy_fc":
        return _flatten_perm(cfg.policy_head_channels, cfg.board_size)
    if name == "value_fc1":
        return _flatten_perm(cfg.value_head_channels, cfg.board_size)
    return None


def _require_bn(cfg: ModelConfig) -> None:
    if not cfg.use_batch_norm:
        raise ValueError("a BN-free net (use_batch_norm=False) has no "
                         "reference checkpoint form")


def import_torch_checkpoint(path_or_state: Any,
                            cfg: Optional[ModelConfig] = None
                            ) -> Tuple[Dict[str, torch.Tensor], ModelConfig]:
    """Reference checkpoint (a ``.pth`` path or a loaded state dict) ->
    ``(state_dict, model_config)`` for ``models.resnet.AlphaZeroNet``. The
    config is inferred from the weights, or ``cfg``, whose architecture
    must agree (its ``compute_dtype`` and ``dropout`` are kept)."""
    sd = (load_reference_state_dict(path_or_state)
          if isinstance(path_or_state, str) else dict(path_or_state))
    inferred = _infer_config(sd)
    if cfg is not None:
        _require_bn(cfg)
        for f in _ARCH_FIELDS:
            if getattr(cfg, f) != getattr(inferred, f):
                raise ValueError(
                    f"checkpoint architecture mismatch on {f}: config="
                    f"{getattr(cfg, f)} checkpoint={getattr(inferred, f)}")
        inferred = cfg
    f32 = lambda t: torch.as_tensor(t).detach().to(torch.float32)  # noqa
    out: Dict[str, torch.Tensor] = {}
    for ref, port, kind in _layer_map(inferred):
        if kind == "bn":
            for b in _BN_BUFFERS:
                out[f"{port}.{b}"] = f32(sd[f"{ref}.{b}"]).clone()
            out[f"{port}.num_batches_tracked"] = torch.tensor(0)
        elif kind == "conv":
            out[f"{port}.weight"] = f32(sd[f"{ref}.weight"]).clone()
        else:
            w = f32(sd[f"{ref}.weight"])
            perm = _fc_perm(ref, inferred)
            if perm is not None:
                w = w[:, torch.from_numpy(perm)]
            out[f"{port}.weight"] = w.contiguous().clone()
            out[f"{port}.bias"] = f32(sd[f"{ref}.bias"]).clone()
    return out, inferred


def export_torch_checkpoint(state_dict: Dict[str, torch.Tensor], path: str,
                            cfg: ModelConfig) -> None:
    """The port net's ``state_dict`` -> a reference-loadable raw
    ``state_dict`` ``.pth`` (the reference's ``best_model.pth`` form)."""
    _require_bn(cfg)
    f32 = lambda t: t.detach().cpu().to(torch.float32)  # noqa: E731
    sd: Dict[str, torch.Tensor] = {}
    for ref, port, kind in _layer_map(cfg):
        if kind == "bn":
            for b in _BN_BUFFERS:
                sd[f"{ref}.{b}"] = f32(state_dict[f"{port}.{b}"]).clone()
            sd[f"{ref}.num_batches_tracked"] = torch.tensor(0)
        elif kind == "conv":
            sd[f"{ref}.weight"] = f32(state_dict[f"{port}.weight"]).clone()
        else:
            w = f32(state_dict[f"{port}.weight"])
            perm = _fc_perm(ref, cfg)
            if perm is not None:
                w = w[:, torch.from_numpy(np.argsort(perm))]
            sd[f"{ref}.weight"] = w.contiguous().clone()
            sd[f"{ref}.bias"] = f32(state_dict[f"{port}.bias"]).clone()
    torch.save(sd, path)


def import_checkpoint(pth_path: str, ckpt_dir: str,
                      cfg: Optional[ModelConfig] = None) -> ModelConfig:
    """Reference ``.pth`` -> the port's best model under ``ckpt_dir``
    (``checkpoint.save_best``: what ``analyze -d``, ``play -d`` and
    ``tournament`` load, and what a pipeline writing checkpoints there
    takes as the gate's best). Returns the model config."""
    weights, inferred = import_torch_checkpoint(pth_path, cfg)
    ckpt_lib.save_best(ckpt_dir, weights)
    return inferred
