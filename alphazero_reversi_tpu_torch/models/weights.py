"""Weight carry from the JAX package's Flax variables to the port's net.

``state_dict_from_flax`` takes the ``{'params', 'batch_stats'}`` tree of
``alphazero_reversi_tpu.models.resnet`` as nested dicts of numpy arrays (the
caller converts with ``np.asarray``; nothing here imports JAX) and returns a
``state_dict`` for ``models.resnet.AlphaZeroNet``:

* conv kernels HWIO -> OIHW;
* BatchNorm ``scale``/``bias`` and ``mean``/``var`` -> ``weight``/``bias`` and
  ``running_mean``/``running_var``;
* Dense kernels ``[in, out]`` -> ``[out, in]`` (both nets flatten the heads in
  NHWC order, so no row permutation is needed).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _layer_names(cfg: ModelConfig):
    """(flax path, torch prefix, kind) for every parameterised layer."""
    out = [(("stem_conv",), "stem_conv", "conv"),
           (("stem_bn",), "stem_bn", "bn")]
    for i in range(cfg.num_res_blocks):
        for j in (1, 2):
            out.append(((f"res{i}", f"conv{j}"), f"res.{i}.conv{j}", "conv"))
            out.append(((f"res{i}", f"bn{j}"), f"res.{i}.bn{j}", "bn"))
    for head in ("policy", "value"):
        out.append(((f"{head}_conv",), f"{head}_conv", "conv"))
        out.append(((f"{head}_bn",), f"{head}_bn", "bn"))
    out += [(("policy_fc",), "policy_fc", "dense"),
            (("value_fc1",), "value_fc1", "dense"),
            (("value_fc2",), "value_fc2", "dense")]
    return out


def _get(tree: Dict[str, Any], path):
    for key in path:
        tree = tree[key]
    return tree


def state_dict_from_flax(variables: Dict[str, Any], cfg: ModelConfig
                         ) -> Dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` (numpy leaves) -> torch state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for path, name, kind in _layer_names(cfg):
        if kind == "bn":
            if not cfg.use_batch_norm:
                continue
            p, s = _get(params, path), _get(stats, path)
            sd[f"{name}.weight"] = _t(p["scale"])
            sd[f"{name}.bias"] = _t(p["bias"])
            sd[f"{name}.running_mean"] = _t(s["mean"])
            sd[f"{name}.running_var"] = _t(s["var"])
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
            continue
        p = _get(params, path)
        kernel = np.asarray(p["kernel"])
        if kind == "conv":
            sd[f"{name}.weight"] = _t(np.transpose(kernel, (3, 2, 0, 1)))
            if not cfg.use_batch_norm:
                sd[f"{name}.bias"] = _t(p["bias"])
        else:
            sd[f"{name}.weight"] = _t(kernel.T)
            sd[f"{name}.bias"] = _t(p["bias"])
    return sd
