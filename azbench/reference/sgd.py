"""Plain SGD steps of the AlphaZero net in float32: the reference that the
learner's first steps are held against.

A step's forward in train mode normalises by the batch's statistics; the
loss is the mean over its rows of the soft cross-entropy against the policy
target plus the squared value error; the BatchNorm running averages move 1%
towards the batch's statistics. The global gradient norm clips the gradient
to ``max_norm`` (``g * max / |g|`` above it), and AdamW (decay ``lr * wd *
p`` first, bias-corrected moments, ``eps`` outside the square root) updates
every parameter.

``fault="half_batch"`` takes the loss over the first half of each batch
only. Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from . import net as ref_net

B1, B2, EPS = 0.9, 0.999, 1e-8


def is_buffer(name: str) -> bool:
    return name.endswith((".running_mean", ".running_var"))


def run(params0: Dict[str, torch.Tensor], batches: List[tuple], *,
        model: dict, lr: float, weight_decay: float,
        max_norm: float, quant: Optional[str] = None,
        fault: Optional[str] = None) -> dict:
    """``len(batches)`` steps from ``params0``. Returns ``first_grad``
    (step 1's clipped gradient by leaf), ``raw_grad`` (step 1's gradient
    before the clip) and ``params`` after the last step (parameters and
    running averages)."""
    names = [k for k in params0 if not is_buffer(k)]
    p = {k: v.detach().clone().float() for k, v in params0.items()}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    out = {}
    with ref_net.exact_matmul():
        for t, (planes, policy, value) in enumerate(batches, 1):
            rows = slice(0, planes.shape[0] // 2 if fault == "half_batch"
                         else planes.shape[0])
            leaf = {k: p[k].detach().requires_grad_(k in names) for k in p}
            logits, val, stats = ref_net.forward(
                leaf, planes[rows], model["num_res_blocks"], train=True,
                quant=quant)
            logp = F.log_softmax(logits, -1)
            loss = -(policy[rows] * logp).sum(-1).mean() \
                + ((val - value[rows]) ** 2).mean()
            g = torch.autograd.grad(loss, [leaf[k] for k in names])
            grads = dict(zip(names, g))
            for name, mean, var in stats:
                for key, batch in ((".running_mean", mean),
                                   (".running_var", var)):
                    p[name + key] = 0.99 * p[name + key] + 0.01 * batch
            norm = torch.sqrt(sum((g.double() ** 2).sum()
                                  for g in grads.values()))
            if t == 1:
                out["raw_grad"] = {k: g.clone() for k, g in grads.items()}
            if float(norm) >= max_norm:
                grads = {k: g / float(norm) * max_norm
                         for k, g in grads.items()}
            if t == 1:
                out["first_grad"] = {k: g.clone() for k, g in grads.items()}
            bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
            for k in names:
                p[k] = p[k] * (1 - lr * weight_decay)
                m[k] = B1 * m[k] + (1 - B1) * grads[k]
                v[k] = B2 * v[k] + (1 - B2) * grads[k] ** 2
                p[k] = p[k] - (lr / bc1) * m[k] / (
                    v[k].sqrt() / bc2 ** 0.5 + EPS)
    out["params"] = p
    return out


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys) -> torch.Tensor:
    """Per leaf, the gap of norms ``| |prog| - |ref| |`` over the larger of
    the leaf's reference norm and the median leaf's."""
    keys = list(keys)
    ref_n = torch.tensor([float(ref[k].double().norm()) for k in keys])
    prog_n = torch.tensor([float(prog[k].double().norm()) for k in keys])
    return (prog_n - ref_n).abs() / torch.maximum(ref_n, ref_n.median())


def error(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
          ) -> float:
    """``|prog - ref| / |ref|`` over all the leaves together."""
    num = sum(float((prog[k].double() - ref[k].double()).pow(2).sum())
              for k in ref)
    den = sum(float(ref[k].double().pow(2).sum()) for k in ref)
    return (num / max(den, 1e-300)) ** 0.5
