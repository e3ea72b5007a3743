"""The learner: optimizer, loss and SGD steps.

Port of ``alphazero_reversi_tpu/learner.py``. The math is the JAX package's
``optax.chain(clip_by_global_norm, inject_hyperparams(adamw))``:

* gradients are clipped by their global norm with optax's rule,
  ``g if |g| < max else (g / |g|) * max`` (``torch.nn.utils.clip_grad_norm_``
  divides by ``|g| + 1e-6`` and differs); the reported ``grad_norm`` is the
  norm before clipping;
* AdamW with b1 0.9, b2 0.999, eps 1e-8 outside the square root, and weight
  decay added to the update and scaled by the lr on every parameter (conv,
  dense, BatchNorm scale and bias): ``torch.optim.AdamW`` with one parameter
  group does this;
* the lr is set per outer iteration from the milestones
  (``lr_at_iteration``), the counterpart of torch's MultiStepLR stepped once
  per self-play iteration.

The loss is soft cross-entropy against the search policy (or CE on its
argmax) plus value MSE, with the config's weights. The learner's net lives
in train mode on the learner's device and holds the parameters and the
BatchNorm running averages; ``Learner.copy_to`` hands both to a self-play
net. ``train_steps`` samples from the replay buffer on the device and keeps
its metrics there: it reads nothing back to the host.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import replay as replay_lib
from . import symmetry
from .config import TrainingConfig
from .mcts.search import resolve_device
from .models import resnet

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class TrainState:
    """Learner state: ``net`` (train mode) holds the parameters and the
    BatchNorm running averages, ``optimizer`` Adam's moments and the lr,
    ``step`` the SGD steps taken."""

    net: resnet.AlphaZeroNet
    optimizer: torch.optim.AdamW
    max_grad_norm: float
    step: int = 0


def lr_at_iteration(cfg: TrainingConfig, iteration: int) -> float:
    """MultiStepLR value at an outer iteration: lr * gamma^(milestones
    passed). Milestones count self-play iterations, not SGD steps."""
    passed = sum(1 for m in cfg.lr_milestones if iteration >= int(m))
    return cfg.learning_rate * (cfg.lr_gamma ** passed)


def make_optimizer(params: Iterable[torch.Tensor], cfg: TrainingConfig
                   ) -> torch.optim.AdamW:
    """AdamW over one parameter group (weight decay on every parameter)."""
    return torch.optim.AdamW(params, lr=cfg.learning_rate,
                             betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
                             weight_decay=cfg.weight_decay)


def set_learning_rate(state: TrainState, lr: float) -> None:
    """Set the lr of the next steps (the ``scheduler.step()`` analog)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr


def current_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def create_train_state(net: resnet.AlphaZeroNet, cfg: TrainingConfig,
                       device=None) -> TrainState:
    """A learner state on ``device`` (default CUDA) starting from a copy of
    ``net``'s weights and running averages, with fresh optimizer state."""
    dev = resolve_device(device)
    tnet = copy.deepcopy(net).to(dev).train()
    return TrainState(net=tnet, optimizer=make_optimizer(tnet.parameters(),
                                                         cfg),
                      max_grad_norm=float(cfg.gradient_clip))


def loss_fn(net: resnet.AlphaZeroNet, planes: torch.Tensor,
            policy_tgt: torch.Tensor, value_tgt: torch.Tensor, *,
            policy_loss: str, policy_weight: float, value_weight: float,
            generator: Optional[torch.Generator] = None,
            augment_symmetries: bool = False,
            syms: Optional[torch.Tensor] = None,
            rows: Optional[Tuple[int, int]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss -> (total, aux). The forward pass is ``apply_train``,
    so it updates the net's BatchNorm running averages. With
    ``augment_symmetries`` the batch first takes a random dihedral
    transform (``syms`` ``[B]`` replaces the draw); the symmetry draw and
    then the dropout mask come from ``generator``. ``rows`` ``(first,
    total)``: the batch is rows ``[first, first + B)`` of a global batch of
    ``total`` (a data-parallel rank's block), and both draws are made at
    the global batch's shape, these rows kept."""
    if augment_symmetries:
        if syms is None and rows is not None:
            first, total = rows
            syms = symmetry.random_syms(generator, total, planes.device)[
                first:first + planes.shape[0]]
        planes, policy_tgt = symmetry.augment(generator, planes, policy_tgt,
                                              syms)
        # value targets are symmetry-invariant
    (logits, value), _ = resnet.apply_train(net, planes, generator, rows)
    logp = F.log_softmax(logits, -1)
    if policy_loss == "soft":
        p_loss = -(policy_tgt * logp).sum(-1).mean()
    elif policy_loss == "argmax":
        hard = policy_tgt.argmax(-1, keepdim=True)
        p_loss = -logp.gather(1, hard).mean()
    else:
        raise ValueError(f"unknown policy_loss {policy_loss!r}")
    v_loss = ((value - value_tgt) ** 2).mean()
    total = policy_weight * p_loss + value_weight * v_loss
    aux = {"loss": total.detach(), "policy_loss": p_loss.detach(),
           "value_loss": v_loss.detach()}
    return total, aux


def _clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place; returns the norm before
    clipping (a device scalar: nothing is read back)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


def train_step(state: TrainState, planes: torch.Tensor,
               policy_tgt: torch.Tensor, value_tgt: torch.Tensor, *,
               generator: Optional[torch.Generator] = None,
               syms: Optional[torch.Tensor] = None,
               policy_loss: str = "soft", policy_weight: float = 1.0,
               value_weight: float = 1.0, augment_symmetries: bool = False,
               rows: Optional[Tuple[int, int]] = None,
               reduce: Optional[Callable] = None
               ) -> Dict[str, torch.Tensor]:
    """One SGD step on ``state`` in place. Returns the aux metrics
    (``loss``, ``policy_loss``, ``value_loss``, ``grad_norm``) as device
    scalars.

    ``rows`` as in ``loss_fn``. ``reduce(grads, net, aux) -> aux``, when
    given, runs between the backward pass and the clip: the data-parallel
    step (``parallel.dp``) averages the gradients, the BatchNorm running
    averages and the aux metrics over the ranks there, so the clip, the
    reported ``grad_norm`` and AdamW see the averaged gradient."""
    params = list(state.net.parameters())
    state.optimizer.zero_grad(set_to_none=True)
    total, aux = loss_fn(state.net, planes, policy_tgt, value_tgt,
                         policy_loss=policy_loss,
                         policy_weight=policy_weight,
                         value_weight=value_weight, generator=generator,
                         augment_symmetries=augment_symmetries, syms=syms,
                         rows=rows)
    total.backward()
    grads = [p.grad for p in params]
    if reduce is not None:
        aux = reduce(grads, state.net, aux)
    aux["grad_norm"] = _clip_by_global_norm(grads, state.max_grad_norm)
    state.optimizer.step()
    state.step += 1
    return aux


def train_steps(state: TrainState, buffer: replay_lib.ReplayBuffer,
                generator: Optional[torch.Generator], *, num_steps: int,
                batch_size: int, policy_loss: str = "soft",
                policy_weight: float = 1.0, value_weight: float = 1.0,
                augment_symmetries: bool = False,
                block: Optional[Tuple[int, int]] = None,
                reduce: Optional[Callable] = None
                ) -> Dict[str, torch.Tensor]:
    """``num_steps`` SGD steps, each on a fresh batch sampled from
    ``buffer`` on its device. Every draw (sample indices, then symmetries,
    then dropout) comes from ``generator`` in that order, so this equals
    ``num_steps`` calls of ``replay.sample`` + ``train_step`` on one
    generator. Returns the step-mean aux metrics as device scalars; nothing
    is read back to the host.

    ``block`` ``(first, per)``: every step trains on rows ``[first, first
    + per)`` of each ``batch_size`` batch, every draw made at the whole
    batch's shape (a data-parallel rank's block, ``parallel.dp``; default
    the whole batch); ``reduce`` as in ``train_step``."""
    first, per = block or (0, batch_size)
    auxs = []
    for _ in range(num_steps):
        idx = replay_lib.sample_indices(buffer, generator, batch_size)
        planes, policy_tgt, value_tgt = replay_lib.gather(
            buffer, idx[first:first + per])
        auxs.append(train_step(
            state, planes, policy_tgt, value_tgt, generator=generator,
            policy_loss=policy_loss, policy_weight=policy_weight,
            value_weight=value_weight,
            augment_symmetries=augment_symmetries,
            rows=(first, batch_size), reduce=reduce))
    return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


class Learner:
    """Binds a net copy and a config to the SGD step, on ``device``
    (default CUDA)."""

    def __init__(self, net: resnet.AlphaZeroNet, cfg: TrainingConfig,
                 device=None):
        self.cfg = cfg
        self.state = create_train_state(net, cfg, device)

    @property
    def net(self) -> resnet.AlphaZeroNet:
        return self.state.net

    def _loss_kwargs(self):
        return dict(policy_loss=self.cfg.policy_loss,
                    policy_weight=self.cfg.policy_loss_weight,
                    value_weight=self.cfg.value_loss_weight,
                    augment_symmetries=self.cfg.augment_symmetries)

    def set_iteration(self, iteration: int) -> None:
        """Apply the MultiStepLR schedule for this outer iteration."""
        set_learning_rate(self.state, lr_at_iteration(self.cfg, iteration))

    def _block(self, batch_size: int) -> Tuple[int, int]:
        """``(first, per)``: the rows of a ``batch_size`` batch this learner
        trains on (all of them; a data-parallel rank's block in
        ``parallel.dp.DPTrainer``)."""
        return 0, batch_size

    # the train_step reduce hook (none: one device)
    _reduce: Optional[Callable] = None

    def step(self, planes, policy_tgt, value_tgt,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """One SGD step on a batch (this learner's block of its rows)."""
        first, per = self._block(planes.shape[0])
        take = lambda x: x[first:first + per]
        return train_step(self.state, take(planes), take(policy_tgt),
                          take(value_tgt), generator=generator,
                          rows=(first, planes.shape[0]), reduce=self._reduce,
                          **self._loss_kwargs())

    def steps(self, buffer: replay_lib.ReplayBuffer,
              generator: Optional[torch.Generator], num_steps: int,
              batch_size: int) -> Dict[str, torch.Tensor]:
        """``num_steps`` SGD steps sampled from ``buffer``
        (``train_steps``)."""
        return train_steps(self.state, buffer, generator,
                           num_steps=num_steps, batch_size=batch_size,
                           block=self._block(batch_size), reduce=self._reduce,
                           **self._loss_kwargs())

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The learner's weights and BatchNorm running averages."""
        return self.state.net.state_dict()

    def copy_to(self, net: resnet.AlphaZeroNet) -> None:
        """Load the learner's weights and running averages into ``net``
        (a self-play net, on any device)."""
        net.load_state_dict(self.state_dict())
