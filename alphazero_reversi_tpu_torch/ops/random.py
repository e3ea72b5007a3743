"""Root Dirichlet noise from a fixed-trial gamma sampler.

Port of ``alphazero_reversi_tpu/ops/random.py``. ``sample_log_gamma`` draws
``iters`` Marsaglia-Tsang candidates per element at shape ``alpha + 1`` up
front and takes the first accepted one, so the draw has no data-dependent
loop (a search round stays capturable in a CUDA graph). Acceptance per trial
is >= 0.95 at shape >= 1, so with 8 trials an element falls back (to the
mode) with probability ~4e-11. The shape boost ``Gamma(a) = Gamma(a + 1) *
U^(1/a)`` is applied in log space: at AlphaZero's alpha ~ 0.03,
``U^(1/alpha)`` underflows float32, ``log(U) / alpha`` does not.

Draws come from a ``torch.Generator`` (x, then u, then the boost's uniform),
so their stream differs from the JAX package's threefry stream; the parity
tests inject JAX's log-gamma draw through ``dirichlet_noise(log_gamma=...)``.
``torch.distributions.Dirichlet`` is not used: its gamma sampler loops until
acceptance and follows yet another stream.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def sample_log_gamma(alpha: float, shape: Tuple[int, ...],
                     generator: Optional[torch.Generator] = None,
                     iters: int = 8, device=None) -> torch.Tensor:
    """``log g`` for ``g ~ Gamma(alpha, 1)``, float32 of ``shape``, from
    ``generator`` (default: the device's default generator)."""
    alpha = torch.tensor(alpha, dtype=torch.float32, device=device)
    d = alpha + 1.0 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    trials = (iters,) + tuple(shape)
    x = torch.randn(trials, generator=generator, device=device)
    u = torch.rand(trials, generator=generator, device=device) \
        .clamp_min(1e-12)
    v = (1.0 + c * x) ** 3
    # squeeze step: accept when v > 0 and log u < x^2/2 + d - d v + d log v
    ok = (v > 0.0) & (u.log() < 0.5 * x * x + d - d * v
                      + d * torch.where(v > 0.0, v, 1.0).log())
    # the first accepted trial per element (argmax returns the first max)
    idx = ok.to(torch.int32).argmax(0, keepdim=True)
    v_pick = torch.where(ok.any(0), v.gather(0, idx.long())[0], 1.0)
    ub = torch.rand(tuple(shape), generator=generator, device=device) \
        .clamp_min(1e-12)
    return d.log() + v_pick.log() + ub.log() / alpha


def dirichlet_noise(alpha: float, legal: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    log_gamma: Optional[torch.Tensor] = None,
                    iters: int = 8) -> torch.Tensor:
    """A Dirichlet(alpha) draw over the legal actions of each row of
    ``legal`` ``[..., A]``: the masked softmax of log-gamma samples, zero
    where illegal (rows without a legal action are all zero). ``log_gamma``
    (the shape of ``legal``) replaces the draw from ``generator``."""
    if log_gamma is None:
        log_gamma = sample_log_gamma(alpha, tuple(legal.shape), generator,
                                     iters, device=legal.device)
    masked = torch.where(legal, log_gamma.float(), -math.inf)
    return torch.where(legal, torch.softmax(masked, -1), 0.0)
