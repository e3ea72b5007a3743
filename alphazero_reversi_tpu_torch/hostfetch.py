"""Watchdog-guarded device-to-host copies and collectives.

Port of ``alphazero_reversi_tpu/hostfetch.py``. A copy from the card or a
collective can block without an error: a wedged driver, or an NCCL peer
that died, leaves the caller in a wait that never ends. The pipeline's
critical host copies (the checkpoint's host copy, the relabel's fetch, the
trajectory gather of a data-parallel run) run under a watchdog when
``training.fetch_timeout_s`` > 0, and raise :class:`FetchTimeoutError`
after that many seconds instead of blocking for ever.

The guarded call runs on a daemon thread, with the caller's current CUDA
device (the current device belongs to each thread, and a new one starts on
``cuda:0``: a rank's copy or collective would go to another rank's card).
On a timeout that thread stays blocked (it cannot be cancelled), but the
caller regains control with the state it already holds; the thread ends
with the process.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

import torch

_log = logging.getLogger(__name__)

# per thread: the background checkpoint worker copies while the loop's
# thread fetches, and a shared value would mix their durations
_tls = threading.local()


def last_fetch_seconds() -> float:
    """Seconds of the last guarded call completed on the calling thread."""
    return getattr(_tls, "last", 0.0)


class FetchTimeoutError(RuntimeError):
    """A guarded host copy or collective exceeded its watchdog timeout."""


def guarded(fn: Callable[[], Any], timeout_s: Optional[float],
            what: str = "host fetch") -> Any:
    """``fn()`` under a watchdog: raise :class:`FetchTimeoutError` if it has
    not returned within ``timeout_s`` seconds (None or <= 0: a plain
    call). Errors ``fn`` raises reach the caller. The duration is kept per
    thread (``last_fetch_seconds``) and logged at debug level."""
    t0 = time.perf_counter()
    if not timeout_s or timeout_s <= 0:
        out = fn()
        _tls.last = time.perf_counter() - t0
        _log.debug("%s: %.3f s", what, _tls.last)
        return out

    box: dict = {}
    card = (torch.cuda.current_device() if torch.cuda.is_initialized()
            else None)

    def run():
        try:
            if card is not None:
                torch.cuda.set_device(card)
            box["value"] = fn()
        except BaseException as e:  # raised on the caller's thread below
            box["error"] = e

    worker = threading.Thread(target=run, daemon=True,
                              name=f"hostfetch:{what}")
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        raise FetchTimeoutError(
            f"{what} exceeded the {timeout_s:.1f} s watchdog (a wedged "
            "device copy or collective); the state already on the host is "
            "intact: resume from the last checkpoint")
    if "error" in box:
        raise box["error"]
    _tls.last = time.perf_counter() - t0
    _log.debug("%s: %.3f s", what, _tls.last)
    return box["value"]


def map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every tensor in its dicts, lists,
    tuples and named tuples; other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)._make(map_tensors(fn, v) for v in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def to_cpu(tree: Any) -> Any:
    """``tree`` with every tensor copied to host memory."""
    return map_tensors(lambda t: t.detach().cpu(), tree)


def device_get(tree: Any, timeout_s: Optional[float] = None,
               what: str = "host fetch") -> Any:
    """``to_cpu(tree)`` under the watchdog (the JAX ``device_get``'s
    counterpart)."""
    return guarded(lambda: to_cpu(tree), timeout_s, what)
