"""Checkpoint and resume, in torch's own format.

Port of ``alphazero_reversi_tpu/checkpoint.py`` (which writes Orbax). A
checkpoint is a directory ``<ckpt_dir>/it_<NNNNNN>`` holding one
``state.pt``: a nested dict of tensors and Python scalars (the pipeline's
tree: learner weights and BatchNorm statistics, AdamW's state, the best
weights, the replay buffer with ``cursor`` and ``size``, ``iteration``,
``best_elo`` and the generators' states). The best model is a
weights-only directory ``<ckpt_dir>/best_model`` holding ``weights.pt``.
Files load with ``torch.load(weights_only=True)``.

Writes are atomic: a save writes into a temporary directory beside the
target (``.tmp_*``, which no reader matches) and renames it into place, so
``latest_checkpoint`` never finds a half-written checkpoint.

A save first copies every tensor to host memory (``to_host``), on the
calling thread: that copy is all the caller waits for, and it must finish
before the next SGD step changes the weights in place. With ``async_save``
a background thread then writes the file while the caller goes on. At most
one write is in flight: a new save waits for the previous one, and readers
call ``wait_for_saves`` first.

A caller that saves off its own thread (the pipeline's
``background_checkpoint_fetch``) first takes a ``snapshot``: a clone of
every tensor where it lies, made on the caller's stream, and a CUDA event
recorded after it. A save of that snapshot on another thread, given the
event, takes its host copy on a stream of its own behind the event, so it
never sees a later in-place write and never holds up the caller's stream.
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

_STEP_RE = re.compile(r"^it_(\d+)$")
STATE_FILE = "state.pt"
BEST_DIR = "best_model"
BEST_FILE = "weights.pt"

_LOCK = threading.Lock()  # guards _WRITER and _ERROR
_WRITER: Optional[threading.Thread] = None
_ERROR: Optional[BaseException] = None
_LAST_COPY = threading.local()  # each thread's last host copy, seconds


def _map_tensors(fn, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every tensor in its dicts, lists and
    tuples; other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def to_host(tree: Any, ready: Optional["torch.cuda.Event"] = None,
            device: Optional[torch.device] = None) -> Any:
    """A copy of ``tree`` with every tensor copied to host memory (a CUDA
    tensor's copy waits for the card; a CPU tensor is cloned, so later
    in-place updates do not reach the copy). With ``ready``, the event a
    ``snapshot`` recorded on CUDA ``device``, the copies run on a new stream
    of that device that first waits for the event."""
    def copy(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True)

    if ready is None:
        return _map_tensors(copy, tree)
    stream = torch.cuda.Stream(device=device)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        return _map_tensors(copy, tree)


def snapshot(tree: Any, device: torch.device
             ) -> Tuple[Any, Optional["torch.cuda.Event"]]:
    """A clone of every tensor of ``tree`` where it lies, and (on a CUDA
    ``device``) an event recorded on its current stream after the clones.
    Later in-place writes to ``tree`` do not reach the clone, so another
    thread may copy it to the host (``to_host(clone, event, device)``)
    while the caller goes on."""
    clone = _map_tensors(lambda t: t.detach().clone(), tree)
    if device.type != "cuda":
        return clone, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return clone, event


def wait_for_saves() -> None:
    """Block until the in-flight write (if any) is on disk; raise the error
    it hit, if any. Call before reading a checkpoint and at exit."""
    global _WRITER, _ERROR
    with _LOCK:
        writer = _WRITER
    if writer is not None:
        writer.join()
    with _LOCK:
        if _WRITER is writer:
            _WRITER = None
        err, _ERROR = _ERROR, None
    if err is not None:
        raise err


def _write_atomic(path: str, filename: str, tree: Any) -> None:
    """``torch.save`` into a temporary directory beside ``path``, then
    rename it into place (replacing an older ``path``). If the write fails
    or is interrupted, an older ``path`` that was already moved aside is
    moved back."""
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp_{os.path.basename(path)}_",
                           dir=parent)
    old = None
    try:
        torch.save(tree, os.path.join(tmp, filename))
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=".old_", dir=parent)
            os.rename(path, os.path.join(old, "x"))
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if old is not None:
            moved = os.path.join(old, "x")
            if os.path.exists(moved) and not os.path.exists(path):
                os.rename(moved, path)  # put the older checkpoint back
            if not os.path.exists(moved):
                os.rmdir(old)
        raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def _save(path: str, filename: str, tree: Any, async_save: bool,
          ready: Optional["torch.cuda.Event"] = None,
          device: Optional[torch.device] = None) -> str:
    global _WRITER
    t0 = time.perf_counter()
    host_tree = to_host(tree, ready, device)
    _LAST_COPY.seconds = time.perf_counter() - t0
    wait_for_saves()  # at most one write in flight
    if not async_save:
        _write_atomic(path, filename, host_tree)
        return path

    def work():
        global _ERROR
        try:
            _write_atomic(path, filename, host_tree)
        except Exception as e:  # raised by the next wait_for_saves
            with _LOCK:
                _ERROR = e

    writer = threading.Thread(target=work, daemon=True,
                              name=f"ckpt:{os.path.basename(path)}")
    with _LOCK:
        _WRITER = writer
    writer.start()
    return path


def last_host_copy_seconds() -> float:
    """Seconds the calling thread's last save spent on its host copy
    (``to_host``)."""
    return getattr(_LAST_COPY, "seconds", 0.0)


def checkpoint_path(ckpt_dir: str, iteration: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"it_{iteration:06d}")


def _iterations(ckpt_dir: str) -> List[tuple]:
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted((int(m.group(1)), os.path.join(ckpt_dir, name))
                  for name in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.match(name)))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``it_NNNNNN`` directory under ``ckpt_dir``, or None."""
    wait_for_saves()  # an in-flight save is the latest once written
    its = _iterations(ckpt_dir)
    return its[-1][1] if its else None


def save_checkpoint(ckpt_dir: str, iteration: int, tree: Dict[str, Any],
                    async_save: bool = False,
                    ready: Optional["torch.cuda.Event"] = None,
                    device: Optional[torch.device] = None) -> str:
    """Write ``tree`` as ``<ckpt_dir>/it_<iteration>`` (module docstring:
    host copy first, then an atomic write, in the background with
    ``async_save``). ``ready`` and ``device``: a ``snapshot``'s event and
    device, as ``to_host`` takes them. Returns the path."""
    return _save(checkpoint_path(ckpt_dir, iteration), STATE_FILE, tree,
                 async_save, ready, device)


def prune_checkpoints(ckpt_dir: str, keep_latest: int = 1) -> List[str]:
    """Delete all but the newest ``keep_latest`` ``it_NNNNNN`` checkpoints
    (``best_model`` is never touched; a write still in flight is not yet
    visible, so the previous checkpoint survives until it lands). Returns
    the deleted paths."""
    its = _iterations(ckpt_dir)
    doomed = [path for _, path in its[:max(0, len(its) - keep_latest)]]
    for path in doomed:
        shutil.rmtree(path, ignore_errors=True)
    return doomed


def restore_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    """Load a checkpoint's tree (tensors on ``map_location``, default where
    they were saved from: the host)."""
    wait_for_saves()
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location=map_location, weights_only=True)


def save_best(ckpt_dir: str, weights: Dict[str, torch.Tensor],
              async_save: bool = False) -> str:
    """Weights-only best model, ``<ckpt_dir>/best_model``."""
    return _save(os.path.join(os.path.abspath(ckpt_dir), BEST_DIR),
                 BEST_FILE, weights, async_save)


def restore_best(ckpt_dir: str, map_location=None
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """The best model's weights, if ``ckpt_dir`` has them."""
    wait_for_saves()
    path = os.path.join(os.path.abspath(ckpt_dir), BEST_DIR, BEST_FILE)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location=map_location, weights_only=True)
