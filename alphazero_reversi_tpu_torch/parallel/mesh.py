"""Process group and the data axis.

Port of ``alphazero_reversi_tpu/parallel/mesh.py``. Where the JAX package
builds a ``(data, model)`` device mesh and lets one program span it, the
port runs one process (a *rank*) per card: a world of ``d`` ranks is the
data axis. Rank ``r`` drives ``cuda:(r % device_count)`` unless a device is
named, and holds rows ``[r n / d, (r + 1) n / d)`` of a batch of ``n``
(``local_rows``). What the JAX package replicates, every rank builds
alike from the same seed, or takes from rank 0
(``multihost.broadcast_from_primary``).

``initialize_distributed`` is the ``jax.distributed.initialize``
counterpart: a TCP rendezvous at ``coordinator_address``, NCCL for a card
and gloo for the CPU. Without it, no process group exists and the pipeline
is a world of one rank. The JAX ``local_mesh`` (the devices of one
process, for process-local work) has no counterpart: a rank drives one
card. ``spawn_ranks`` starts the ranks of a run on one host as processes
(the bench's ``scaling``, the tests, ``chip_smoke.py``).
"""
from __future__ import annotations

import datetime
import socket
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..mcts.search import resolve_device

# a rank that waits longer than this at a rendezvous or a collective fails
# instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """The data axis as this rank sees it: ``world`` ranks, this one
    ``rank``, driving ``device``."""

    world: int
    rank: int
    device: torch.device


def is_initialized() -> bool:
    """True when this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def rank_device(device=None, rank: int = 0) -> torch.device:
    """The device rank ``rank`` drives: ``device`` when it names one (an
    indexed card, or the CPU), else ``cuda:(rank % device_count)``. Raises
    without CUDA unless the CPU is asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)  # raises without a card
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(dev)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, meeting at ``coordinator_address`` (``host:port``; rank
    0 listens there). NCCL when this rank drives a card (which becomes the
    current CUDA device), gloo on the CPU; a failed initialisation raises.
    Returns False, and does nothing, when none of the three is given."""
    given = (coordinator_address, num_processes, process_id)
    if all(x is None for x in given):
        return False
    if any(x is None for x in given):
        raise ValueError("a distributed run needs the coordinator address, "
                         "the number of processes and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"[0, {num_processes})")
    dev = rank_device(device, process_id)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT,
        **kwargs)
    return True


def make_mesh(cfg: Optional[MeshConfig] = None, device=None) -> Mesh:
    """This rank's view of the data axis: the process group's world and
    rank and the rank's device (``rank_device``); without a process group,
    a world of 1 on ``device`` (default: the current card).

    ``data_axis`` -1 means the world size; any other value must equal it
    (a rank drives one card, so the axis cannot cover fewer). A
    ``model_axis`` above 1 raises: nothing in the port shards over a model
    axis, and where the JAX package warns and repeats the work on every
    model-axis replica, the port has no replicas to repeat it on."""
    cfg = cfg or MeshConfig()
    world = dist.get_world_size() if is_initialized() else 1
    rank = dist.get_rank() if is_initialized() else 0
    if cfg.model_axis > 1:
        raise ValueError(
            f"mesh model_axis={cfg.model_axis}: the port has no model "
            f"axis (the 8x8 net is replicated on every rank; scale with "
            f"the data axis)")
    if cfg.data_axis > 0 and cfg.data_axis != world:
        raise ValueError(
            f"mesh data_axis={cfg.data_axis} does not match the "
            f"{world} rank(s) of this run (use -1 for all of them)")
    dev = rank_device(device, rank) if is_initialized() \
        else resolve_device(device)
    return Mesh(world=world, rank=rank, device=dev)


def local_rows(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``axis`` (the JAX
    ``shard_batch`` as one rank sees it). The axis must divide evenly."""
    n = x.shape[axis]
    if n % mesh.world:
        raise ValueError(f"axis of {n} does not divide over "
                         f"{mesh.world} ranks")
    per = n // mesh.world
    return x.narrow(axis, mesh.rank * per, per)



def free_port() -> int:
    """A TCP port of 127.0.0.1 that was free a moment ago: the rendezvous
    of ranks on one host."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(argv: Callable[[int, int], List[str]], world: int,
                timeout_s: float, env: Optional[Dict[str, str]] = None,
                what: str = "ranks") -> List[str]:
    """Run ``world`` ranks on this host, rank ``r`` as the process
    ``argv(r, port)`` (``port`` free, the same for every rank), and wait
    for them all. When a rank fails, or the run outlasts ``timeout_s``,
    every rank still running is killed and a ``RuntimeError`` carries the
    end of that rank's output. Returns each rank's output (stdout and
    stderr; kept in files, so a rank that prints much never blocks)."""
    port = free_port()
    logs = [tempfile.TemporaryFile() for _ in range(world)]
    procs = [subprocess.Popen(argv(r, port), env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or None not in codes or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read().decode(errors="replace"))
        f.close()
    if failed or None in codes:
        r = failed[0] if failed else codes.index(None)
        why = (f"failed (exit {codes[r]})" if failed
               else f"outlasted {timeout_s} s")
        raise RuntimeError(f"{what}: rank {r} of {world} {why}:\n"
                           f"{outs[r][-3000:]}")
    return outs
