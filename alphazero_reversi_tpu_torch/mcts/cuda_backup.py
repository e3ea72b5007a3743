"""Fused MCTS backup + child link: the CUDA kernel's wrappers and their plain
versions.

Replaces the TPU kernel in ``alphazero_reversi_tpu/mcts/pallas_backup.py``
(``_backup_kernel`` via ``backup_and_link_tpu``). The kernel is
``csrc/backup_link.cu`` (one warp per game, in place on ``stats``); its
source note gives the add order and what bounds it on an H100. It has two
entry points:

* ``backup_and_link`` (``azr_backup_link``): the JAX function's interface,
  ``[B, P]`` path entries and ``[B, L]`` links;
* ``round_backup`` (``azr_round_backup``): the whole tail of a simulation
  round after the expansion write, from the round's own arrays, in one
  launch. The search takes this one.

Each launches the kernel for CUDA tensors and takes its plain version
(``backup_and_link_reference``, ``round_backup_reference``) only for CPU
tensors. Arguments are validated once per signature (dtypes, shapes,
devices, contiguity); a call then costs the ``data_ptr()``s, the current
stream and one ctypes call, with no host sync and no allocation, so a
launch can be captured in a CUDA graph. ``LAUNCHES`` and ``ROUND_LAUNCHES``
count kernel launches so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

A = 65
STRIDE = 2 * A
VISITS_OFF = 0
VSUM_OFF = A
PACK = 1024.0

LAUNCHES = 0  # azr_backup_link
ROUND_LAUNCHES = 0  # azr_round_backup

_SEEN: set = set()  # argument signatures that passed validation


def backup_and_link_reference(stats: torch.Tensor, nodes: torch.Tensor,
                              actions: torch.Tensor, value_incs: torch.Tensor,
                              link_nodes: torch.Tensor,
                              link_actions: torch.Tensor,
                              link_slots: torch.Tensor,
                              do_link: torch.Tensor) -> None:
    """Plain version: one ``scatter_add_`` per call over the concatenated
    ``[visits | vsums | links]`` index, in place on ``stats`` [B, N*STRIDE].
    Entries with ``node < 0``, links with ``do_link`` false, and flat
    indices outside the row are dropped (JAX's ``mode="drop"``)."""
    b, m = stats.shape
    ok = nodes >= 0
    base = nodes.clamp_min(0).long() * STRIDE + actions.long()
    i_vis = torch.where(ok, base + VISITS_OFF, m)
    i_val = torch.where(ok, base + VSUM_OFF, m)
    i_link = torch.where(
        do_link, link_nodes.long() * STRIDE + VISITS_OFF + link_actions.long(),
        m)
    idx = torch.cat([i_vis, i_val, i_link], -1)
    idx = torch.where((idx >= 0) & (idx < m), idx, m)
    upd = torch.cat([torch.full(nodes.shape, PACK, device=stats.device),
                     value_incs.float(), link_slots.float()], -1)
    padded = torch.cat([stats, stats.new_zeros(b, 1)], -1)  # column m: drops
    padded.scatter_add_(1, idx, upd)
    stats.copy_(padded[:, :m])


def round_backup_reference(stats: torch.Tensor, pn: torch.Tensor,
                           pa: torch.Tensor, pt: torch.Tensor,
                           eval_tomove: torch.Tensor, value: torch.Tensor,
                           leaves: torch.Tensor, leaf_acts: torch.Tensor,
                           slot0: int, root_to_move: torch.Tensor,
                           root_visit: torch.Tensor,
                           root_vsum: torch.Tensor) -> None:
    """Plain version of the round tail, in place on ``stats``,
    ``root_visit`` and ``root_vsum``: per-entry signs and value increments,
    in-round duplicate links dropped, slots ``slot0 + l``, then
    ``backup_and_link_reference`` and the root totals."""
    batch, L = leaves.shape
    levels = pn.shape[1] // L
    # entry j belongs to descent j // levels
    et_expand = eval_tomove.repeat_interleave(levels, dim=1)
    v_expand = value.repeat_interleave(levels, dim=1)
    sign = torch.where(pt == et_expand.float(), 1.0, -1.0)

    # in-round duplicate (leaf, action) picks back up again but link once
    same = ((leaves[:, :, None] == leaves[:, None, :])
            & (leaf_acts[:, :, None] == leaf_acts[:, None, :]))
    earlier = torch.ones(L, L, dtype=torch.bool,
                         device=leaves.device).tril(-1)
    is_dup = (same & earlier).any(-1)
    do_link = (leaf_acts >= 0) & ~is_dup
    slots = slot0 + torch.arange(L, device=leaves.device)

    def c(t, dtype):
        return t.to(dtype).contiguous()

    backup_and_link_reference(
        stats, c(pn, torch.int32), c(pa, torch.int32),
        c(sign * v_expand, torch.float32), c(leaves, torch.int32),
        c(leaf_acts.clamp_min(0), torch.int32),
        c(slots.expand(batch, L), torch.int32), c(do_link, torch.bool))
    rsign = torch.where(eval_tomove == root_to_move[:, None], 1.0, -1.0)
    root_visit.add_(L)
    # the lanes' values summed in lane order, as the kernel sums them
    # (``sum(-1)`` leaves the order to the backend: on the CPU it is
    # vectorized from 16 lanes up, and float sums differ in the last bit)
    signed = rsign * value
    total = signed[:, 0]
    for lane in range(1, L):
        total = total + signed[:, lane]
    root_vsum.add_(total)


def _signature(tensors) -> tuple:
    return tuple([(t.dtype, t.shape, t.device, t.is_contiguous())
                  for t in tensors])


def _validate(named, widths) -> None:
    """Raise ValueError unless every ``(name, tensor, dtype, rank)`` has that
    dtype and rank, batch ``B = stats.shape[0]``, the ``widths`` (name ->
    required size of dim 1), one device, and is contiguous."""
    stats = named[0][1]
    if stats.dtype != torch.float32 or stats.dim() != 2 \
            or stats.shape[1] % STRIDE or stats.shape[1] >= 2 ** 31:
        raise ValueError(f"stats must be float32 [B, N*{STRIDE}], got "
                         f"{stats.dtype} {tuple(stats.shape)}")
    b = stats.shape[0]
    for name, t, dtype, rank in named[1:]:
        width = widths.get(name)
        if t.dtype != dtype or t.dim() != rank or t.shape[0] != b \
                or (width is not None and t.shape[1] != width):
            want = f"[B={b}]" if rank == 1 else f"[B={b}, {width or 'P/L'}]"
            raise ValueError(f"{name} must be {dtype} {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for _, t, _, _ in named:
        if t.device != stats.device:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    if stats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no backup kernel for device {stats.device}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {  # the C signatures in csrc/backup_link.cu
    "azr_backup_link": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _F,
                        _P],
    "azr_round_backup": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P,
                         _P, _P, _I, _F, _P],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The built kernel's C entry point ``name``, with its ctypes types."""
    from ..kernels import build

    fn = getattr(build.load("backup_link"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle (what
    PyTorch's own generated kernels launch on). The public
    ``torch.cuda.current_stream(dev).cuda_stream`` builds a Stream object
    on every call, which costs more host time than the launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def backup_and_link(stats: torch.Tensor, nodes: torch.Tensor,
                    actions: torch.Tensor, value_incs: torch.Tensor,
                    link_nodes: torch.Tensor, link_actions: torch.Tensor,
                    link_slots: torch.Tensor, do_link: torch.Tensor) -> None:
    """In-place backup+link on ``stats`` [B, N*STRIDE] f32.

    ``nodes``/``actions`` int32 and ``value_incs`` f32 are [B, P];
    ``link_nodes``/``link_actions``/``link_slots`` int32 and ``do_link`` bool
    are [B, L]. CUDA tensors launch the kernel; CPU tensors take the plain
    version; any other device raises."""
    global LAUNCHES
    args = (stats, nodes, actions, value_incs, link_nodes, link_actions,
            link_slots, do_link)
    key = ("link", _signature(args))
    if key not in _SEEN:
        i32 = torch.int32
        _validate([("stats", stats, torch.float32, 2),
                   ("nodes", nodes, i32, 2), ("actions", actions, i32, 2),
                   ("value_incs", value_incs, torch.float32, 2),
                   ("link_nodes", link_nodes, i32, 2),
                   ("link_actions", link_actions, i32, 2),
                   ("link_slots", link_slots, i32, 2),
                   ("do_link", do_link, torch.bool, 2)],
                  {"actions": nodes.shape[-1],
                   "value_incs": nodes.shape[-1],
                   "link_actions": link_nodes.shape[-1],
                   "link_slots": link_nodes.shape[-1],
                   "do_link": link_nodes.shape[-1]})
        _SEEN.add(key)
    if stats.is_cpu:
        backup_and_link_reference(*args)
        return
    err = _entry("azr_backup_link")(
        stats.data_ptr(), stats.shape[1], nodes.data_ptr(),
        actions.data_ptr(), value_incs.data_ptr(), nodes.shape[1],
        link_nodes.data_ptr(), link_actions.data_ptr(), link_slots.data_ptr(),
        do_link.data_ptr(), link_nodes.shape[1], stats.shape[0], PACK,
        _stream(stats))
    _raise_on(err, "backup_link")
    LAUNCHES += 1


def round_backup(stats: torch.Tensor, pn: torch.Tensor, pa: torch.Tensor,
                 pt: torch.Tensor, eval_tomove: torch.Tensor,
                 value: torch.Tensor, leaves: torch.Tensor,
                 leaf_acts: torch.Tensor, slot0: int,
                 root_to_move: torch.Tensor, root_visit: torch.Tensor,
                 root_vsum: torch.Tensor) -> None:
    """A simulation round's backup, links and root totals, in place on
    ``stats`` [B, N*STRIDE] f32, ``root_visit`` [B] int32 and ``root_vsum``
    [B] f32.

    ``pn``/``pa`` int64 and ``pt`` f32 are the ``[B, L*levels]`` lane-major
    path arrays; ``eval_tomove`` int32, ``value`` f32 and ``leaves``/
    ``leaf_acts`` int64 are ``[B, L]``; ``root_to_move`` is int32 [B];
    lane ``l`` links to slot ``slot0 + l``. CUDA tensors launch the kernel;
    CPU tensors take the plain version; any other device raises."""
    global ROUND_LAUNCHES
    args = (stats, pn, pa, pt, eval_tomove, value, leaves, leaf_acts,
            root_to_move, root_visit, root_vsum)
    key = ("round", _signature(args))
    if key not in _SEEN:
        i32, i64, f32 = torch.int32, torch.int64, torch.float32
        _validate([("stats", stats, f32, 2), ("pn", pn, i64, 2),
                   ("pa", pa, i64, 2), ("pt", pt, f32, 2),
                   ("eval_tomove", eval_tomove, i32, 2),
                   ("value", value, f32, 2), ("leaves", leaves, i64, 2),
                   ("leaf_acts", leaf_acts, i64, 2),
                   ("root_to_move", root_to_move, i32, 1),
                   ("root_visit", root_visit, i32, 1),
                   ("root_vsum", root_vsum, f32, 1)],
                  {"pa": pn.shape[-1], "pt": pn.shape[-1],
                   "eval_tomove": leaves.shape[-1],
                   "value": leaves.shape[-1],
                   "leaf_acts": leaves.shape[-1]})
        if pn.shape[1] == 0 or pn.shape[1] % leaves.shape[1]:
            raise ValueError(f"pn's width {pn.shape[1]} must be a positive "
                             f"multiple of L={leaves.shape[1]}")
        _SEEN.add(key)
    if stats.is_cpu:
        round_backup_reference(stats, pn, pa, pt, eval_tomove, value, leaves,
                               leaf_acts, slot0, root_to_move, root_visit,
                               root_vsum)
        return
    err = _entry("azr_round_backup")(
        stats.data_ptr(), stats.shape[1], pn.data_ptr(), pa.data_ptr(),
        pt.data_ptr(), pn.shape[1], eval_tomove.data_ptr(), value.data_ptr(),
        leaves.data_ptr(), leaf_acts.data_ptr(), leaves.shape[1], slot0,
        root_to_move.data_ptr(), root_visit.data_ptr(), root_vsum.data_ptr(),
        stats.shape[0], PACK,
        _stream(stats))
    _raise_on(err, "round_backup")
    ROUND_LAUNCHES += 1
