"""Fused MCTS backup + child link: the CUDA kernel's wrapper and its plain
version.

Replaces the TPU kernel in ``alphazero_reversi_tpu/mcts/pallas_backup.py``
(``_backup_kernel`` via ``backup_and_link_tpu``). The kernel is
``csrc/backup_link.cu`` (one thread per game, in place on ``stats``); its
source note gives the add order and what bounds it on an H100.

``backup_and_link`` launches the kernel for CUDA tensors and takes the plain
version, ``backup_and_link_reference``, only for CPU tensors. ``LAUNCHES``
counts kernel launches so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

A = 65
STRIDE = 2 * A
VISITS_OFF = 0
VSUM_OFF = A
PACK = 1024.0

LAUNCHES = 0


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


def _check(stats, nodes, actions, value_incs, link_nodes, link_actions,
           link_slots, do_link) -> None:
    if stats.dtype != torch.float32 or stats.dim() != 2 \
            or stats.shape[1] % STRIDE:
        raise ValueError(f"stats must be float32 [B, N*{STRIDE}], got "
                         f"{stats.dtype} {tuple(stats.shape)}")
    b = stats.shape[0]
    for name, t, dtype, width in (
            ("nodes", nodes, torch.int32, None),
            ("actions", actions, torch.int32, nodes.shape[-1]),
            ("value_incs", value_incs, torch.float32, nodes.shape[-1]),
            ("link_nodes", link_nodes, torch.int32, None),
            ("link_actions", link_actions, torch.int32, link_nodes.shape[-1]),
            ("link_slots", link_slots, torch.int32, link_nodes.shape[-1]),
            ("do_link", do_link, torch.bool, link_nodes.shape[-1])):
        if t.dtype != dtype or t.dim() != 2 or t.shape[0] != b \
                or (width is not None and t.shape[1] != width):
            raise ValueError(f"{name} must be {dtype} [B={b}, "
                             f"{width or 'P/L'}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (stats, nodes, actions, value_incs, link_nodes, link_actions,
              link_slots, do_link):
        if t.device != stats.device:
            raise ValueError("all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")


def _library() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load("backup_link")
    fn = lib.azr_backup_link
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int64, p, p, p, ctypes.c_int, p, p, p, p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


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
    _check(*args)
    if stats.device.type == "cpu":
        backup_and_link_reference(*args)
        return
    if stats.device.type != "cuda":
        raise ValueError(f"no backup kernel for device {stats.device}")
    stream = torch.cuda.current_stream(stats.device).cuda_stream
    err = _library().azr_backup_link(
        stats.data_ptr(), stats.shape[1], nodes.data_ptr(),
        actions.data_ptr(), value_incs.data_ptr(), nodes.shape[1],
        link_nodes.data_ptr(), link_actions.data_ptr(), link_slots.data_ptr(),
        do_link.data_ptr(), link_nodes.shape[1], stats.shape[0], PACK, stream)
    if err != 0:
        raise RuntimeError(f"backup_link kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
