"""Data parallelism over ranks: one process per card, ``torch.distributed``
(NCCL on the card, gloo on the CPU). Port of
``alphazero_reversi_tpu/parallel/``."""
