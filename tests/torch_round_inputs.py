"""Seeded numpy arguments for a simulation round's backup
(``cuda_backup.round_backup`` and its plain version), shaped like a search
round's. JAX-free, so the card-only tests use it too."""
from __future__ import annotations

import numpy as np

S = 130  # stats stride: 65 packed visits|child cells, then 65 value sums
ROUND_ARGS = ("pn", "pa", "pt", "eval_tomove", "value", "leaves",
              "leaf_acts")


def round_inputs(rng, batch: int, nodes_n: int, levels: int, links: int,
                 odd: bool = False, dups: bool = False) -> dict:
    """Each lane descends from the root (node 0) through distinct nodes, 1 to
    ``levels`` deep, padded with node -1; its leaf edge is its last entry
    (``leaf_act`` -1, no expansion, for about 1 lane in 10). With
    ``links > 1``, about 3 lanes in 10 repeat lane 0 (an in-round duplicate:
    same path, same evaluation) and about 3 in 10 share lane 0's root edge
    with another value. Packed cells hold exact integers, value sums
    floats. ``odd`` adds nodes past the tree and actions outside [0, 65).
    ``dups`` (links > 1) makes lane 1 of every game repeat lane 0, whose
    leaf edge is then always expanded: a forced in-round duplicate, linked
    once."""
    visits = rng.integers(0, 33, (batch, nodes_n, 65))
    stats = np.concatenate(
        [visits * 1024.0 + rng.integers(0, nodes_n, visits.shape),
         visits * rng.uniform(-1, 1, visits.shape)], -1).astype(np.float32)
    p = levels * links
    pn = np.full((batch, p), -1, np.int64)
    pa = np.zeros((batch, p), np.int64)
    pt = rng.choice(np.float32([1.0, 2.0]), (batch, p))
    leaves = np.zeros((batch, links), np.int64)
    leaf_acts = np.full((batch, links), -1, np.int64)
    eval_tomove = rng.integers(1, 3, (batch, links)).astype(np.int32)
    value = rng.uniform(-1, 1, (batch, links)).astype(np.float32)
    for b in range(batch):
        for l in range(links):
            lane = slice(l * levels, (l + 1) * levels)
            kind = rng.random()
            if l and (kind < 0.3 or (dups and l == 1)):
                pn[b, lane], pa[b, lane], pt[b, lane] = (
                    pn[b, :levels], pa[b, :levels], pt[b, :levels])
                leaves[b, l], leaf_acts[b, l] = leaves[b, 0], leaf_acts[b, 0]
                eval_tomove[b, l], value[b, l] = eval_tomove[b, 0], value[b, 0]
                continue
            depth = rng.integers(1, min(levels, nodes_n) + 1)
            path = np.concatenate(
                [[0], rng.permutation(np.arange(1, nodes_n))[:depth - 1]])
            acts = rng.integers(0, 65, depth)
            if l and kind < 0.6:
                acts[0] = pa[b, 0]
            pn[b, l * levels:l * levels + depth] = path
            pa[b, l * levels:l * levels + depth] = acts
            leaves[b, l] = path[-1]
            leaf_acts[b, l] = acts[-1] if rng.random() < 0.9 or (
                dups and l == 0) else -1
    if odd:
        pn = np.where((pn >= 0) & (rng.random(pn.shape) < 0.1),
                      nodes_n + rng.integers(0, 3, pn.shape), pn)
        pa = np.where(rng.random(pa.shape) < 0.1,
                      rng.integers(-3, 71, pa.shape), pa)
        leaf_acts = np.where(rng.random(leaf_acts.shape) < 0.2,
                             rng.integers(65, 71, leaf_acts.shape), leaf_acts)
    return dict(
        stats=stats.reshape(batch, nodes_n * S), pn=pn, pa=pa, pt=pt,
        eval_tomove=eval_tomove, value=value, leaves=leaves,
        leaf_acts=leaf_acts, slot0=int(rng.integers(1, nodes_n)),
        root_to_move=rng.integers(1, 3, batch).astype(np.int32),
        root_visit=rng.integers(0, 100, batch).astype(np.int32),
        root_vsum=rng.normal(0, 5, batch).astype(np.float32))
