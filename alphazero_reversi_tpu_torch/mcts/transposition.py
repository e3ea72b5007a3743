"""Host transposition table with dihedral-8 symmetry lookup.

The port's numpy copy of ``alphazero_reversi_tpu/mcts/transposition.py``.
It serves the host play surface (``search.MCTS.get_action_probs`` at batch
1: ``cli play`` and match play), where openings repeat and a noise-free
search of a position already searched is pure recomputation. Entries are
keyed by the symmetry-canonical Zobrist hash (``zobrist``), so a position
cached in one orientation hits in all eight; the stored visit counts are
permuted back through the matching symmetry on the way out. Entries keep
visit counts and the root value, not temperature-shaped probabilities, so
one entry serves any play temperature; Gumbel entries also keep the
improved policy and the halving winner.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from .. import symmetry, zobrist


class TranspositionTable:
    """LRU-bounded ``(canonical hash, kind) -> (exact hash, visit_counts,
    value[, action_probs, chosen_action])``.

    ``lookup``/``store`` take host bitboard ints (LSB-first square order)
    plus the side to move — the representation of ``env.game.Board`` and
    the C oracle.
    """

    def __init__(self, capacity: int = 100_000, use_symmetry: bool = True):
        # Entries store (exact_hash, visit_counts, value, probs, chosen):
        # ``probs``/``chosen`` are the Gumbel search's improved policy and
        # sequential-halving winner (None for PUCT entries). The two
        # algorithms' results are not interchangeable, so keys carry the
        # kind ("puct"/"gumbel"): a position searched by both algorithms
        # (e.g. two MCTS instances sharing one table) caches both results
        # side by side instead of overwriting each other.
        """``use_symmetry=False`` keys by the exact position only. Required
        when the RULES are not dihedral-equivariant — compat mode's
        edge-wrap/mis-masked-flip quirks single out the east/west directions
        (see ``symmetry``'s module docstring), so a search result permuted
        from another orientation could place visits on squares that are
        illegal in the query orientation. ``MCTS`` picks this automatically
        from its ``compat`` flag."""
        self.capacity = capacity
        self.use_symmetry = use_symmetry
        self.hits = 0
        self.misses = 0
        self._store: OrderedDict[
            Tuple[int, str],
            Tuple[int, np.ndarray, float, Optional[np.ndarray],
                  Optional[int]]] = OrderedDict()

    def __len__(self) -> int:
        return len(self._store)

    def clear(self) -> None:
        """Drop all entries (hit/miss counters survive). Called when the
        model weights behind the cached searches change."""
        self._store.clear()

    def _hashes(self, black: int, white: int, to_move: int):
        if self.use_symmetry:
            return zobrist.symmetry_hashes_ints(black, white, to_move)
        return [zobrist.hash_ints(black, white, to_move)]

    def store(self, black: int, white: int, to_move: int,
              visit_counts: np.ndarray, value: float,
              action_probs: Optional[np.ndarray] = None,
              chosen_action: Optional[int] = None) -> None:
        """``action_probs``/``chosen_action`` mark a Gumbel-search entry
        (improved policy + sequential-halving winner); omit for PUCT.
        Keys include the entry KIND, so one position may be cached under
        both algorithms side by side (the results are not interchangeable)
        — a shared table never thrashes between kinds."""
        hashes = self._hashes(black, white, to_move)
        kind = "puct" if action_probs is None else "gumbel"
        key = (min(hashes), kind)
        probs = (None if action_probs is None
                 else np.asarray(action_probs, np.float32).copy())
        chosen = None if chosen_action is None else int(chosen_action)
        self._store[key] = (hashes[0], np.asarray(visit_counts,
                                                  np.float32).copy(),
                            float(value), probs, chosen)
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    @staticmethod
    def _permute_actions(arr: np.ndarray, inv: int) -> np.ndarray:
        out = np.empty_like(arr)
        out[:64] = arr[symmetry.PERMS[inv]]
        out[64:] = arr[64:]
        return out

    def _lookup_entry(self, black: int, white: int, to_move: int,
                      kind: str):
        """Shared probe for one entry KIND: returns ``(entry, inv_perm)``
        for a symmetry-exact hit (entry oriented as STORED; ``inv`` maps it
        to the query), else None. Counts the hit/miss; only a confirmed hit
        refreshes the entry's LRU position."""
        hashes = self._hashes(black, white, to_move)
        key = (min(hashes), kind)
        entry = self._store.get(key)
        if entry is not None:
            stored_hash = entry[0]
            for s, h in enumerate(hashes):
                if h == stored_hash:
                    self.hits += 1
                    self._store.move_to_end(key)
                    return entry, int(symmetry.INVERSE[s])
        # absent, or canonical collision without an exact symmetry match
        self.misses += 1
        return None

    def lookup(self, black: int, white: int, to_move: int
               ) -> Optional[Tuple[np.ndarray, float]]:
        """PUCT query: ``(visit_counts, value)`` oriented to the QUERY
        position, or None. A hit through symmetry ``s`` (stored ==
        transform_s(query)) permutes the stored counts back by
        ``INVERSE[s]``. Gumbel entries do not satisfy a PUCT query."""
        probe = self._lookup_entry(black, white, to_move, "puct")
        if probe is None:
            return None
        (_, counts, value, _, _), inv = probe
        return self._permute_actions(counts, inv), value

    def lookup_gumbel(self, black: int, white: int, to_move: int
                      ) -> Optional[Tuple[np.ndarray, float, np.ndarray,
                                          int]]:
        """Gumbel query: ``(visit_counts, value, action_probs,
        chosen_action)`` oriented to the QUERY position, or None. The chosen
        action maps through the inverse square permutation (pass stays
        pass). PUCT entries do not satisfy a Gumbel query."""
        probe = self._lookup_entry(black, white, to_move, "gumbel")
        if probe is None:
            return None
        (_, counts, value, probs, chosen), inv = probe
        if chosen < 64:
            # counts_query[q] = counts_stored[PERMS[inv][q]], so the stored
            # winner a lands at the query index q with PERMS[inv][q] == a
            chosen = int(np.argsort(symmetry.PERMS[inv])[chosen])
        return (self._permute_actions(counts, inv), value,
                self._permute_actions(probs, inv), chosen)
