// Reversi rule kernels for the port's native endgame solver (solver.cpp).
// A copy of alphazero_reversi_tpu/native/rules.h, which the JAX package's
// oracle and solver share, so the two packages' solvers play one game.
//
// Two rule modes (see SURVEY.md §2.5):
//   mode 0 ("correct"):  canonical Othello rules, edge-masked ray fills.
//   mode 1 ("compat"):   move-for-move replication of the reference's pure
//                        Python Board (src/game/board.py):
//                        unmasked candidate propagation in move generation
//                        (board.py:100-124) and abs(direction)-keyed flip
//                        masks (board.py:196-208).
#pragma once

#include <cstdint>

namespace reversi {

inline constexpr int kBlack = 1;
inline constexpr int kWhite = 2;
inline constexpr uint64_t kNotFileA = 0xFEFEFEFEFEFEFEFEULL;  // col != 0
inline constexpr uint64_t kNotFileH = 0x7F7F7F7F7F7F7F7FULL;  // col != 7
inline constexpr uint64_t kFull = 0xFFFFFFFFFFFFFFFFULL;

// Directions as signed shifts: E=+1, W=-1, S=+8, N=-8, SE=+9, NW=-9, SW=+7,
// NE=-7 (bit = row*8 + col, row grows south).
inline constexpr int kDirs[8] = {1, -1, 8, -8, 9, -9, 7, -7};

inline uint64_t raw_shift(uint64_t x, int d) {
  return d >= 0 ? (x << d) : (x >> -d);
}

inline uint64_t correct_mask(int d) {
  switch (d) {
    case 1: case 9: case -7: return kNotFileA;   // col+1 moves
    case -1: case -9: case 7: return kNotFileH;  // col-1 moves
    default: return kFull;                       // N/S
  }
}

// The reference looks flip masks up by abs(d) from a table whose diagonal
// entries are themselves swapped (board.py:196-208). Effective mask per
// signed direction:
inline uint64_t compat_flip_mask(int d) {
  switch (d) {
    case 1: case -1: case 7: case -7: return kNotFileA;
    case 9: case -9: return kNotFileH;
    default: return kFull;
  }
}

inline uint64_t masked_shift(uint64_t x, int d) {
  return raw_shift(x, d) & correct_mask(d);
}

inline int popcount64(uint64_t x) { return __builtin_popcountll(x); }

// Legal-move bitboard for the side holding `mine`.
inline uint64_t legal_moves_bb(uint64_t mine, uint64_t theirs, int mode) {
  uint64_t empty = ~(mine | theirs);
  uint64_t moves = 0;
  for (int i = 0; i < 8; ++i) {
    int d = kDirs[i];
    if (mode == 1) {
      // board.py:107-124 — raw, unmasked shift-propagate (can wrap edges).
      uint64_t x = raw_shift(mine, d) & theirs;
      for (int k = 0; k < 5; ++k) x |= raw_shift(x, d) & theirs;
      moves |= raw_shift(x, d) & empty;
    } else {
      uint64_t x = masked_shift(mine, d) & theirs;
      for (int k = 0; k < 5; ++k) x |= masked_shift(x, d) & theirs;
      moves |= masked_shift(x, d) & empty;
    }
  }
  return moves;
}

// Discs flipped by the side holding `mine` playing `square` (which must be a
// legal move; under compat rules the result may legitimately be 0 — the
// zero-flip quirk).
inline uint64_t flips_bb(uint64_t mine, uint64_t theirs, int square,
                         int mode) {
  uint64_t move_bit = 1ULL << square;
  uint64_t flips = 0;
  for (int i = 0; i < 8; ++i) {
    int d = kDirs[i];
    if (mode == 1) {
      // board.py:205-219 — serial ray walk with abs()-keyed edge masks.
      uint64_t em = compat_flip_mask(d);
      uint64_t curr = move_bit;
      uint64_t line = 0;
      for (int k = 0; k < 7; ++k) {
        curr = raw_shift(curr, d);
        if (!(curr & theirs & em)) break;
        line |= curr;
      }
      if (curr & mine & em) flips |= line;
    } else {
      uint64_t x = masked_shift(move_bit, d) & theirs;
      for (int k = 0; k < 5; ++k) x |= masked_shift(x, d) & theirs;
      if (masked_shift(x, d) & mine) flips |= x;
    }
  }
  return flips;
}

}  // namespace reversi
