// Exact endgame solver: fail-soft negamax alpha-beta over the final disc
// differential, with a bounded transposition table and corner-first +
// mobility move ordering.
//
// A copy of alphazero_reversi_tpu/native/solver.cpp for the PyTorch port,
// built on its own (the port never loads the JAX package's library).
//
// This is an EXTENSION beyond reference parity — the reference
// has no exact solver; its MCTS plays endgames from search
// statistics alone. Solving the last ~14-20 empties exactly converts won
// endgames perfectly at match play and gives ground-truth values for
// analysis. Rule kernels come from rules.h (the JAX package's oracle shares
// them), so the solver honors BOTH rule modes, including the compat quirks —
// under compat rules "optimal" means optimal in the reference's quirky game,
// which is a genuinely different game tree (edge-wrap moves, zero-flip
// placements).
//
// Scoring follows the reference's winner rule (board.py:253-262): the raw
// disc differential at game end, counting discs only (empty squares are
// awarded to nobody). Values are from the mover's perspective, in
// [-64, +64].
//
// Exposed as a plain C ABI for ctypes (no Python headers to build against).
//
// THREAD-SAFE: the transposition table is lockless with XOR-validated
// entries (Hyatt's scheme: `check = key ^ data` is stored alongside `data`;
// a torn concurrent write fails validation and reads as a miss instead of a
// silently wrong "exact" value), and the node counter is thread_local.
// ctypes releases the GIL during solver calls, so `solver_solve_batch`
// fans a pre-ordered batch of positions out over a std::thread pool — the
// relabel path's ~12k WDL probes per flagship iteration parallelize across
// host cores while still sharing one table (env/endgame.py binds it).
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include "rules.h"

namespace {

using namespace reversi;

// ---------------------------------------------------------------------------
// Transposition table: single-probe, replace-if-more-empties. Entries store
// fail-soft bounds on the exact value, so repeated probes with different
// windows tighten rather than recompute. Keyed on (mine, theirs, mode) — the
// mover-relative encoding already identifies color-swapped transpositions.
//
// Lockless layout: `data` packs (lo, hi, best, empties); `check` holds
// key ^ data. A reader accepts an entry only when check ^ data == its key,
// so any torn 2-word write is detected and treated as a miss (relaxed
// atomics are sufficient — no ordering is needed beyond per-word atomicity).
// ---------------------------------------------------------------------------
struct TTEntry {
  std::atomic<uint64_t> check;  // key ^ data; 0 = empty slot
  std::atomic<uint64_t> data;
};

// decoded entry, local to one probe
struct TTView {
  int lo, hi, best, empties;
};

inline uint64_t tt_pack(int lo, int hi, int best, int empties) {
  return (static_cast<uint64_t>(static_cast<uint16_t>(lo))) |
         (static_cast<uint64_t>(static_cast<uint16_t>(hi)) << 16) |
         (static_cast<uint64_t>(static_cast<uint8_t>(best)) << 32) |
         (static_cast<uint64_t>(static_cast<uint8_t>(empties)) << 40);
}

inline TTView tt_unpack(uint64_t d) {
  return {static_cast<int16_t>(d & 0xFFFF),
          static_cast<int16_t>((d >> 16) & 0xFFFF),
          static_cast<int8_t>((d >> 32) & 0xFF),
          static_cast<int8_t>((d >> 40) & 0xFF)};
}

constexpr int kTTLog2 = 20;  // 1M entries x 16 B = 16 MiB
constexpr uint64_t kTTMask = (1ULL << kTTLog2) - 1;
constexpr int kTTMinEmpties = 4;  // shallow nodes would churn the table

TTEntry* g_tt = nullptr;
thread_local uint64_t g_nodes = 0;
std::once_flag g_init_once;

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDULL;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ULL;
  x ^= x >> 33;
  return x;
}

inline uint64_t position_key(uint64_t mine, uint64_t theirs, int mode) {
  uint64_t h = mix64(mine + 0x9E3779B97F4A7C15ULL);
  h ^= mix64(theirs ^ 0xD1B54A32D192ED03ULL) + (h << 6) + (h >> 2);
  h ^= static_cast<uint64_t>(mode) << 1;
  return h | 1;  // never 0: 0 marks an empty slot
}

// ---------------------------------------------------------------------------
// Move ordering. Static priority: corners first, X/C squares last (standard
// Othello square values); built once at init. Above kMobilityOrderEmpties
// the solver refines this by trying moves that minimize the opponent's reply
// mobility first — the dominant ordering heuristic for Othello endgames.
// ---------------------------------------------------------------------------
constexpr int kSquareWeight[64] = {
    120, -20, 20,  5,  5, 20, -20, 120,
    -20, -40, -5, -5, -5, -5, -40, -20,
     20,  -5, 15,  3,  3, 15,  -5,  20,
      5,  -5,  3,  3,  3,  3,  -5,   5,
      5,  -5,  3,  3,  3,  3,  -5,   5,
     20,  -5, 15,  3,  3, 15,  -5,  20,
    -20, -40, -5, -5, -5, -5, -40, -20,
    120, -20, 20,  5,  5, 20, -20, 120,
};
constexpr int kMobilityOrderEmpties = 9;

// Board quadrants for parity ordering: in the endgame, playing into a region
// with an ODD number of empties tends to secure the last move there — the
// standard Othello parity heuristic, applied at quadrant granularity below
// the mobility-ordering threshold.
constexpr uint64_t kQuadrant[4] = {
    0x000000000F0F0F0FULL, 0x00000000F0F0F0F0ULL,
    0x0F0F0F0F00000000ULL, 0xF0F0F0F000000000ULL,
};

int g_square_order[64];  // square indices, best static priority first

void init_tables() {
  std::call_once(g_init_once, [] {
    g_tt = new TTEntry[kTTMask + 1]();
    for (int i = 0; i < 64; ++i) g_square_order[i] = i;
    std::stable_sort(g_square_order, g_square_order + 64,
                     [](int a, int b) {
                       return kSquareWeight[a] > kSquareWeight[b];
                     });
  });
}

// ---------------------------------------------------------------------------
// Search
// ---------------------------------------------------------------------------
inline int terminal_score(uint64_t mine, uint64_t theirs) {
  return popcount64(mine) - popcount64(theirs);
}

struct Move {
  int8_t sq;
  int16_t rank;  // lower = search first
};

// Ordered move list for `legal`: opponent-mobility (dominant endgame
// heuristic) above kMobilityOrderEmpties, quadrant parity + static square
// priority below it. Returns the move count.
int gen_ordered(uint64_t mine, uint64_t theirs, uint64_t legal, int empties,
                int mode, Move* moves) {
  int n = 0;
  if (empties >= kMobilityOrderEmpties) {
    uint64_t bb = legal;
    while (bb) {
      int sq = __builtin_ctzll(bb);
      bb &= bb - 1;
      uint64_t f = flips_bb(mine, theirs, sq, mode);
      uint64_t nm = mine | (1ULL << sq) | f;
      uint64_t nt = theirs & ~f;
      // opponent replies dominate; static weight breaks ties
      int rank = 8 * popcount64(legal_moves_bb(nt, nm, mode)) -
                 kSquareWeight[sq] / 8;
      moves[n++] = {static_cast<int8_t>(sq), static_cast<int16_t>(rank)};
    }
    std::stable_sort(moves, moves + n,
                     [](const Move& a, const Move& b) {
                       return a.rank < b.rank;
                     });
  } else {
    uint64_t empty = ~(mine | theirs);
    uint64_t odd = 0;
    for (int q = 0; q < 4; ++q) {
      if (popcount64(empty & kQuadrant[q]) & 1) odd |= kQuadrant[q];
    }
    for (int half = 0; half < 2; ++half) {
      uint64_t lm = legal & (half == 0 ? odd : ~odd);
      for (int i = 0; i < 64 && lm; ++i) {
        int sq = g_square_order[i];
        if (lm >> sq & 1) {
          moves[n++] = {static_cast<int8_t>(sq), 0};
          lm &= ~(1ULL << sq);
        }
      }
    }
  }
  return n;
}

int solve(uint64_t mine, uint64_t theirs, int alpha, int beta, int mode,
          bool passed) {
  ++g_nodes;
  uint64_t legal = legal_moves_bb(mine, theirs, mode);
  if (legal == 0) {
    if (passed) return terminal_score(mine, theirs);
    return -solve(theirs, mine, -beta, -alpha, mode, true);
  }

  const int empties = popcount64(~(mine | theirs));
  if (empties == 1) {
    // The single empty square is the legal move; the board fills — terminal.
    int sq = __builtin_ctzll(~(mine | theirs));
    uint64_t f = flips_bb(mine, theirs, sq, mode);
    return popcount64(mine | (1ULL << sq) | f) - popcount64(theirs & ~f);
  }
  const int alpha0 = alpha;

  TTEntry* entry = nullptr;
  bool hit = false;
  TTView seen{-64, 64, -1, 0};
  int tt_best = -1;
  if (empties >= kTTMinEmpties) {
    uint64_t key = position_key(mine, theirs, mode);
    entry = &g_tt[key & kTTMask];
    uint64_t check = entry->check.load(std::memory_order_relaxed);
    uint64_t data = entry->data.load(std::memory_order_relaxed);
    if (check != 0 && (check ^ data) == key) {
      hit = true;
      seen = tt_unpack(data);
      if (seen.lo >= beta) return seen.lo;
      if (seen.hi <= alpha) return seen.hi;
      if (seen.lo == seen.hi) return seen.lo;
      alpha = std::max(alpha, seen.lo);
      beta = std::min(beta, seen.hi);
      tt_best = seen.best;
    } else if (check != 0 && tt_unpack(data).empties > empties) {
      // a (validly decoded) deeper entry occupies the slot; keep it. A torn
      // entry decodes to garbage here — worst case we skip one store.
      entry = nullptr;
    }
  }

  // Build the ordered move list.
  Move moves[64];
  int n = gen_ordered(mine, theirs, legal, empties, mode, moves);
  // Try the TT's remembered best move first.
  if (tt_best >= 0) {
    for (int i = 0; i < n; ++i) {
      if (moves[i].sq == tt_best) {
        std::rotate(moves, moves + i, moves + i + 1);
        break;
      }
    }
  }

  int best = -127;
  int best_move = -1;
  for (int i = 0; i < n; ++i) {
    int sq = moves[i].sq;
    uint64_t f = flips_bb(mine, theirs, sq, mode);
    int v = -solve(theirs & ~f, mine | (1ULL << sq) | f,
                   -beta, -std::max(alpha, best), mode, false);
    if (v > best) {
      best = v;
      best_move = sq;
      if (best >= beta) break;  // fail-soft cutoff
    }
  }

  if (entry != nullptr) {
    uint64_t key = position_key(mine, theirs, mode);
    // read-modify-write on the local view; a concurrent update may be lost
    // (acceptable — the table is a cache), but never torn (XOR validation)
    int lo = hit ? seen.lo : -64;
    int hi = hit ? seen.hi : 64;
    if (best >= beta) {
      lo = std::max(lo, best);
    } else if (best <= alpha0) {
      hi = std::min(hi, best);
    } else {
      lo = hi = best;
    }
    uint64_t data = tt_pack(lo, hi, best_move, empties);
    entry->data.store(data, std::memory_order_relaxed);
    entry->check.store(key ^ data, std::memory_order_relaxed);
  }
  return best;
}

}  // namespace

extern "C" {

// Clear the transposition table (e.g. between benchmark repeats).
void solver_clear(void) {
  init_tables();
  for (uint64_t i = 0; i <= kTTMask; ++i) {
    g_tt[i].check.store(0, std::memory_order_relaxed);
    g_tt[i].data.store(0, std::memory_order_relaxed);
  }
}

// Exact value of the position within [alpha, beta], from the perspective of
// `to_move` (1 = black, 2 = white): the final disc differential
// (mover - opponent) under optimal play by both sides, clamped fail-soft to
// the window. Probing with (-1, 1) answers win/draw/loss at ~half the cost
// of a full solve.
//
// `passed` is whether the previous ply was a pass (affects only positions
// where the mover also has no move: 2 consecutive passes end the game).
// `best_move` (may be NULL) receives the optimal square 0..63, 64 if the
// mover must pass, or -1 at a terminal position. `nodes` (may be NULL)
// accumulates visited node count.
int32_t solver_solve(uint64_t black, uint64_t white, int32_t to_move,
                     int32_t mode, int32_t alpha, int32_t beta,
                     int32_t passed, int32_t* best_move, uint64_t* nodes) {
  init_tables();
  uint64_t mine = (to_move == kBlack) ? black : white;
  uint64_t theirs = (to_move == kBlack) ? white : black;
  g_nodes = 0;

  int lo = std::max(alpha, -64), hi = std::min(beta, 64);
  uint64_t legal = legal_moves_bb(mine, theirs, mode);
  int value;
  int best = -1;
  if (legal == 0) {
    if (passed || legal_moves_bb(theirs, mine, mode) == 0) {
      value = terminal_score(mine, theirs);  // game over
    } else {
      best = 64;  // forced pass
      value = -solve(theirs, mine, -hi, -lo, mode, true);
    }
  } else {
    // Root loop mirrors the inner loop but always reports the argmax move.
    value = -127;
    Move moves[64];
    int n = gen_ordered(mine, theirs, legal,
                        popcount64(~(mine | theirs)), mode, moves);
    for (int i = 0; i < n; ++i) {
      int sq = moves[i].sq;
      uint64_t f = flips_bb(mine, theirs, sq, mode);
      int v = -solve(theirs & ~f, mine | (1ULL << sq) | f,
                     -hi, -std::max(lo, value), mode, false);
      if (v > value) {
        value = v;
        best = sq;
        if (value >= hi) break;
      }
    }
  }
  if (best_move != nullptr) *best_move = best;
  if (nodes != nullptr) *nodes = g_nodes;
  return value;
}

// Solve a batch of positions within [alpha, beta] on a pool of
// `num_threads` host threads (0 = hardware concurrency), sharing the
// lockless transposition table. Positions are claimed in caller order off
// an atomic counter, so a caller that pre-sorts empties-ascending keeps the
// cheapest-first budget semantics. Once `budget_s` wall-clock seconds
// elapse (negative = unlimited; 0 = deadline already passed, solve
// nothing), remaining positions are left unsolved.
//
// `values[i]` receives the fail-soft value for solved positions;
// `solved[i]` is 1/0. `nodes` (may be NULL) receives the summed node count.
// Returns the number of positions solved. Used by the exact-value relabel
// path (selfplay.relabel_packed_np): ~12k WDL probes per flagship
// iteration fan out across cores instead of running serially.
int32_t solver_solve_batch(int32_t n, const uint64_t* black,
                           const uint64_t* white, const int32_t* to_move,
                           int32_t mode, int32_t alpha, int32_t beta,
                           double budget_s, int32_t num_threads,
                           int32_t* values, uint8_t* solved,
                           uint64_t* nodes) {
  init_tables();
  if (n <= 0) return 0;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = num_threads > 0 ? num_threads : (hw > 0 ? hw : 1);
  nt = std::min(nt, n);

  const int lo = std::max(alpha, -64), hi = std::min(beta, 64);
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> n_solved{0};
  std::atomic<uint64_t> total_nodes{0};
  const auto t0 = std::chrono::steady_clock::now();

  auto worker = [&] {
    g_nodes = 0;
    for (;;) {
      int i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n) break;
      if (budget_s >= 0) {
        std::chrono::duration<double> dt =
            std::chrono::steady_clock::now() - t0;
        if (dt.count() > budget_s) {
          solved[i] = 0;
          continue;
        }
      }
      uint64_t mine = (to_move[i] == kBlack) ? black[i] : white[i];
      uint64_t theirs = (to_move[i] == kBlack) ? white[i] : black[i];
      uint64_t legal = legal_moves_bb(mine, theirs, mode);
      int value;
      if (legal == 0) {
        if (legal_moves_bb(theirs, mine, mode) == 0) {
          value = terminal_score(mine, theirs);
        } else {
          value = -solve(theirs, mine, -hi, -lo, mode, true);
        }
      } else {
        value = solve(mine, theirs, lo, hi, mode, false);
      }
      values[i] = value;
      solved[i] = 1;
      n_solved.fetch_add(1, std::memory_order_relaxed);
    }
    total_nodes.fetch_add(g_nodes, std::memory_order_relaxed);
  };

  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  if (nodes != nullptr) *nodes = total_nodes.load(std::memory_order_relaxed);
  return n_solved.load(std::memory_order_relaxed);
}

}  // extern "C"
