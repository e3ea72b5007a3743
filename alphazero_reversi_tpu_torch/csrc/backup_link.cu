// Fused MCTS backup + child link, in place on the packed stats array.
//
// Replaces the TPU kernel `_backup_kernel` / `backup_and_link_tpu` in
// alphazero_reversi_tpu/mcts/pallas_backup.py (called from
// alphazero_reversi_tpu/mcts/tree.py `backup_and_link`). One device routine,
// `backup_game`, does one game's update; two entry points feed it:
//
// * azr_backup_link: the JAX function's interface in its [B, L] link form.
//     for p in 0..P-1 (path entries, in order), if nodes[g,p] >= 0:
//       stats[g, node*130 + a]      += pack        (one visit)
//       stats[g, node*130 + 65 + a] += value_inc   (value sum)
//     for l in 0..L-1 (links, in order), if do_link[g,l]:
//       stats[g, lnode*130 + laction] += (float)slot   (child link)
// * azr_round_backup: the whole tail of a simulation round after the
//   expansion write (the port's mcts/search.py `expand_and_backup`; JAX
//   search.py:167-193). It derives the above from the round's own arrays:
//   path entry j belongs to descent l = j / levels and adds
//   value_inc = (pt[j] == eval_tomove[l] ? 1 : -1) * value[l]; lane l links
//   leaf l at action max(leaf_act, 0) to slot slot0 + l when leaf_act >= 0
//   and no earlier lane has the same (leaf, leaf_act); then
//   root_visit += L and root_vsum += sum_l (eval_tomove[l] == root_to_move
//   ? 1 : -1) * value[l], summed over l in order. Indices are read as int64
//   and cut to int32, as the plain version's casts cut them.
//
// An update whose flat index falls outside [0, N*130) is dropped, as the
// JAX scatter's mode="drop" drops it.
//
// Add order. The plain version (`backup_and_link_reference`, a scatter_add_
// over the concatenated [visits | vsums | links] index) adds each cell's
// increments in that order: visits by path entry, then value sums by path
// entry, then links. The kernel keeps it bit for bit. One warp owns a game.
// Lanes whose updates hit the same cell find each other with
// __match_any_sync; the group's lowest lane loads the cell once, adds the
// members' increments in ascending entry order and stores it once.
//
// * One step (the flagship's case): when the game has at most 32 path
//   entries and 32 links and every live action lies in [0, 65), a visit or
//   link cell is never a value-sum cell. Lane j then holds path entry j and
//   link j; a visit group's leader adds the visits, then every link that
//   hits its cell, and updates the value-sum cell beside it; links that hit
//   no visited cell group among themselves. A game costs one round trip
//   for its arguments and one read-modify-write round trip for its cells.
// * Otherwise, steps of at most 32 updates in the plain order, separated by
//   __syncwarp(): path entries in chunks of 32 (visit and value-sum cell in
//   one step when all actions lie in [0, 65), else visits first, then value
//   sums), then links.
//
// What bounds it on an H100: a flagship round (B=1024, P=24, L=1) reads
// about 0.5 MB of indices and values and touches about 0.2 MB of scattered
// 4-byte cells: about 0.2 us at 3.35 TB/s. There is no dense tile, so no
// shared-memory tiling, TMA or wgmma; the 17.6 MB stats array of the
// flagship's last stage fits the 50 MB L2. What is left is the launch
// latency plus the dependent round trips, so the kernel spreads games over
// all 132 SMs (4 warps, one game each, per block: 256 blocks at B=1024),
// keeps a game to two round trips, and takes the round's eager index
// arithmetic into the same launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kActions = 65;
constexpr int kStride = 2 * kActions;
constexpr int kWarp = 32;
constexpr int kWarps = 4;  // games per block
constexpr int kThreads = kWarps * kWarp;
constexpr unsigned kFull = 0xffffffffu;

struct PathEntry {
  int node;  // < 0: padding, skipped
  int action;
  float inc;  // value-sum increment
};

struct LinkEntry {
  bool live;
  int node;
  int action;
  float slot;
};

__device__ __forceinline__ PathEntry no_path() { return {-1, 0, 0.0f}; }
__device__ __forceinline__ LinkEntry no_link() { return {false, 0, 0, 0.0f}; }

// A warp's shared scratch: one value per lane.
struct Scratch {
  float inc[kWarp];
  float inc2[kWarp];
  int cell[kWarp];
  int link[kWarp];
};

__device__ __forceinline__ bool in_row(int64_t cell, int cells) {
  return cell >= 0 && cell < cells;
}

__device__ __forceinline__ bool plain_action(int action) {
  return action >= 0 && action < kActions;
}

// One ordered step of a warp over its game's row. Each lane holds at most
// one update: `inc` at `cell` and, when `paired`, `inc2` at cell + 65.
// Lanes with equal cells form a group; its lowest lane adds the members'
// increments in ascending lane order and stores once. The second
// __syncwarp() orders this step's stores before the next step's loads.
__device__ __forceinline__ void scatter_step(float* row, bool live, int cell,
                                             float inc, float inc2, bool paired,
                                             Scratch& s, int lane) {
  s.inc[lane] = inc;
  s.inc2[lane] = inc2;
  __syncwarp();
  const unsigned group = __match_any_sync(kFull, live ? cell : -1);
  if (live && lane == __ffs(group) - 1) {
    float x = row[cell];
    float y = paired ? row[cell + kActions] : 0.0f;
    for (unsigned m = group; m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      x += s.inc[src];
      if (paired) y += s.inc2[src];
    }
    row[cell] = x;
    if (paired) row[cell + kActions] = y;
  }
  __syncwarp();
}

// The one-step case: lane j holds path entry e (j < paths) and link k
// (j < links); every live action lies in [0, 65).
__device__ __forceinline__ void single_step(float* row, int cells, const PathEntry& e,
                                            const LinkEntry& k, int paths, int links,
                                            float pack, Scratch& s, int lane) {
  const int64_t vis = static_cast<int64_t>(e.node) * kStride + e.action;
  const int64_t lcell = static_cast<int64_t>(k.node) * kStride + k.action;
  const bool visit = e.node >= 0 && in_row(vis, cells);  // then vis + 65 is too
  const bool link = k.live && in_row(lcell, cells);
  s.cell[lane] = visit ? static_cast<int>(vis) : -1;
  s.link[lane] = link ? static_cast<int>(lcell) : -1;
  s.inc[lane] = e.inc;
  s.inc2[lane] = k.slot;
  __syncwarp();
  bool lone = link;  // a link whose cell no visit hits
  for (int j = 0; j < paths; ++j) lone = lone && s.cell[j] != s.link[lane];
  const unsigned visits = __match_any_sync(kFull, visit ? s.cell[lane] : -1);
  const unsigned lones = __match_any_sync(kFull, lone ? s.link[lane] : -1);
  if (visit && lane == __ffs(visits) - 1) {
    float x = row[vis];
    float y = row[vis + kActions];
    for (unsigned m = visits; m; m &= m - 1) {
      x += pack;
      y += s.inc[__ffs(m) - 1];
    }
    for (int l = 0; l < links; ++l) {
      if (s.link[l] == s.cell[lane]) x += s.inc2[l];
    }
    row[vis] = x;
    row[vis + kActions] = y;
  }
  if (lone && lane == __ffs(lones) - 1) {
    float z = row[lcell];
    for (unsigned m = lones; m; m &= m - 1) z += s.inc2[__ffs(m) - 1];
    row[lcell] = z;
  }
}

// The whole backup + link of one game; called by every lane of its warp.
// `Game` supplies path(j) for j < paths and link(l) for l < links.
template <class Game>
__device__ void backup_game(float* row, int cells, const Game& game, int paths,
                            int links, float pack, Scratch& s, int lane) {
  if (paths <= kWarp && links <= kWarp) {
    const PathEntry e = lane < paths ? game.path(lane) : no_path();
    const LinkEntry k = lane < links ? game.link(lane) : no_link();
    if (__all_sync(kFull, (e.node < 0 || plain_action(e.action)) &&
                              (!k.live || plain_action(k.action)))) {
      single_step(row, cells, e, k, paths, links, pack, s, lane);
      return;
    }
  }
  bool paired = true;
  for (int base = 0; base < paths; base += kWarp) {
    const int j = base + lane;
    const PathEntry e = j < paths ? game.path(j) : no_path();
    paired &= __all_sync(kFull, e.node < 0 || plain_action(e.action));
  }
  for (int half = 0; half < (paired ? 1 : 2); ++half) {
    for (int base = 0; base < paths; base += kWarp) {
      const int j = base + lane;
      const PathEntry e = j < paths ? game.path(j) : no_path();
      const int64_t vis = static_cast<int64_t>(e.node) * kStride + e.action;
      if (paired) {  // vis in the row <=> vis + 65 in the row
        scatter_step(row, e.node >= 0 && in_row(vis, cells), static_cast<int>(vis),
                     pack, e.inc, true, s, lane);
      } else {
        const int64_t cell = vis + half * kActions;
        scatter_step(row, e.node >= 0 && in_row(cell, cells), static_cast<int>(cell),
                     half ? e.inc : pack, 0.0f, false, s, lane);
      }
    }
  }
  for (int base = 0; base < links; base += kWarp) {
    const int l = base + lane;
    const LinkEntry k = l < links ? game.link(l) : no_link();
    const int64_t cell = static_cast<int64_t>(k.node) * kStride + k.action;
    scatter_step(row, k.live && in_row(cell, cells), static_cast<int>(cell), k.slot,
                 0.0f, false, s, lane);
  }
}

// azr_backup_link's arguments for one game: the TPU kernel's interface.
struct LinkForm {
  const int32_t* nodes;
  const int32_t* actions;
  const float* incs;
  const int32_t* link_nodes;
  const int32_t* link_actions;
  const int32_t* link_slots;
  const uint8_t* do_link;

  __device__ PathEntry path(int j) const { return {nodes[j], actions[j], incs[j]}; }
  __device__ LinkEntry link(int l) const {
    return {do_link[l] != 0, link_nodes[l], link_actions[l],
            static_cast<float>(link_slots[l])};
  }
};

// azr_round_backup's arguments for one game: a simulation round's arrays.
struct RoundForm {
  const int64_t* pn;
  const int64_t* pa;
  const float* pt;
  const int32_t* eval_tomove;
  const float* value;
  const int64_t* leaves;
  const int64_t* leaf_acts;
  int levels;
  int slot0;

  __device__ PathEntry path(int j) const {
    const int l = j / levels;
    const float sign = pt[j] == static_cast<float>(eval_tomove[l]) ? 1.0f : -1.0f;
    return {static_cast<int32_t>(pn[j]), static_cast<int32_t>(pa[j]), sign * value[l]};
  }
  __device__ LinkEntry link(int l) const {
    const int64_t leaf = leaves[l];
    const int64_t act = leaf_acts[l];
    bool dup = false;  // an earlier lane picked the same edge: link once
    for (int k = 0; k < l; ++k) dup |= (leaves[k] == leaf) & (leaf_acts[k] == act);
    return {act >= 0 && !dup, static_cast<int32_t>(leaf), static_cast<int32_t>(act > 0 ? act : 0),
            static_cast<float>(static_cast<int32_t>(slot0 + l))};
  }
};

__global__ void __launch_bounds__(kThreads)
    backup_link_kernel(float* stats, int cells, LinkForm form, int paths,
                       int links, int batch, float pack) {
  __shared__ Scratch scratch[kWarps];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= batch) return;  // warp-uniform
  const int64_t p0 = static_cast<int64_t>(g) * paths;
  const int64_t l0 = static_cast<int64_t>(g) * links;
  const LinkForm game{form.nodes + p0,        form.actions + p0,     form.incs + p0,
                      form.link_nodes + l0,   form.link_actions + l0,
                      form.link_slots + l0,   form.do_link + l0};
  backup_game(stats + static_cast<int64_t>(g) * cells, cells, game, paths, links, pack,
              scratch[warp], lane);
}

__global__ void __launch_bounds__(kThreads)
    round_backup_link_kernel(float* stats, int cells, RoundForm form,
                             int paths, int links, const int32_t* __restrict__ root_to_move,
                             int32_t* __restrict__ root_visit,
                             float* __restrict__ root_vsum, int batch, float pack) {
  __shared__ Scratch scratch[kWarps];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= batch) return;  // warp-uniform
  const int64_t p0 = static_cast<int64_t>(g) * paths;
  const int64_t l0 = static_cast<int64_t>(g) * links;
  const RoundForm game{form.pn + p0,          form.pa + p0,          form.pt + p0,
                       form.eval_tomove + l0, form.value + l0,       form.leaves + l0,
                       form.leaf_acts + l0,   form.levels,           form.slot0};
  // Root totals, by lane 0: its loads are issued first and used last, so
  // their latency hides behind the backup's.
  int32_t to_move = 0, visit = 0;
  float vsum = 0.0f;
  if (lane == 0) {
    to_move = root_to_move[g];
    visit = root_visit[g];
    vsum = root_vsum[g];
  }
  backup_game(stats + static_cast<int64_t>(g) * cells, cells, game, paths, links, pack,
              scratch[warp], lane);
  if (lane == 0) {  // the lanes' values summed in order, then one add
    float sum = 0.0f;
    for (int l = 0; l < links; ++l) {
      sum += (game.eval_tomove[l] == to_move ? 1.0f : -1.0f) * game.value[l];
    }
    root_vsum[g] = vsum + sum;
    root_visit[g] = visit + links;
  }
}

int blocks_for(int batch) { return (batch + kWarps - 1) / kWarps; }

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError() as an int: 0 means the launch was accepted.
extern "C" int azr_backup_link(void* stats, int cells, const void* nodes,
                               const void* actions, const void* incs, int paths,
                               const void* link_nodes, const void* link_actions,
                               const void* link_slots, const void* do_link, int links,
                               int batch, float pack, void* stream) {
  if (batch > 0) {
    const LinkForm form{static_cast<const int32_t*>(nodes),
                        static_cast<const int32_t*>(actions),
                        static_cast<const float*>(incs),
                        static_cast<const int32_t*>(link_nodes),
                        static_cast<const int32_t*>(link_actions),
                        static_cast<const int32_t*>(link_slots),
                        static_cast<const uint8_t*>(do_link)};
    backup_link_kernel<<<blocks_for(batch), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(stats), cells, form, paths, links, batch, pack);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int azr_round_backup(void* stats, int cells, const void* pn, const void* pa,
                                const void* pt, int paths, const void* eval_tomove,
                                const void* value, const void* leaves,
                                const void* leaf_acts, int links, int slot0,
                                const void* root_to_move, void* root_visit,
                                void* root_vsum, int batch, float pack, void* stream) {
  if (batch > 0) {
    const RoundForm form{static_cast<const int64_t*>(pn),
                         static_cast<const int64_t*>(pa),
                         static_cast<const float*>(pt),
                         static_cast<const int32_t*>(eval_tomove),
                         static_cast<const float*>(value),
                         static_cast<const int64_t*>(leaves),
                         static_cast<const int64_t*>(leaf_acts),
                         paths / links,
                         slot0};
    round_backup_link_kernel<<<blocks_for(batch), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(stats), cells, form, paths, links,
        static_cast<const int32_t*>(root_to_move), static_cast<int32_t*>(root_visit),
        static_cast<float*>(root_vsum), batch, pack);
  }
  return static_cast<int>(cudaGetLastError());
}
