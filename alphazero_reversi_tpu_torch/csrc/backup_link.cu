// Fused MCTS backup + child link, in place on the packed stats array.
//
// Replaces the TPU kernel `_backup_kernel` / `backup_and_link_tpu` in
// alphazero_reversi_tpu/mcts/pallas_backup.py (called from
// alphazero_reversi_tpu/mcts/tree.py `backup_and_link`). It computes the
// JAX function, in its [B, L] multi-leaf link form, not the Pallas blocking:
//
//   for each game g (one thread per game):
//     for p in 0..P-1 (path entries, in order), if nodes[g,p] >= 0:
//       stats[g, node*130 + a]      += pack        (one visit)
//       stats[g, node*130 + 65 + a] += value_inc   (value sum)
//     for l in 0..L-1 (links, in order), if do_link[g,l]:
//       stats[g, lnode*130 + laction] += (float)slot   (child link)
//
// An update whose flat index falls outside [0, N*130) is dropped, as the
// JAX scatter's mode="drop" drops it.
//
// Add order. A thread owns its game's row, so there are no atomics and the
// order is fixed: path entries in order, then links in order. With L = 1 a
// descent visits each (node, action) at most once, so no vsum cell is hit
// twice. With L > 1 descents may share edges: a colliding vsum cell gets
// its increments in path-entry order (descent 0's levels first), and a
// packed cell gets all its +pack visits before its link. The plain version
// (`backup_and_link_reference`, a scatter_add_ over the concatenated
// [visits | vsums | links] index) adds in the same per-cell order, so the
// two agree bit for bit; packed cells hold exact small integers anyway.
//
// What bounds it on an H100: at the flagship shape (B=1024, P=24, L=1) a
// call reads about 0.3 MB of indices and increments and touches at most
// 49 cells per game, about 0.5 MB in all: about 0.15 us at 3.35 TB/s. The
// call therefore costs its launch latency (a few us), not bytes or FLOPs.
// Making it cheaper means fewer launches: fusing it into the rest of the
// simulation round, or capturing the round in a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kActions = 65;
constexpr int kStride = 2 * kActions;
constexpr int kThreads = 128;

__global__ void backup_link_kernel(float* __restrict__ stats, int64_t cells,
                                   const int32_t* __restrict__ nodes,
                                   const int32_t* __restrict__ actions,
                                   const float* __restrict__ incs, int paths,
                                   const int32_t* __restrict__ link_nodes,
                                   const int32_t* __restrict__ link_actions,
                                   const int32_t* __restrict__ link_slots,
                                   const uint8_t* __restrict__ do_link,
                                   int links, int batch, float pack) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= batch) return;
  float* row = stats + static_cast<int64_t>(g) * cells;
  const int64_t pbase = static_cast<int64_t>(g) * paths;
  for (int p = 0; p < paths; ++p) {
    const int node = nodes[pbase + p];
    if (node < 0) continue;
    const int64_t vis = static_cast<int64_t>(node) * kStride + actions[pbase + p];
    if (vis >= 0 && vis < cells) row[vis] += pack;
    const int64_t val = vis + kActions;
    if (val >= 0 && val < cells) row[val] += incs[pbase + p];
  }
  const int64_t lbase = static_cast<int64_t>(g) * links;
  for (int l = 0; l < links; ++l) {
    if (!do_link[lbase + l]) continue;
    const int64_t cell =
        static_cast<int64_t>(link_nodes[lbase + l]) * kStride + link_actions[lbase + l];
    if (cell >= 0 && cell < cells) row[cell] += static_cast<float>(link_slots[lbase + l]);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() as an int: 0 means the launch was accepted.
extern "C" int azr_backup_link(void* stats, int64_t cells, const void* nodes,
                               const void* actions, const void* incs, int paths,
                               const void* link_nodes, const void* link_actions,
                               const void* link_slots, const void* do_link,
                               int links, int batch, float pack, void* stream) {
  if (batch > 0) {
    const int blocks = (batch + kThreads - 1) / kThreads;
    backup_link_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(stats), cells, static_cast<const int32_t*>(nodes),
        static_cast<const int32_t*>(actions), static_cast<const float*>(incs), paths,
        static_cast<const int32_t*>(link_nodes), static_cast<const int32_t*>(link_actions),
        static_cast<const int32_t*>(link_slots), static_cast<const uint8_t*>(do_link),
        links, batch, pack);
  }
  return static_cast<int>(cudaGetLastError());
}
