// ELL sparse matrix-vector products for Hopper (sm_90a), y = A x for a
// square or rectangular matrix of n rows, f32 and f64, in two layouts.
//
// Both replace the Pallas TPU kernel
// amgx_tpu/ops/pallas_well.py::_well_kernel.  That kernel cut rows into
// 1024-row tiles, interleaved the slots across the (8, 128) lanes and
// gathered from one x window per tile, only to bound the cost of a TPU
// lane gather.  A GPU gathers per thread, so none of that is carried
// over.
//
// What bounds both on an H100: bytes.  A call must read the stored
// column ids and values once, x once and write y once; it does 2 flops
// per stored entry.
//
// 1. ell_spmv: slot-major ELL,
//
//        y[i] = sum_s vals[s * n + i] * x[cols[s * n + i]]  (0 <= i < n)
//
//    with every row padded to the matrix-wide width w (padding slots
//    hold column 0 and value 0).  It serves matrices whose rows all
//    need that width, the aggregation transfers (P at w = 1, R at w = 2
//    and 8): n * w * 8 + 4 * n + 4 * n_cols bytes in f32, about 26 MB
//    (7.8 us at 3.35 TB/s) for the SIZE_8 P or R of a 2,097,152-row
//    level.  One thread per row (grid-stride); a warp's loads of one
//    slot are coalesced; x is gathered through the read-only path
//    (__ldg); the sum starts from +0.0 and runs in slot order, as the
//    plain version (ops/ell.py:ell_spmv_plain) does; s * n + i is
//    computed in 64-bit.
//
// 2. sell_spmv: sliced, row-sorted ELL (SELL-C-sigma, C = 32), for
//    matrices whose row lengths vary (the classical AMG operators: the
//    level-1 A of a 128^3 Poisson hierarchy has 37 slots for 18.4
//    stored entries a row, the level-0 P 6 for 2.15).  Rows are sorted
//    by length within windows of sigma rows and cut into slices of 32;
//    slice k stores widths[k] slots slot-major from offsets[k], so the
//    entry of slot s of lane l lies at offsets[k] + 32 s + l.  Its bound
//    is the stored entries (8 bytes each in f32, 12 in f64) plus x, y,
//    the 4-byte row permutation (when sigma > 1) and 12 bytes of slice
//    header per 32 rows.  What each design choice does about that:
//      * a slice is padded only to its own longest row, and sorting
//        puts rows of like length in one slice, so the bytes read
//        approach the stored entries';
//      * a warp walks one slice (lanes = rows) up to the slice's width
//        only: each load of one slot is one 128-byte line (f32 values);
//      * small levels: with `lanes` L > 1 (fixed per matrix at upload
//        from its slice count), L lanes share a row, each summing a
//        fixed contiguous range of ceil(width / L) slots, and a fixed
//        xor-shuffle tree adds the L parts.  This splits each row's
//        serial chain of gathers and gives a level of a few hundred
//        slices (the level-3 A has 739) L times the warps.  A warp then
//        covers 32 / L rows, so one load reads 32 / L neighbouring
//        entries: on a large level that costs more than it gains, and
//        the plan keeps L = 1 there;
//      * column ids and values are used once: loaded with __ldcs
//        (evict-first), so they do not push x out of L1 and L2; x is
//        gathered through the read-only path (__ldg);
//      * eight slots are loaded (predicated past the row part's end)
//        before their eight gathers are issued, so a warp keeps sixteen
//        streaming loads, then eight gathers, in flight, and a slice up
//        to eight wide takes one step;
//      * a warp walks (slice, part group) items grid-stride over a grid
//        of at most as many blocks as are resident on the card at once
//        (fewer on a small level: every item gets its own warp), and
//        loads the next item's offset, width and output row while it
//        works on the current one, so those loads add no latency;
//      * each y is written once, at y[rows[p]], with no atomics: a part
//        sums its slots in slot order from +0.0 (one FMA each) and the
//        tree's order is fixed, so results repeat bit for bit; with
//        L = 1 the sum is the slot-major kernel's, bit for bit;
//      * offsets are 64-bit.
//
// Dtypes (dtypes.cuh): f32 and f64 with one FMA a slot, as above; and
// the pairs a reduced-precision hierarchy (hierarchy_dtype) feeds them,
// each term rounded as the plain version's torch operations round, so
// that a kernel summing in the plain order returns its bits:
//   * ell_spmv (bf16, bf16) -> bf16: the transfers of a bf16 hierarchy;
//     (bf16, f32) -> f32: a bf16 restriction of an f32 residual (level 0
//     under level_dtype_policy COARSE); (f32, f64) -> f64: the same with
//     hierarchy_dtype FLOAT32 on an f64 operator;
//   * sell_spmv (bf16, bf16) -> bf16: the classical operators of a bf16
//     hierarchy, with one lane a row only (SparseMatrix.astype sets the
//     plan): the tree of L > 1 lanes would add the parts, each sum
//     rounded to bf16, in another order than the plain version's;
//     (f32, f64) -> f64 and (bf16, f32) -> f32: an unstructured matrix
//     in the C API's mixed modes (dDFI / dIFI, dFBI), each term rounded
//     in the wider type.  With one lane a row (always for bf16 values)
//     they return the plain version's bits; with L > 1 the tree adds the
//     parts in another order, within a tolerance.
// A bf16 value moves 2 bytes (a slot 6, column id included).
//   * every kernel, batched ones included, in the complex modes: c64 and
//     c128 values with x of their type (dCCI, dZZI), c64 values with c128
//     x (dZCI), each term dtypes.cuh's complex rule; a complex element is
//     one 8- or 16-byte load.
//
// Batched entry points, for the serve layer's groups of same-pattern
// systems (amgx_tpu_torch/serve): the TPU package's _well_kernel under
// jax.vmap (amgx_tpu/serve/batched.py).  B instances of one structure,
// its values (B, stored) or one set shared by every instance (a batch
// stride of 0: the AMG transfers, whose setup-time weights every
// instance keeps), x (B, m) and y (B, n).  Bound: bytes, the shared
// structure once, the values once or B times, x and y B times.
//
// 3. ell_spmv_batched_f32 / _f64: slot-major, cols (w, n) shared.  The
//    batch is the grid's y axis and each instance runs the unbatched
//    kernel's loop on its own rows, so its y is ell_spmv's bit for bit.
//    It serves matrices with no sliced layout (the SIZE_8 transfers,
//    whose rows all need the width).
//
// 4. sell_spmv_batched_f32 / _f64: sliced, for every matrix that has
//    the sliced layout (the padded templates of irregular patterns,
//    whose bucket filler makes the widest row about twice the mean:
//    the slot-major arrays of a 262,144-row template store 7,864,320
//    slots, the sliced ones 4,604,736).  Its bound is the values'
//    stream (B x 4,604,736 slots there); beside it, a gather of x_b[c]
//    reads one 32-byte sector for 4 or 8 bytes, so B instances gathered
//    one by one from x (B, m) cost more than the stream itself
//    (PERF.md, section 6).  So:
//      * x is first copied instance-minor, in tiles of T instances
//        (batch_tiles_kernel, through shared memory: one read and one
//        write of x), and the gather of column c for a tile is one run
//        of T values (16-byte vector loads): the sectors it reads are
//        all used;
//      * a warp takes a (slice, part group) item as sell_spmv does and
//        one tile, each lane summing its row for all T instances: the
//        item's header and column ids are loaded once for T instances;
//      * K slots a step: the next step's column ids, the T instances'
//        values (__ldcs, evict-first, a coalesced run an instance; once
//        for the tile where the values are shared) and the K runs of x
//        are loaded before any FMA;
//      * each instance sums its slots in slot order from +0.0, one FMA
//        each, and adds its parts with sell_spmv's xor tree, so its y
//        is sell_spmv's with the same plan bit for bit (a slot past a
//        part's end adds 0 * 0, which leaves a sum that starts at +0.0
//        as it is, so K need not be sell_spmv's eight);
//      * the tiles run in groups whose part of the copy of x fits
//        8 MB of the L2, one group after another, so the gathers in
//        flight keep hitting L2; within a group the tiles of an item run
//        side by side;
//      * y is stored evict-first (__stcs), so it does not push the copy
//        of x out of L2;
//      * T = 4 and K = 4 (kSellTile, kSellStep: the fastest in f64 of
//        the shapes measured, PERF.md section 6; T divides 16, and the
//        scratch copy of x holds the batch rounded up to 16);
//      * the grid is persistent (at most the resident blocks), each warp
//        walking work indices grid-stride and loading the next one's
//        header ahead.
//    A gather product has no dense tile for wgmma and no regular tile
//    for TMA to copy.
//
// Plain C interface, loaded with ctypes (amgx_tpu_torch/ops/kernels.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

using namespace spmv_types;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

// V: values, X: x, Y: y, K: how a term rounds (dtypes.cuh)
template <typename V, typename X, typename Y, int K>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const int* __restrict__ cols, const V* __restrict__ vals,
                int w, const X* __restrict__ x, Y* __restrict__ y,
                int64_t n, int64_t m, int64_t vstride) {
  using C = typename Compute<Y>::type;
  // instance blockIdx.y of a batch (0 unbatched): its values start
  // vstride in (0: shared), its x m and its y n values in
  vals += static_cast<int64_t>(blockIdx.y) * vstride;
  x += static_cast<int64_t>(blockIdx.y) * m;
  y += static_cast<int64_t>(blockIdx.y) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    C acc = C(0);
    for (int s = 0; s < w; ++s) {
      const int64_t e = static_cast<int64_t>(s) * n + i;
      acc = Term<K>::f(acc, C(ldg_c(vals + e)),
                       C(ldg_c(x + __ldg(cols + e))));
    }
    store_y(y + i, acc);
  }
}

// one warp per (slice, group) item; lane = r * L + p holds row r of the
// group's 32 / L rows and part p of the slice's slots.  A warp walks
// items grid-stride and loads the next item's header (offset, width)
// and output row while it works on the current one, so a narrow slice
// costs two dependent loads (entries, then x), not four.
template <typename V, typename X, int K, int L>
__global__ void __launch_bounds__(kThreads)
sell_spmv_kernel(const int* __restrict__ cols, const V* __restrict__ vals,
                 const int64_t* __restrict__ offsets,
                 const int* __restrict__ widths,
                 const int* __restrict__ rows, int64_t n_items,
                 const X* __restrict__ x, X* __restrict__ y, int64_t n) {
  using C = typename Compute<X>::type;
  constexpr int kRows = 32 / L;
  constexpr int kBatch = 8;
  const int lane = threadIdx.x & 31;
  const int part = lane % L;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  int64_t item = (static_cast<int64_t>(blockIdx.x) * kThreads +
                  threadIdx.x) >> 5;
  if (item >= n_items) return;  // the whole warp
  // header of an item: entry offset of this lane's row, slice width and
  // the y index it writes (-1: a padding row past n)
  int64_t at, at_next = 0, dst, dst_next = -1;
  int w, w_next = 0;
  auto header = [&](int64_t it, int64_t& a, int& wd, int64_t& d) {
    const int64_t k = it / L;
    const int in_slice = static_cast<int>(it % L) * kRows + lane / L;
    const int64_t p = k * 32 + in_slice;
    a = offsets[k] + in_slice;
    wd = widths[k];
    d = p < n ? (rows != nullptr ? static_cast<int64_t>(rows[p]) : p) : -1;
  };
  header(item, at, w, dst);
  for (;;) {
    const int64_t next = item + warps;
    if (next < n_items) header(next, at_next, w_next, dst_next);
    const int chunk = (w + L - 1) / L;
    const int s_end = min(w, (part + 1) * chunk);
    C acc = C(0);
    if (dst >= 0) {
      // kBatch slots a step: all their entries are loaded (slots past
      // the part's end as column -1, value 0) before their gathers; the
      // FMAs run in slot order, and a slot past the end adds +0.0
      for (int s = part * chunk; s < s_end; s += kBatch) {
        int c[kBatch];
        C v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int64_t e = at + static_cast<int64_t>(s + u) * 32;
          const bool live = s + u < s_end;
          c[u] = live ? __ldcs(cols + e) : -1;
          v[u] = live ? C(ldcs_c(vals + e)) : C(0);
        }
        C xv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          xv[u] = c[u] >= 0 ? C(ldg_c(x + c[u])) : C(0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) acc = Term<K>::f(acc, v[u], xv[u]);
      }
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      acc = Term<K>::add(acc, shfl_xor(acc, o));
    }
    if (part == 0 && dst >= 0) store_y(y + dst, acc);
    if (next >= n_items) break;
    item = next;
    at = at_next;
    w = w_next;
    dst = dst_next;
  }
}

// sell_spmv_batched: instances a tile (T, a lane sums all of them) and
// slots a step (K)
constexpr int kSellTile = 4;
constexpr int kSellStep = 4;
// the bytes of xt that the tiles in flight at once gather from: a group
// of tiles shares that budget
constexpr long long kSellXBudget = 8LL << 20;
// the most instances a tile: the scratch copy of x holds the batch
// rounded up to a multiple of it
constexpr int kMaxTile = 16;
// values of x a block of the copy moves at once (8 a thread)
constexpr int kCopyChunk = 2048;

// T values of xt through the read-only path as 16-byte vectors (8 bytes
// for two f32 values; one c128 value a vector)
template <int T>
__device__ __forceinline__ void ldg_run(const double* p, double (&o)[T]) {
  static_assert(T % 2 == 0, "f64 runs load two values a vector");
#pragma unroll
  for (int j = 0; j < T; j += 2) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p + j));
    o[j] = v.x;
    o[j + 1] = v.y;
  }
}
template <int T>
__device__ __forceinline__ void ldg_run(const c128* p, c128 (&o)[T]) {
#pragma unroll
  for (int j = 0; j < T; ++j) o[j] = ld_ro(p + j);
}
template <int T>
__device__ __forceinline__ void ldg_run(const c64* p, c64 (&o)[T]) {
  static_assert(T % 2 == 0, "c64 runs load two values a vector");
#pragma unroll
  for (int j = 0; j < T; j += 2) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
    o[j] = c64(v.x, v.y);
    o[j + 1] = c64(v.z, v.w);
  }
}
template <int T>
__device__ __forceinline__ void ldg_run(const float* p, float (&o)[T]) {
  static_assert(T % 2 == 0, "f32 runs load two or four values a vector");
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int j = 0; j < T; j += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
      o[j] = v.x;
      o[j + 1] = v.y;
      o[j + 2] = v.z;
      o[j + 3] = v.w;
    }
  } else {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  }
}

// x (batch, m) into its instance-minor copy xt (tiles, m, T): xt[(q m +
// c) T + j] = x[q T + j][c], 0 past the batch.  A block takes a chunk of
// kCopyChunk / T columns of one tile through shared memory, so that
// both its reads (a run of columns an instance, evict-first: x is read
// once) and its writes (one run of the chunk's T-value columns) are
// whole lines
template <typename V>
__global__ void __launch_bounds__(kThreads)
batch_tiles_kernel(const V* __restrict__ x, V* __restrict__ xt, int64_t m,
                   int batch, int tile, int64_t chunks) {
  __shared__ V buf[kCopyChunk + kMaxTile];
  const int width = kCopyChunk / tile;  // columns a chunk
  const int64_t per_tile = (m + width - 1) / width;
  for (int64_t ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const int q = static_cast<int>(ch / per_tile);
    const int64_t c0 = (ch - static_cast<int64_t>(q) * per_tile) * width;
    for (int i = threadIdx.x; i < kCopyChunk; i += blockDim.x) {
      const int j = i / width;
      const int64_t c = c0 + (i - j * width);
      const int b = q * tile + j;
      buf[j * (width + 1) + (i - j * width)] =
          b < batch && c < m ? ld_cs(x + static_cast<int64_t>(b) * m + c)
                             : V(0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kCopyChunk; i += blockDim.x) {
      const int cc = i / tile;
      const int j = i - cc * tile;
      if (c0 + cc < m) {
        xt[(static_cast<int64_t>(q) * m + c0) * tile + i] =
            buf[j * (width + 1) + cc];
      }
    }
    __syncthreads();
  }
}

// sell_spmv_kernel's (slice, part group) items, each for the T instances
// q T .. q T + T - 1 of a tile q (those past `batch` store nothing); lane
// = r L + p holds row r of the item's 32 / L rows and part p of its
// slots, for all T instances, so a gather of column c is one run of T
// values of xt.  The tiles go in groups of `group`, one group after
// another: within one, work index f is item f / g, tile f % g (g the
// group's tiles), so the tiles of one item run side by side and read its
// column ids from L1 (evict-first where a group is one tile: nothing
// reads them again soon), and the gathers in flight stay within the
// group's part of xt.  Instance b's values start b * vstride in (Shared:
// one set), its y b * n.
template <typename V, int L, int T, int K, bool Shared>
__global__ void __launch_bounds__(kThreads)
sell_spmv_batched_kernel(const int* __restrict__ cols,
                         const V* __restrict__ vals,
                         const int64_t* __restrict__ offsets,
                         const int* __restrict__ widths,
                         const int* __restrict__ rows, int64_t n_slices,
                         int tiles, int group, const V* __restrict__ xt,
                         V* __restrict__ y, int64_t n, int64_t m,
                         int64_t vstride, int batch) {
  using C = typename Compute<V>::type;
  constexpr int kRows = 32 / L;
  const int lane = threadIdx.x & 31;
  const int part = lane % L;
  const int64_t items = n_slices * L;
  const int64_t n_work = items * tiles;
  const int64_t per_group = items * group;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  int64_t f = (static_cast<int64_t>(blockIdx.x) * kThreads +
               threadIdx.x) >> 5;
  if (f >= n_work) return;  // the whole warp
  // header of a work index: entry offset of this lane's row, slice
  // width, the y index it writes (-1: a padding row past n) and the tile
  int64_t at, at_next = 0, dst, dst_next = -1;
  int w, w_next = 0, q, q_next = 0;
  auto header = [&](int64_t fi, int64_t& a, int& wd, int64_t& d, int& qt) {
    const int64_t gr = fi / per_group;
    const int64_t rest = fi - gr * per_group;
    const int gs = min(group, tiles - static_cast<int>(gr) * group);
    const int64_t it = rest / gs;
    qt = static_cast<int>(gr) * group + static_cast<int>(rest - it * gs);
    const int64_t k = it / L;
    const int in_slice = static_cast<int>(it % L) * kRows + lane / L;
    const int64_t p = k * 32 + in_slice;
    a = offsets[k] + in_slice;
    wd = widths[k];
    d = p < n ? (rows != nullptr ? static_cast<int64_t>(rows[p]) : p) : -1;
  };
  header(f, at, w, dst, q);
  for (;;) {
    const int64_t next = f + warps;
    if (next < n_work) header(next, at_next, w_next, dst_next, q_next);
    const int chunk = (w + L - 1) / L;
    const int s_end = min(w, (part + 1) * chunk);
    const int nb = min(T, batch - q * T);
    const V* xq = xt + static_cast<int64_t>(q) * m * T;
    const V* vq = Shared ? vals : vals + static_cast<int64_t>(q) * T * vstride;
    C acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = C(0);
    if (dst >= 0) {
      // K slots a step: the next step's column ids load with this
      // step's T values a slot (evict-first; __ldg where shared by the
      // tiles) and T-value runs of xt, all before any FMA; each
      // instance's FMAs in slot order; a slot past the part's end adds
      // 0 * 0, which leaves a sum from +0.0 as it is (the sum is never
      // -0.0), so the bits are sell_spmv_kernel's whatever the step
      int c[K];
      auto cols_at = [&](int s0) {
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const int* pc = cols + at + static_cast<int64_t>(s0 + u) * 32;
          c[u] = s0 + u < s_end ? (group == 1 ? __ldcs(pc) : __ldg(pc))
                                : -1;
        }
      };
      cols_at(part * chunk);
      for (int s = part * chunk; s < s_end; s += K) {
        C v[Shared ? 1 : T][K];
#pragma unroll
        for (int t = 0; t < (Shared ? 1 : T); ++t) {
#pragma unroll
          for (int u = 0; u < K; ++u) {
            const V* pv = vq + t * vstride + at +
                          static_cast<int64_t>(s + u) * 32;
            v[t][u] = c[u] >= 0 && t < nb
                          ? C(Shared ? ldg_c(pv) : ldcs_c(pv)) : C(0);
          }
        }
        C xv[K][T];
#pragma unroll
        for (int u = 0; u < K; ++u) {
          if (c[u] >= 0) {
            ldg_run<T>(xq + static_cast<int64_t>(c[u]) * T, xv[u]);
          } else {
#pragma unroll
            for (int t = 0; t < T; ++t) xv[u][t] = C(0);
          }
        }
        cols_at(s + K);
#pragma unroll
        for (int t = 0; t < T; ++t) {
#pragma unroll
          for (int u = 0; u < K; ++u) {
            acc[t] = Term<0>::f(acc[t], v[Shared ? 0 : t][u], xv[u][t]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
        acc[t] = Term<0>::add(acc[t], shfl_xor(acc[t], o));
      }
    }
    if (part == 0 && dst >= 0) {
      // y is written once: evict-first, so it does not push xt out of L2
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (t < nb) {
          st_cs(y + static_cast<int64_t>(q * T + t) * n + dst, acc[t]);
        }
      }
    }
    if (next >= n_work) break;
    f = next;
    at = at_next;
    w = w_next;
    dst = dst_next;
    q = q_next;
  }
}

// batch instances (the grid's y axis, at most 65535) of m columns,
// their values shared when `shared` is set
template <typename V, typename X, typename Y, int K>
int launch(const void* cols, const void* vals, int w, const void* x,
           void* y, long long n, void* stream, long long m = 0,
           long long batch = 1, int shared = 1) {
  if (n <= 0) return 0;
  if (batch < 1 || batch > 65535 || m < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(batch));
  ell_spmv_kernel<V, X, Y, K><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const V*>(vals), w,
      static_cast<const X*>(x), static_cast<Y*>(y),
      static_cast<int64_t>(n), static_cast<int64_t>(m),
      shared ? 0 : static_cast<int64_t>(w) * n);
  return static_cast<int>(cudaGetLastError());
}

// enough blocks to cover every item, at most as many as fit on the card
// at once (the rest are walked grid-stride)
template <typename V, typename X, int K, int L>
int launch_sell_l(const void* cols, const void* vals, const void* offsets,
                  const void* widths, const void* rows, long long n_slices,
                  const void* x, void* y, long long n, void* stream) {
  if (n <= 0 || n_slices <= 0) return 0;
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sell_spmv_kernel<V, X, K, L>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items = n_slices * L;
  long long blocks = (items + kThreads / 32 - 1) / (kThreads / 32);
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (resident > 0 && blocks > resident) blocks = resident;
  sell_spmv_kernel<V, X, K, L><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const V*>(vals),
      static_cast<const int64_t*>(offsets), static_cast<const int*>(widths),
      static_cast<const int*>(rows), static_cast<int64_t>(items),
      static_cast<const X*>(x), static_cast<X*>(y),
      static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X, int K>
int launch_sell(const void* cols, const void* vals, const void* offsets,
                const void* widths, const void* rows, long long n_slices,
                int lanes, const void* x, void* y, long long n,
                void* stream) {
  switch (lanes) {
    case 1: return launch_sell_l<V, X, K, 1>(cols, vals, offsets, widths,
                                             rows, n_slices, x, y, n, stream);
    case 2: return launch_sell_l<V, X, K, 2>(cols, vals, offsets, widths,
                                             rows, n_slices, x, y, n, stream);
    case 4: return launch_sell_l<V, X, K, 4>(cols, vals, offsets, widths,
                                             rows, n_slices, x, y, n, stream);
    case 8: return launch_sell_l<V, X, K, 8>(cols, vals, offsets, widths,
                                             rows, n_slices, x, y, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// x copied instance-minor into the scratch, then the product: enough
// blocks to cover every (item, tile), at most as many as are resident
template <typename V, int L, int T, int K, bool Shared>
int launch_sell_batched_l(const void* cols, const void* vals,
                          const void* offsets, const void* widths,
                          const void* rows, long long n_slices,
                          const void* x, void* y, long long n, long long m,
                          long long stored, long long batch, void* scratch,
                          void* stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sell_spmv_batched_kernel<V, L, T, K, Shared>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (batch + T - 1) / T;
  V* xt = static_cast<V*>(scratch);
  if (m > 0) {
    const long long width = kCopyChunk / T;
    const long long chunks = tiles * ((m + width - 1) / width);
    const long long tb = chunks < kMaxBlocks ? chunks : kMaxBlocks;
    batch_tiles_kernel<V><<<static_cast<unsigned>(tb), kThreads, 0, st>>>(
        static_cast<const V*>(x), xt, static_cast<int64_t>(m),
        static_cast<int>(batch), T, static_cast<int64_t>(chunks));
  }
  const long long tile_bytes = m * T * static_cast<long long>(sizeof(V));
  const long long fit = kSellXBudget / (tile_bytes > 0 ? tile_bytes : 1);
  const long long group = fit < 1 ? 1 : (fit < tiles ? fit : tiles);
  const long long work = n_slices * L * tiles;
  long long blocks = (work + kThreads / 32 - 1) / (kThreads / 32);
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (resident > 0 && blocks > resident) blocks = resident;
  sell_spmv_batched_kernel<V, L, T, K, Shared>
      <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          static_cast<const int*>(cols), static_cast<const V*>(vals),
          static_cast<const int64_t*>(offsets),
          static_cast<const int*>(widths), static_cast<const int*>(rows),
          static_cast<int64_t>(n_slices), static_cast<int>(tiles),
          static_cast<int>(group), xt, static_cast<V*>(y),
          static_cast<int64_t>(n), static_cast<int64_t>(m),
          static_cast<int64_t>(stored), static_cast<int>(batch));
  return static_cast<int>(cudaGetLastError());
}

template <typename V, int T, int K, bool Shared>
int launch_sell_batched_s(const void* cols, const void* vals,
                          const void* offsets, const void* widths,
                          const void* rows, long long n_slices, int lanes,
                          const void* x, void* y, long long n, long long m,
                          long long stored, long long batch, void* scratch,
                          void* stream) {
  switch (lanes) {
#define SELL_BATCHED_CASE(L)                                              \
    case L:                                                               \
      return launch_sell_batched_l<V, L, T, K, Shared>(                   \
          cols, vals, offsets, widths, rows, n_slices, x, y, n, m, stored, \
          batch, scratch, stream);
    SELL_BATCHED_CASE(1)
    SELL_BATCHED_CASE(2)
    SELL_BATCHED_CASE(4)
    SELL_BATCHED_CASE(8)
#undef SELL_BATCHED_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename V, int T, int K>
int launch_sell_batched(const void* cols, const void* vals,
                        const void* offsets, const void* widths,
                        const void* rows, long long n_slices, int lanes,
                        const void* x, void* y, long long n, long long m,
                        long long stored, long long batch, int shared,
                        void* scratch, void* stream) {
  static_assert(kMaxTile % T == 0, "a tile divides kMaxTile");
  if (n <= 0 || n_slices <= 0) return 0;
  if (batch < 1 || batch > 65535 || m < 0 || stored < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shared) {
    return launch_sell_batched_s<V, T, K, true>(
        cols, vals, offsets, widths, rows, n_slices, lanes, x, y, n, m,
        stored, batch, scratch, stream);
  }
  return launch_sell_batched_s<V, T, K, false>(
      cols, vals, offsets, widths, rows, n_slices, lanes, x, y, n, m, stored,
      batch, scratch, stream);
}

}  // namespace

extern "C" int ell_spmv_f32(const void* cols, const void* vals, int w,
                            const void* x, void* y, long long n,
                            void* stream) {
  return launch<float, float, float, 0>(cols, vals, w, x, y, n, stream);
}

extern "C" int ell_spmv_f64(const void* cols, const void* vals, int w,
                            const void* x, void* y, long long n,
                            void* stream) {
  return launch<double, double, double, 0>(cols, vals, w, x, y, n, stream);
}

extern "C" int sell_spmv_f32(const void* cols, const void* vals,
                             const void* offsets, const void* widths,
                             const void* rows, long long n_slices,
                             int lanes, const void* x, void* y, long long n,
                             void* stream) {
  return launch_sell<float, float, 0>(cols, vals, offsets, widths, rows,
                                     n_slices, lanes, x, y, n, stream);
}

extern "C" int sell_spmv_f64(const void* cols, const void* vals,
                             const void* offsets, const void* widths,
                             const void* rows, long long n_slices,
                             int lanes, const void* x, void* y, long long n,
                             void* stream) {
  return launch_sell<double, double, 0>(cols, vals, offsets, widths, rows,
                                       n_slices, lanes, x, y, n, stream);
}

extern "C" int ell_spmv_bf16(const void* cols, const void* vals, int w,
                             const void* x, void* y, long long n,
                             void* stream) {
  return launch<bf16, bf16, bf16, 2>(cols, vals, w, x, y, n, stream);
}

extern "C" int ell_spmv_bf16_f32(const void* cols, const void* vals, int w,
                                 const void* x, void* y, long long n,
                                 void* stream) {
  return launch<bf16, float, float, 1>(cols, vals, w, x, y, n, stream);
}

extern "C" int ell_spmv_f32_f64(const void* cols, const void* vals, int w,
                                const void* x, void* y, long long n,
                                void* stream) {
  return launch<float, double, double, 1>(cols, vals, w, x, y, n, stream);
}

extern "C" int sell_spmv_bf16(const void* cols, const void* vals,
                              const void* offsets, const void* widths,
                              const void* rows, long long n_slices,
                              int lanes, const void* x, void* y, long long n,
                              void* stream) {
  // one lane a row: the bf16 sums in the plain version's order
  if (lanes != 1) return cudaErrorInvalidValue;
  return launch_sell_l<bf16, bf16, 2, 1>(cols, vals, offsets, widths, rows,
                                         n_slices, x, y, n, stream);
}

extern "C" int sell_spmv_f32_f64(const void* cols, const void* vals,
                                 const void* offsets, const void* widths,
                                 const void* rows, long long n_slices,
                                 int lanes, const void* x, void* y,
                                 long long n, void* stream) {
  return launch_sell<float, double, 1>(cols, vals, offsets, widths, rows,
                                       n_slices, lanes, x, y, n, stream);
}

extern "C" int sell_spmv_bf16_f32(const void* cols, const void* vals,
                                  const void* offsets, const void* widths,
                                  const void* rows, long long n_slices,
                                  int lanes, const void* x, void* y,
                                  long long n, void* stream) {
  // one lane a row, as every bf16 value layout has (SparseMatrix.astype)
  if (lanes != 1) return cudaErrorInvalidValue;
  return launch_sell_l<bf16, float, 1, 1>(cols, vals, offsets, widths, rows,
                                          n_slices, x, y, n, stream);
}

// the complex modes: dZZI (c128), dCCI (c64) and dZCI (c64 values, c128
// x and y); each term dtypes.cuh's complex rule in slot order from +0,
// the parts of L > 1 lanes added by the same xor tree
extern "C" int ell_spmv_c64(const void* cols, const void* vals, int w,
                            const void* x, void* y, long long n,
                            void* stream) {
  return launch<c64, c64, c64, 0>(cols, vals, w, x, y, n, stream);
}

extern "C" int ell_spmv_c128(const void* cols, const void* vals, int w,
                             const void* x, void* y, long long n,
                             void* stream) {
  return launch<c128, c128, c128, 0>(cols, vals, w, x, y, n, stream);
}

extern "C" int ell_spmv_c64_c128(const void* cols, const void* vals, int w,
                                 const void* x, void* y, long long n,
                                 void* stream) {
  return launch<c64, c128, c128, 1>(cols, vals, w, x, y, n, stream);
}

extern "C" int sell_spmv_c64(const void* cols, const void* vals,
                             const void* offsets, const void* widths,
                             const void* rows, long long n_slices,
                             int lanes, const void* x, void* y, long long n,
                             void* stream) {
  return launch_sell<c64, c64, 0>(cols, vals, offsets, widths, rows,
                                  n_slices, lanes, x, y, n, stream);
}

extern "C" int sell_spmv_c128(const void* cols, const void* vals,
                              const void* offsets, const void* widths,
                              const void* rows, long long n_slices,
                              int lanes, const void* x, void* y, long long n,
                              void* stream) {
  return launch_sell<c128, c128, 0>(cols, vals, offsets, widths, rows,
                                    n_slices, lanes, x, y, n, stream);
}

extern "C" int sell_spmv_c64_c128(const void* cols, const void* vals,
                                  const void* offsets, const void* widths,
                                  const void* rows, long long n_slices,
                                  int lanes, const void* x, void* y,
                                  long long n, void* stream) {
  return launch_sell<c64, c128, 1>(cols, vals, offsets, widths, rows,
                                   n_slices, lanes, x, y, n, stream);
}

// batch instances of one slot-major structure: cols (w, n), values
// (batch, w, n) or one (w, n) set shared by all (shared != 0), x (batch,
// m), y (batch, n)
extern "C" int ell_spmv_batched_f32(const void* cols, const void* vals,
                                    int w, const void* x, void* y,
                                    long long n, long long m,
                                    long long batch, int shared,
                                    void* stream) {
  return launch<float, float, float, 0>(cols, vals, w, x, y, n, stream, m,
                                        batch, shared);
}

extern "C" int ell_spmv_batched_f64(const void* cols, const void* vals,
                                    int w, const void* x, void* y,
                                    long long n, long long m,
                                    long long batch, int shared,
                                    void* stream) {
  return launch<double, double, double, 0>(cols, vals, w, x, y, n, stream,
                                           m, batch, shared);
}

// batch instances of one sliced structure (sell_spmv's arrays and plan):
// values (batch, stored) or one (stored,) set shared by all (shared !=
// 0), x (batch, m), y (batch, n); scratch holds the batch rounded up to a
// multiple of 16, times m values (x's instance-minor copy)
extern "C" int sell_spmv_batched_f32(const void* cols, const void* vals,
                                     const void* offsets,
                                     const void* widths, const void* rows,
                                     long long n_slices, int lanes,
                                     const void* x, void* y, long long n,
                                     long long m, long long stored,
                                     long long batch, int shared,
                                     void* scratch, void* stream) {
  return launch_sell_batched<float, kSellTile, kSellStep>(
      cols, vals, offsets, widths, rows, n_slices, lanes, x, y, n, m, stored,
      batch, shared, scratch, stream);
}

extern "C" int sell_spmv_batched_f64(const void* cols, const void* vals,
                                     const void* offsets,
                                     const void* widths, const void* rows,
                                     long long n_slices, int lanes,
                                     const void* x, void* y, long long n,
                                     long long m, long long stored,
                                     long long batch, int shared,
                                     void* scratch, void* stream) {
  return launch_sell_batched<double, kSellTile, kSellStep>(
      cols, vals, offsets, widths, rows, n_slices, lanes, x, y, n, m, stored,
      batch, shared, scratch, stream);
}

extern "C" int ell_spmv_batched_c64(const void* cols, const void* vals,
                                    int w, const void* x, void* y,
                                    long long n, long long m,
                                    long long batch, int shared,
                                    void* stream) {
  return launch<c64, c64, c64, 0>(cols, vals, w, x, y, n, stream, m, batch,
                                  shared);
}

extern "C" int ell_spmv_batched_c128(const void* cols, const void* vals,
                                     int w, const void* x, void* y,
                                     long long n, long long m,
                                     long long batch, int shared,
                                     void* stream) {
  return launch<c128, c128, c128, 0>(cols, vals, w, x, y, n, stream, m,
                                     batch, shared);
}

extern "C" int sell_spmv_batched_c64(const void* cols, const void* vals,
                                     const void* offsets,
                                     const void* widths, const void* rows,
                                     long long n_slices, int lanes,
                                     const void* x, void* y, long long n,
                                     long long m, long long stored,
                                     long long batch, int shared,
                                     void* scratch, void* stream) {
  return launch_sell_batched<c64, kSellTile, kSellStep>(
      cols, vals, offsets, widths, rows, n_slices, lanes, x, y, n, m, stored,
      batch, shared, scratch, stream);
}

extern "C" int sell_spmv_batched_c128(const void* cols, const void* vals,
                                      const void* offsets,
                                      const void* widths, const void* rows,
                                      long long n_slices, int lanes,
                                      const void* x, void* y, long long n,
                                      long long m, long long stored,
                                      long long batch, int shared,
                                      void* scratch, void* stream) {
  return launch_sell_batched<c128, kSellTile, kSellStep>(
      cols, vals, offsets, widths, rows, n_slices, lanes, x, y, n, m, stored,
      batch, shared, scratch, stream);
}
