// Ordered scatter-add for Hopper (sm_90a): out[index[e], :] += source[e, :]
// with every target row summed in operand order, as numpy's np.add.at and
// XLA's scatter on the CPU add (the JAX reference's fused epoch,
// src/repro/core/fused.py:361 and :445-482, leans on that order for its
// supply normaliser and its usage delta; no pallas_call).  CUDA's own
// index_add_ adds with atomics, in an order that changes from run to run, so
// its float sums are not reproducible.
//
// What bounds it.  Each target's adds are one chain -- the order is the
// contract, nothing may be reassociated -- so the call takes at least the
// longest target's kept rows times the card's dependent add latency; beside
// that, reading the index once.  The design keeps the call near the larger
// of the two:
//
//   1. count   (one block a chunk of rows, one warp a contiguous sub-chunk):
//              each warp counts its kept rows by target in shared memory
//              (atomic adds: a count has no order), 8 steps of 32 rows'
//              indices in flight, and writes its kept rows' numbers and
//              targets, compacted in order (a ballot prefix), into its own
//              region of two scratch lists; a block writes its per-target
//              totals target-major (counts[t * chunks + c]) and each
//              warp's exclusive prefix inside the block.
//   2. scan    (one block): the exclusive scan of counts in target-major
//              order, in place, staged through shared memory so that every
//              read and write is coalesced: the start of each (target,
//              chunk), and each target's first kept row (offsets[t];
//              offsets[n] the total).
//   3. place   (as 1, over each warp's compacted list, so dropped rows cost
//              nothing here): each kept row, converted to out's type, goes
//              to its (target, chunk) start + the warp's prefix + the rows
//              of that target the warp has already placed + its rank among
//              the lanes of its step with the same target (one ballot for
//              each bit in which the step's targets differ), so the
//              partition is stable: warps in chunk order, steps in warp
//              order, lanes in step order.  The places of 8 steps are found
//              first and their rows copied after, all loads in flight.
//   4. fold    (one block a target): warps 1.. keep a ring of kStages
//              shared stages filled with 16-byte cp.async copies of the
//              target's rows, kStages - 1 stages ahead of the chain; lane
//              c < W of warp 0 adds column c of each row in order (W a
//              template constant, so each row is one shared load at a fixed
//              offset), loading the next 32 rows while it adds these.
//
// The host wrapper (kernels/ops.py ordered_scatter_add) plans the chunks
// (ops.scatter_plan) and allocates the partition buffer and scratch; sizes
// come from E on the host and every offset stays on the card, so nothing
// synchronises and a call records into a CUDA graph.  The index is read in
// place as int32 or int64; rows outside 0..n-1 are dropped.
//
// Float contract: every add is __fadd_rn / __dadd_rn; nothing is contracted
// or reassociated.  The conversion of a float64 source into a float32 out is
// round-to-nearest, as PyTorch's.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxW = 8;                   // columns a target row may have
constexpr int kMaxWarps = 8;               // warps of a count / place block
constexpr int kCounterBytes = 48 * 1024;   // their per-warp target counters, at most
constexpr int kUnroll = 8;                 // 32-row steps whose indices load at once
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;              // counts a scan thread takes a round
constexpr int kScanRound = kScanThreads * kScanItems;
constexpr int kFoldThreads = 128;
constexpr int kStages = 8;                 // the fold's ring
constexpr int kStageBytes = 16 * 1024;
constexpr int kBatch = 32;                 // rows whose loads precede their adds

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// the target of row `row`, or -1 if it lies past the sub-chunk or is dropped
template <typename I>
__device__ __forceinline__ int target_of(const I* __restrict__ index, int64_t row, int64_t end,
                                         int n) {
  if (row >= end) return -1;
  const I x = index[row];
  return (x >= 0 && x < n) ? static_cast<int>(x) : -1;
}

// the kept lanes whose target equals this lane's (0 for a dropped lane):
// one ballot for each bit in which the kept lanes' targets differ
__device__ __forceinline__ unsigned peers_of(int t, unsigned kept) {
  if (kept == 0) return 0;  // warp-uniform
  const bool in = t >= 0;
  const unsigned u = static_cast<unsigned>(t);
  unsigned varying =
      __reduce_or_sync(kFull, in ? u : 0u) ^ __reduce_and_sync(kFull, in ? u : ~0u);
  unsigned p = in ? kept : 0u;
  while (varying) {  // warp-uniform
    const int b = __ffs(varying) - 1;
    varying &= varying - 1;
    const bool bit = (u >> b) & 1u;
    const unsigned ones = __ballot_sync(kFull, bit);
    p &= bit ? ones : ~ones;
  }
  return p;
}

// warp w of block c owns rows [(c·warps + w)·sub, +sub) ∩ [0, E)
__device__ __forceinline__ void sub_chunk(int64_t E, int sub, int64_t* r0, int64_t* r1) {
  const int warps = blockDim.x / kWarp;
  *r0 = (static_cast<int64_t>(blockIdx.x) * warps + threadIdx.x / kWarp) * sub;
  *r1 = *r0 + sub < E ? *r0 + sub : E;
}

// 1. per-target counts of each warp's sub-chunk -> the block's totals,
//    target-major, and each warp's exclusive prefix inside the block; and
//    each warp's kept rows and their targets, compacted in order into the
//    warp's own region of crow / ctgt (where its rows lie), kept_rows[warp]
//    of them
template <typename I>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
count_kernel(const I* __restrict__ index, int64_t E, int n, int sub, int chunks,
             int* __restrict__ counts, int* __restrict__ wprefix, int* __restrict__ kept_rows,
             int* __restrict__ crow, int* __restrict__ ctgt) {
  extern __shared__ int counters[];  // [warps][n]
  const int warps = blockDim.x / kWarp, lane = threadIdx.x % kWarp;
  for (int i = threadIdx.x; i < warps * n; i += blockDim.x) counters[i] = 0;
  __syncthreads();
  int* mine = counters + (threadIdx.x / kWarp) * n;
  const unsigned below = (1u << lane) - 1;
  int64_t r0, r1;
  sub_chunk(E, sub, &r0, &r1);
  int found = 0;  // warp-uniform: kept rows so far
  for (int64_t base = r0; base < r1; base += kWarp * kUnroll) {
    int t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) t[u] = target_of(index, base + u * kWarp + lane, r1, n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned kept = __ballot_sync(kFull, t[u] >= 0);
      if (t[u] >= 0) {
        atomicAdd(&mine[t[u]], 1);  // a count: the order does not matter
        const int64_t at = r0 + found + __popc(kept & below);
        crow[at] = static_cast<int>(base + u * kWarp + lane);
        ctgt[at] = t[u];
      }
      found += __popc(kept);
    }
  }
  if (lane == 0) kept_rows[blockIdx.x * warps + threadIdx.x / kWarp] = found;
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    int s = 0;
    for (int w = 0; w < warps; ++w) {
      wprefix[(static_cast<int64_t>(blockIdx.x) * warps + w) * n + t] = s;
      s += counters[w * n + t];
    }
    counts[static_cast<int64_t>(t) * chunks + blockIdx.x] = s;
  }
}

// 2. exclusive scan of the L = n·chunks counts in place, target-major, in
//    rounds of kScanRound counts staged through shared memory (coalesced
//    in and out, each thread scanning kScanItems in a row, one pad word a
//    32 against bank conflicts); each target's first start is its offset,
//    the total offsets[n]
__device__ __forceinline__ int padded(int i) { return i + i / kWarp; }

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ counts, int L, int chunks, int n, int* __restrict__ offsets) {
  __shared__ int tile[kScanRound + kScanRound / kWarp];
  __shared__ int warp_sums[kScanThreads / kWarp];
  __shared__ int round_total;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int carry = 0;
  for (int base = 0; base < L; base += kScanRound) {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int k = base + i * kScanThreads + threadIdx.x;
      tile[padded(i * kScanThreads + threadIdx.x)] = k < L ? counts[k] : 0;
    }
    __syncthreads();
    int v[kScanItems], sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = tile[padded(threadIdx.x * kScanItems + i)];
      sum += v[i];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == kWarp - 1) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_sums[lane];
      int wi = w;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(kFull, wi, o);
        if (lane >= o) wi += y;
      }
      warp_sums[lane] = wi - w;
      if (lane == kWarp - 1) round_total = wi;
    }
    __syncthreads();
    int run = carry + warp_sums[warp] + incl - sum;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      tile[padded(threadIdx.x * kScanItems + i)] = run;
      run += v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int k = base + i * kScanThreads + threadIdx.x;
      if (k < L) counts[k] = tile[padded(i * kScanThreads + threadIdx.x)];
    }
    carry += round_total;
    __syncthreads();  // tile, warp_sums and round_total are rewritten next round
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x) offsets[t] = counts[t * chunks];
  if (threadIdx.x == 0) offsets[n] = carry;
}

// 3. each kept row, converted to T, at its stable place in `part`: each
//    warp walks its compacted kept rows in order, 32 a step; per 8 steps,
//    the ranks, then the places (the warp's counters moved on step by
//    step), then every row's copy at once
template <typename S, typename T>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
place_kernel(const S* __restrict__ source, int n, int W, int sub, int chunks,
             const int* __restrict__ starts, const int* __restrict__ wprefix,
             const int* __restrict__ kept_rows, const int* __restrict__ crow,
             const int* __restrict__ ctgt, T* __restrict__ part) {
  extern __shared__ int placed[];  // [warps][n]: where each warp's next row of t goes
  const int warps = blockDim.x / kWarp, lane = threadIdx.x % kWarp;
  for (int i = threadIdx.x; i < warps * n; i += blockDim.x) {
    const int t = i % n;
    placed[i] = starts[static_cast<int64_t>(t) * chunks + blockIdx.x] +
                wprefix[static_cast<int64_t>(blockIdx.x) * warps * n + i];
  }
  __syncthreads();
  const int warp = blockIdx.x * warps + threadIdx.x / kWarp;
  int* mine = placed + (threadIdx.x / kWarp) * n;
  const unsigned below = (1u << lane) - 1;
  const int64_t region = static_cast<int64_t>(warp) * sub;
  const int found = kept_rows[warp];
  for (int base = 0; base < found; base += kWarp * kUnroll) {
    int t[kUnroll], row[kUnroll], at[kUnroll];
    unsigned kept[kUnroll], peers[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * kWarp + lane;
      t[u] = k < found ? ctgt[region + k] : -1;
      row[u] = k < found ? crow[region + k] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      kept[u] = __ballot_sync(kFull, t[u] >= 0);
      peers[u] = peers_of(t[u], kept[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kept[u] == 0) continue;  // warp-uniform
      at[u] = t[u] >= 0 ? mine[t[u]] + __popc(peers[u] & below) : 0;
      __syncwarp();
      if (t[u] >= 0 && (peers[u] & below) == 0) mine[t[u]] += __popc(peers[u]);
      __syncwarp();
    }
    for (int c = 0; c < W; ++c) {
      S v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = t[u] >= 0 ? source[static_cast<int64_t>(row[u]) * W + c] : S(0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t[u] >= 0) part[static_cast<int64_t>(at[u]) * W + c] = static_cast<T>(v[u]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of one column, W apart, added to acc in order; each batch of
// kBatch rows is loaded while the batch before it is added
template <typename T, int W>
__device__ __forceinline__ T fold_rows(const T* v, int rows, T acc) {
  int j = 0;
  if (rows >= kBatch) {
    T x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) x[i] = v[i * W];
    for (j = kBatch; j + kBatch <= rows; j += kBatch) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const T next = v[(j + i) * W];
        acc = add_rn(acc, x[i]);
        x[i] = next;
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) acc = add_rn(acc, x[i]);
  }
  for (; j < rows; ++j) acc = add_rn(acc, v[j * W]);
  return acc;
}

// 4. one block a target: its rows part[offsets[t]·W, offsets[t + 1]·W) come
//    through the ring in stages of whole rows; stage s covers elements
//    [g0, g1) and is copied as the 16-byte-aligned window [a0, a1) around
//    them (part holds at least V elements past E·W, so a1 stays inside).
//    Warps 1.. copy; warp 0's lanes c < W only add.  One barrier a stage:
//    past it, stage s has landed and stage s - 1's slot is free.
template <typename T, int W>
struct Ring {
  static constexpr int V = 16 / sizeof(T);                        // elements a copy
  static constexpr int kStage = kStageBytes / sizeof(T) / W * W;  // elements a full stage
  static constexpr int kSlot = (kStage + 3 * V - 1) / V * V;  // >= kStage + 2V - 2, whole copies
  static constexpr size_t kBytes = sizeof(T) * kStages * kSlot;   // dynamic shared memory
};

template <typename T, int W>
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const T* __restrict__ part, const int* __restrict__ offsets, T* __restrict__ out) {
  constexpr int V = Ring<T, W>::V, kStage = Ring<T, W>::kStage, kSlot = Ring<T, W>::kSlot;
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  T* ring = reinterpret_cast<T*>(ring_bytes);
  const int t = blockIdx.x;
  const int64_t lo = static_cast<int64_t>(offsets[t]) * W;
  const int64_t hi = static_cast<int64_t>(offsets[t + 1]) * W;
  if (lo == hi) return;  // block-uniform: nothing to add
  const int64_t stages = (hi - lo + kStage - 1) / kStage;
  auto window = [&](int64_t s, int64_t* g0, int64_t* g1, int64_t* a0) {
    *g0 = lo + s * kStage;
    *g1 = *g0 + kStage < hi ? *g0 + kStage : hi;
    *a0 = *g0 & ~static_cast<int64_t>(V - 1);
  };
  auto issue = [&](int64_t s) {
    if (threadIdx.x >= kWarp && s < stages) {
      int64_t g0, g1, a0;
      window(s, &g0, &g1, &a0);
      const int64_t copies = ((g1 + V - 1) & ~static_cast<int64_t>(V - 1)) - a0;
      T* slot = ring + (s % kStages) * kSlot;
      for (int64_t v = threadIdx.x - kWarp; v < copies / V; v += kFoldThreads - kWarp)
        cp_async16(slot + v * V, part + a0 + v * V);
    }
    cp_async_commit();  // an empty group past the last stage keeps the count
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  const int col = threadIdx.x;
  T acc = col < W ? out[static_cast<int64_t>(t) * W + col] : T(0);
  for (int64_t s = 0; s < stages; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s have landed
    __syncthreads();  // everyone's have, and the chain is done with stage s - 1
    issue(s + kStages - 1);  // into stage s - 1's slot, while the chain adds stage s
    if (col < W) {
      int64_t g0, g1, a0;
      window(s, &g0, &g1, &a0);
      acc = fold_rows<T, W>(ring + (s % kStages) * kSlot + (g0 - a0) + col,
                            static_cast<int>((g1 - g0) / W), acc);
    }
  }
  if (col < W) out[static_cast<int64_t>(t) * W + col] = acc;
}

struct Call {
  const void* index;
  int index64;
  const void* source;
  int source64;
  int64_t E;
  int n, W, out64;
  void* out;
  void* part;
  int* scratch;
  int warps, sub, chunks;
  cudaStream_t stream;
  int* counts() const { return scratch; }
  int* wprefix() const { return scratch + static_cast<int64_t>(n) * chunks; }
  int* offsets() const { return wprefix() + static_cast<int64_t>(chunks) * warps * n; }
  int* kept_rows() const { return offsets() + n + 1; }
  int64_t cover() const { return static_cast<int64_t>(chunks) * warps * sub; }
  int* crow() const { return kept_rows() + static_cast<int64_t>(chunks) * warps; }
  int* ctgt() const { return crow() + cover(); }
  size_t counter_bytes() const { return sizeof(int) * warps * n; }
};

template <typename S, typename T>
void launch_place(const Call& c) {
  place_kernel<S, T><<<c.chunks, c.warps * kWarp, c.counter_bytes(), c.stream>>>(
      static_cast<const S*>(c.source), c.n, c.W, c.sub, c.chunks, c.counts(), c.wprefix(),
      c.kept_rows(), c.crow(), c.ctgt(), static_cast<T*>(c.part));
}

template <typename I>
void launch_count(const Call& c) {
  count_kernel<I><<<c.chunks, c.warps * kWarp, c.counter_bytes(), c.stream>>>(
      static_cast<const I*>(c.index), c.E, c.n, c.sub, c.chunks, c.counts(), c.wprefix(),
      c.kept_rows(), c.crow(), c.ctgt());
}

int partition(const Call& c) {
  c.index64 ? launch_count<int64_t>(c) : launch_count<int32_t>(c);
  scan_kernel<<<1, kScanThreads, 0, c.stream>>>(c.counts(), c.n * c.chunks, c.chunks, c.n,
                                                 c.offsets());
  if (c.source64)
    c.out64 ? launch_place<double, double>(c) : launch_place<double, float>(c);
  else
    c.out64 ? launch_place<float, double>(c) : launch_place<float, float>(c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W = 1>
void launch_fold(const Call& c) {
  if (c.W != W) {
    if constexpr (W < kMaxW) launch_fold<T, W + 1>(c);
    return;
  }
  static bool opted_in = false;  // the ring is past the 48 KB a launch gets unasked
  if (!opted_in) {
    cudaFuncSetAttribute(fold_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(Ring<T, W>::kBytes));
    opted_in = true;
  }
  fold_kernel<T, W><<<c.n, kFoldThreads, Ring<T, W>::kBytes, c.stream>>>(
      static_cast<const T*>(c.part), c.offsets(), static_cast<T*>(c.out));
}

int fold(const Call& c) {
  c.out64 ? launch_fold<double>(c) : launch_fold<float>(c);
  return static_cast<int>(cudaGetLastError());
}

bool valid(const Call& c) {
  return c.E >= 1 && c.n >= 1 && c.W >= 1 && c.W <= kMaxW && c.warps >= 1 &&
         c.warps <= kMaxWarps && c.sub >= 1 && c.chunks >= 1 &&
         c.counter_bytes() <= static_cast<size_t>(kCounterBytes) &&
         static_cast<int64_t>(c.chunks) * c.warps * c.sub >= c.E &&
         static_cast<int64_t>(c.chunks) * c.warps * c.n < (int64_t(1) << 31) &&
         c.cover() < (int64_t(1) << 31);
}

template <typename T>
__global__ void add_chain_kernel(T x, int adds, T* out) {
  T acc = x;
#pragma unroll 16
  for (int i = 0; i < adds; ++i) acc = add_rn(acc, x);
  *out = acc;
}

}  // namespace

extern "C" {

// index: (E,) int32 or int64 (index64); source: (E, W) float32 or float64
// (source64); out: (n, W) float32 or float64 (out64), updated in place;
// part: at least E·W + 16 / sizeof(out) elements of out's type, 16-byte
// aligned; scratch: n·chunks·(1 + warps) + n + 1 + chunks·warps +
// 2·chunks·warps·sub int32; warps, sub, chunks: the plan (ops.scatter_plan),
// chunks·warps·sub >= E.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these limits (W in 1..8,
// warps·n counters in 48 KB, chunks·warps·sub < 2^31).
int ordered_scatter_add(const void* index, int index64, const void* source, int source64,
                        long long E, int n, int W, int out64, void* out, void* part, int* scratch,
                        int warps, int sub, int chunks, void* stream) {
  const Call c{index, index64, source, source64, E, n, W, out64, out, part, scratch,
               warps, sub, chunks, static_cast<cudaStream_t>(stream)};
  if (!valid(c)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = partition(c);
  return err != 0 ? err : fold(c);
}

// The two halves of ordered_scatter_add, with its arguments, so that each
// can be timed alone: passes 1-3, and the fold of a partition left in
// part and scratch by the first.
int ordered_scatter_partition(const void* index, int index64, const void* source, int source64,
                              long long E, int n, int W, int out64, void* out, void* part,
                              int* scratch, int warps, int sub, int chunks, void* stream) {
  const Call c{index, index64, source, source64, E, n, W, out64, out, part, scratch,
               warps, sub, chunks, static_cast<cudaStream_t>(stream)};
  return valid(c) ? partition(c) : static_cast<int>(cudaErrorInvalidValue);
}

int ordered_scatter_fold(const void* index, int index64, const void* source, int source64,
                         long long E, int n, int W, int out64, void* out, void* part, int* scratch,
                         int warps, int sub, int chunks, void* stream) {
  const Call c{index, index64, source, source64, E, n, W, out64, out, part, scratch,
               warps, sub, chunks, static_cast<cudaStream_t>(stream)};
  return valid(c) ? fold(c) : static_cast<int>(cudaErrorInvalidValue);
}

// The card's dependent add latency: one thread adds x to itself `adds` times
// in one chain (__fadd_rn, or __dadd_rn if is_double) and writes the sum to
// out.  Time two lengths; the difference over the extra adds is the latency.
int add_chain_probe(int adds, int is_double, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    add_chain_kernel<double><<<1, 1, 0, s>>>(1.0, adds, static_cast<double*>(out));
  else
    add_chain_kernel<float><<<1, 1, 0, s>>>(1.0f, adds, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
