// Ordered row scatter-add for Hopper (sm_90a): out[index[e], :] += source[e, :]
// with every target row summed in operand order, as numpy's np.add.at and
// XLA's scatter on the CPU add.  No TPU kernel: the JAX reference leaves
// these scatters to XLA -- the backward of an embedding lookup
// (src/repro/models/layers.py, transformer.py:243-245), the MoE combine
// out.at[buf_tok].add(y) (src/repro/models/moe.py:136-138) and the
// backward of its dispatch gather (moe.py:122).  CUDA's index_add_ and
// the backward of table[tokens] add with atomics, in an order that changes
// from run to run, so a train step on the card would not repeat itself.
// ordered_scatter.cu takes at most 8 columns; these rows are 1..7,168 wide
// and their targets reach a whole vocabulary (151,936 rows).
//
// What bounds it.  Each target's adds are one chain (the order is the
// contract), so the call takes at least the longest target's rows times
// the dependent add latency; beside that, reading the source rows and the
// index once and reading and writing each touched target row once.
//
// Design (simple first; making it fast is later work).  The wrapper
// (kernels/ops.py ordered_rows_add) partitions the row numbers stably by
// target on the card (torch.sort(stable=True) of the kept targets, rows out
// of range keyed past the last target) and hands over the sorted keys and
// the permutation.  One CTA folds one (segment, column tile): a thread owns
// V adjacent columns (a 16-byte vector where the row width and the
// pointers allow it: 4 float32, 2 float64, 2 bfloat16 at 4 bytes), loads
// kBatch rows' values ahead, then adds them in order from out's value and
// writes the row back.  A segment is
//   * target mode (starts != null, grid over the n targets): the rows
//     starts[t] .. starts[t + 1] of the sorted order;
//   * head mode (starts == null, grid over the E sorted rows): the run of
//     equal keys that starts at this row, if it starts here,
// whichever grid is smaller (the wrapper picks it from the shapes), so
// neither a 151,936-row vocabulary with a 2,048-token batch nor a combine
// of 5,120 slots into 512 tokens launches mostly empty CTAs.  Sizes come
// from shapes on the host and every offset stays on the card: nothing
// synchronises, and a call records into a CUDA graph.
//
// Float contract: every add is __fadd_rn / __dadd_rn; a bfloat16 add is the
// float32 sum of the two bfloat16 values rounded to bfloat16 (round to
// nearest even), as ml_dtypes' np.add.at and XLA's bf16 scatter on the CPU
// add; nothing is contracted or reassociated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kBatch = 8;  // rows whose loads precede their adds

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void add_into(Vec<T, V>& acc, const Vec<T, V>& x) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc.v[i] = add_rn(acc.v[i], x.v[i]);
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
fold_rows_kernel(const int* __restrict__ keys, const int64_t* __restrict__ perm,
                 const int* __restrict__ starts, const T* __restrict__ source,
                 T* __restrict__ out, int64_t E, int n, int64_t width) {
  const int64_t seg = blockIdx.x;
  int64_t start, end;
  int t;
  if (starts != nullptr) {  // target mode
    t = static_cast<int>(seg);
    start = starts[t];
    end = starts[t + 1];
    if (start == end) return;
  } else {  // head mode: this row starts its target's run, or the CTA has nothing
    t = keys[seg];
    if (t >= n || (seg > 0 && keys[seg - 1] == t)) return;
    start = seg;
    end = seg + 1;
    while (end < E && keys[end] == t) ++end;
  }
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * V;
  if (col >= width) return;
  using Row = Vec<T, V>;
  Row* dst = reinterpret_cast<Row*>(out + static_cast<int64_t>(t) * width + col);
  Row acc = *dst;
  for (int64_t r = start; r < end; r += kBatch) {
    Row buf[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (r + k < end)
        buf[k] = *reinterpret_cast<const Row*>(source + perm[r + k] * width + col);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (r + k < end) add_into(acc, buf[k]);
  }
  *dst = acc;
}

template <typename T, int V>
int launch(const int* keys, const int64_t* perm, const int* starts, const void* source, void* out,
           int64_t E, int n, int64_t width, cudaStream_t stream) {
  const int64_t vectors = width / V;
  int threads = static_cast<int>(vectors < kMaxThreads ? (vectors + 31) / 32 * 32 : kMaxThreads);
  const int64_t tiles = (vectors + threads - 1) / threads;
  const int64_t segs = starts != nullptr ? n : E;
  if (tiles > 65535 || segs > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(segs), static_cast<unsigned>(tiles));
  fold_rows_kernel<T, V><<<grid, threads, 0, stream>>>(
      keys, perm, starts, static_cast<const T*>(source), static_cast<T*>(out), E, n, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// keys: (E,) int32, the kept targets sorted stably, rows out of range keyed
// n (they sort last and are skipped); perm: (E,) int64, the row of each
// sorted key; starts: (n + 1,) int32 with starts[t] the first sorted row of
// target t (target mode), or null (head mode); source: (E, width) and out:
// (n, width) of dtype 0 float32, 1 float64, 2 bfloat16, contiguous, out
// updated in place; vec: the columns a thread takes (1, or 4 / 2 / 2 by
// dtype, when width is a multiple of it and both pointers are aligned to
// it).  Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments
// outside these limits.
int ordered_rows_add(const int* keys, const void* perm, const int* starts, const void* source,
                     void* out, int dtype, long long E, int n, long long width, int vec,
                     void* stream) {
  if (E < 1 || n < 1 || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const int64_t*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 8 + vec) {
    case 0 * 8 + 1: return launch<float, 1>(keys, p, starts, source, out, E, n, width, s);
    case 0 * 8 + 4: return launch<float, 4>(keys, p, starts, source, out, E, n, width, s);
    case 1 * 8 + 1: return launch<double, 1>(keys, p, starts, source, out, E, n, width, s);
    case 1 * 8 + 2: return launch<double, 2>(keys, p, starts, source, out, E, n, width, s);
    case 2 * 8 + 1: return launch<__nv_bfloat16, 1>(keys, p, starts, source, out, E, n, width, s);
    case 2 * 8 + 2: return launch<__nv_bfloat16, 2>(keys, p, starts, source, out, E, n, width, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
