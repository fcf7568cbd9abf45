// Ordered scatter-add for Hopper (sm_90a): out[index[e], :] += source[e, :]
// with every target row summed in operand order, as numpy's np.add.at and
// XLA's scatter on the CPU add (the JAX reference's fused epoch,
// src/repro/core/fused.py, leans on that order for its supply normaliser and
// its usage delta).  CUDA's own index_add_ adds with atomics, in an order
// that changes from run to run, so its float sums are not reproducible.
//
// The host wrapper (kernels/ops.py ordered_scatter_add) sorts the rows
// stably by target with PyTorch's radix sort, so each target's rows lie
// contiguous and in operand order, and passes their offsets.  This kernel
// then continues each target's left fold from out's current value: one warp
// a target row.  The lanes copy 32 rows at a time into a shared tile
// (coalesced, the next 32 rows already in flight in registers), and lane w
// adds column w of the tile's rows in order.  The shared loads do not wait
// on the sum, so a row costs about one add latency: the adds of one target
// are a chain -- the order is the contract -- and bound the kernel.
//
// Float contract: every add is __fadd_rn / __dadd_rn; nothing is contracted.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxW = 8;  // columns a target row may have
constexpr int kThreads = 128;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

constexpr int kWarpsPerBlock = kThreads / kWarp;

// lane's share of 32 rows from `row0` on: values [row0·W, min(row0 + 32, hi)·W)
// as W words a lane, word i of lane l the (i·32 + l)-th -- coalesced.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ values, int64_t row0, int64_t hi,
                                          int W, int lane, T* v) {
  const int64_t first = row0 * W, end = (row0 + kWarp < hi ? row0 + kWarp : hi) * W;
#pragma unroll
  for (int i = 0; i < kMaxW; ++i) {
    const int64_t at = first + i * kWarp + lane;
    v[i] = (i < W && at < end) ? values[at] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_fold_kernel(const T* __restrict__ values, const int64_t* __restrict__ offsets, int n,
                    int W, T* __restrict__ out) {
  __shared__ T tiles[kWarpsPerBlock][kWarp * kMaxW];
  const int target = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (target >= n) return;  // warp-uniform
  T* tile = tiles[threadIdx.x / kWarp];
  const int64_t lo = offsets[target], hi = offsets[target + 1];
  T acc = lane < W ? out[static_cast<int64_t>(target) * W + lane] : T(0);
  T cur[kMaxW], nxt[kMaxW];
  load_tile(values, lo, hi, W, lane, cur);
  for (int64_t base = lo; base < hi; base += kWarp) {
#pragma unroll
    for (int i = 0; i < kMaxW; ++i)
      if (i < W) tile[i * kWarp + lane] = cur[i];
    __syncwarp();
    load_tile(values, base + kWarp, hi, W, lane, nxt);  // the next 32 rows in flight
    if (lane < W) {
      if (hi - base >= kWarp) {
#pragma unroll
        for (int j = 0; j < kWarp; ++j) acc = add_rn(acc, tile[j * W + lane]);
      } else {
        for (int j = 0; j < hi - base; ++j) acc = add_rn(acc, tile[j * W + lane]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kMaxW; ++i) cur[i] = nxt[i];
  }
  if (lane < W) out[static_cast<int64_t>(target) * W + lane] = acc;
}

}  // namespace

extern "C" {

// values: (E, W) rows sorted stably by target; offsets: (n + 1,) int64, the
// rows of target b are [offsets[b], offsets[b + 1]); out: (n, W), updated in
// place; is_double: 1 for float64, 0 for float32.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for W outside 1..kMaxW.
int ordered_scatter_add(const void* values, const int64_t* offsets, int n, int W, int is_double,
                        void* out, void* stream_ptr) {
  if (W < 1 || W > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (n * kWarp + kThreads - 1) / kThreads;
  if (is_double)
    segment_fold_kernel<double><<<blocks, kThreads, 0, stream>>>(
        static_cast<const double*>(values), offsets, n, W, static_cast<double*>(out));
  else
    segment_fold_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(values), offsets, n, W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
