// One clock-auction round over the flat CSR bid book, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_bid_eval_csr.py
// (sparse_bid_eval_csr -> _sparse_bid_eval_csr_kernel).  Bundle (u, b) owns
// the elements offsets[u*B+b] .. offsets[u*B+b+1] of the flat idx/val
// streams, so a book with skewed bundle sizes moves only its true nonzeros.
// An empty bundle costs exactly 0.0.  Selection is the padded kernel's:
// scalar pi takes the first cheapest valid bundle while cost <= pi, vector pi
// the first highest-surplus valid bundle while surplus >= 0.  Output: chosen
// (U,) int32 (-1 = out) and z (R,), the chosen bundles' elements scattered
// through a shared-memory z tile and one global atomicAdd per (CTA, pool).
// The order of those additions changes from run to run: z is float-close,
// never bit-reproducible.
//
// One thread per user; k_bound (the longest bundle) bounds its loop.  The
// TPU version kept the whole flat streams resident in VMEM, which capped a
// book at about 1M nonzeros; here the streams are read from HBM, so there is
// no such cap.
//
// Float contract: compiled with --fmad=false; each bundle's cost is v0*p0
// followed by one __fmaf_rn per further element, as the plain PyTorch
// version (repro_torch/kernels/ref.py) computes it.
//
// What bounds it: memory.  For a skewed book of U = 100,000 users, B = 4,
// K in 1..16 (mean 4, nnz ~ 1.6M), R = 1,000, one round reads idx+val
// ~12.8 MB, offsets 1.6 MB, pi <= 1.6 MB and mask 0.4 MB, and writes chosen
// 0.4 MB: ~17 MB, ~5 us at 3.35 TB/s.  This first version reads each
// thread's segments with plain loads, uncoalesced across the warp; left for
// later: cp.async/TMA staging of the streams and a warp per user for long
// segments.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemFloats = 12 * 1024;  // 48 KB of dynamic shared memory

__global__ void csr_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                           const int* __restrict__ offsets, const uint8_t* __restrict__ mask,
                           const float* __restrict__ pi, int pi_vector,
                           const float* __restrict__ prices, int U, int B, int k_bound, int R,
                           int stage, int* __restrict__ chosen, float* __restrict__ z) {
  extern __shared__ float smem[];
  float* s_prices = smem;
  float* s_z = smem + R;
  if (stage) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      s_prices[r] = prices[r];
      s_z[r] = 0.f;
    }
  }
  __syncthreads();
  const float* p = stage ? s_prices : prices;

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < U) {
    const size_t row = static_cast<size_t>(u) * B;
    int bhat = 0;
    float best = 0.f;
    for (int b = 0; b < B; ++b) {
      const int s = offsets[row + b];
      const int c = min(offsets[row + b + 1] - s, k_bound);
      float cost = 0.f;
      if (c > 0) {
        cost = __fmul_rn(val[s], p[idx[s]]);
        for (int k = 1; k < c; ++k) cost = __fmaf_rn(val[s + k], p[idx[s + k]], cost);
      }
      float score;
      if (!pi_vector) {
        score = mask[row + b] ? cost : __int_as_float(0x7f800000);
        if (b == 0 || score < best) { best = score; bhat = b; }
      } else {
        score = mask[row + b] ? __fsub_rn(pi[row + b], cost) : -__int_as_float(0x7f800000);
        if (b == 0 || score > best) { best = score; bhat = b; }
      }
    }
    const bool active = pi_vector ? best >= 0.f : best <= pi[u];
    chosen[u] = active ? bhat : -1;
    if (active) {
      const int s = offsets[row + bhat];
      const int c = min(offsets[row + bhat + 1] - s, k_bound);
      for (int k = 0; k < c; ++k) atomicAdd(stage ? &s_z[idx[s + k]] : &z[idx[s + k]], val[s + k]);
    }
  }
  if (stage) {
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      if (s_z[r] != 0.f) atomicAdd(&z[r], s_z[r]);
  }
}

}  // namespace

extern "C" {

// z must hold R zeros on entry.  Returns cudaGetLastError().
int sparse_bid_eval_csr_z(const int* idx, const float* val, const int* offsets,
                          const uint8_t* mask, const float* pi, int pi_vector,
                          const float* prices, int U, int B, int k_bound, int R, int* chosen,
                          float* z, void* stream) {
  const int stage = R <= kSmemFloats / 2;
  const size_t smem = stage ? 2 * sizeof(float) * R : 0;
  const int blocks = (U > 0 ? U + kThreads - 1 : kThreads) / kThreads;
  csr_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, val, offsets, mask, pi, pi_vector, prices, U, B, k_bound, R, stage, chosen, z);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
