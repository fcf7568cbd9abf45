// One clock-auction round over the flat CSR bid book, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_bid_eval_csr.py
// (sparse_bid_eval_csr -> _sparse_bid_eval_csr_kernel).  Bundle (u, b) owns
// the elements offsets[u*B+b] .. offsets[u*B+b+1] of the flat idx/val
// streams, so a book with skewed bundle sizes moves only its true nonzeros.
// An empty bundle costs exactly 0.0.  Selection is the padded kernel's:
// scalar pi takes the first cheapest valid bundle while cost <= pi, vector pi
// the first highest-surplus valid bundle while surplus >= 0.  Output: chosen
// (U,) int32 (-1 = out) and z (R,), the chosen bundles' elements summed on
// the SM and added to z with one global atomicAdd per (CTA, touched pool).
// The order of those additions changes from run to run: z is float-close,
// never bit-reproducible.  The TPU version kept the whole flat streams
// resident in VMEM, which capped a book at about 1M nonzeros; here they are
// read from device memory, so there is no such cap.
//
// Float contract: compiled with --fmad=false; each bundle's cost is v0*p0
// followed by one __fmaf_rn per further element (at most k_bound, the
// longest bundle), as the plain PyTorch version (repro_torch/kernels/ref.py)
// computes it.
//
// What bounds it: memory.  The planet book (U = 101,000, B = 3, nnz =
// 601,000, R = 1,000, scalar pi) reads idx+val 4.8 MB, offsets 1.2 MB, pi
// 0.4 MB and mask 0.3 MB and writes chosen 0.4 MB: 7.1 MB, ~2.1 us at
// 3.35 TB/s; a skewed book of U = 100,000, B = 4, K in 1..16 (nnz ~ 1.6M)
// ~17 MB, ~5 us.  In the clock the book stays in L2 from round to round, and
// the fixed costs (two launches, barriers, the scatter's shared atomics)
// weigh more than the bytes: tools/z_split.py times each step.  Each
// bundle's loads are a three-hop chain, offsets -> idx -> price.
//
// Design: the host plans a span (ops.csr_z_plan): the most users, up to
// 512, whose offsets, pi, mask and 1.25x the book's mean elements a user
// fit in 64 KB of shared memory; cap, the elements a CTA's stretch may
// hold, takes what is left.  A span's elements are one contiguous stretch
// of the flat streams, [offsets[u0*B], offsets[u1*B]).  A small zero kernel
// clears z (cheaper than a memset node in a CUDA graph), then a CTA
//   1. starts copying its span*B + 1 offsets, pi, mask and the prices
//      with cp.async, reads the stretch's two ends and, if the stretch from
//      the 16-byte boundary at or below its start is at most cap long,
//      copies it too, by 16 bytes, all in flight at once, so the three-hop
//      chain runs in shared memory; a longer stretch (a user far longer
//      than the book's mean) takes the explicit branch that reads the
//      CTA's elements from device memory;
//   2. selects, one thread a user;
//   3. scatters the chosen elements into shared memory: for R <= 128 each
//      warp into its own (R,) tile without atomics (warp_add), above into
//      one (R,) tile with shared atomics (a CAS loop; few collide);
//   4. adds its tiles to z, one global atomicAdd a touched pool.
// R > 4,096 reads the prices from device memory and scatters straight into
// z with global atomics.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kZThreads = 512;

// One CTA's span plan, computed on the host (repro_torch/kernels/ops.py
// csr_z_plan) and passed as kPlanInts ints in this order.  Word offsets of
// the staged offsets, idx, val (cap elements each), pi, mask, the prices,
// the users' chosen bundles (sel) and the z tile (one a warp with z_mode
// kZWarpTiles).
struct CsrZPlan {
  int span, threads, stage_prices, z_mode, pv, cap;
  int off, idx, val, pi, mask, prices, sel, z, words;
};
constexpr int kPlanInts = 15;
static_assert(sizeof(CsrZPlan) == kPlanInts * sizeof(int), "CsrZPlan is the host's ints");
constexpr int kZGlobal = 0, kZTile = 1, kZWarpTiles = 2;  // CsrZPlan::z_mode

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Starts copying n consecutive 4-byte elements of g to s (16-byte aligned),
// consecutive threads on consecutive chunks: by 16 bytes where g is 16-byte
// aligned too, else by 4.
template <typename T>
__device__ void stage_flat(const T* __restrict__ g, int n, T* s) {
  int e = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    for (const int n4 = n / 4; e < n4; e += blockDim.x) cp_async16(s + 4 * e, g + 4 * e);
    e = n / 4 * 4 + threadIdx.x;
  }
  for (; e < n; e += blockDim.x) cp_async4(s + e, g + e);
}

// The same for rows x len elements, row q at s + q*stride (an odd stride:
// consecutive rows start on different banks).
template <typename T>
__device__ void stage_rows(const T* __restrict__ g, int rows, int len, int stride, T* s) {
  for (int e = threadIdx.x; e < rows * len; e += blockDim.x)
    cp_async4(s + e / len * stride + e % len, g + e);
}

// Adds x to tile[r] for every lane of a converged warp, without atomics:
// lanes that share a pool (__match_any_sync) add in turns by their rank
// among them, so each round touches a pool once; the rounds are the largest
// group.  Lanes with nothing to add pass a pool of -1 - lane.
__device__ __forceinline__ void warp_add(float* tile, int r, float x, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int rounds = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(rank)) + 1;
  for (int i = 0; i < rounds; ++i) {
    if (rank == i && r >= 0) tile[r] = __fadd_rn(tile[r], x);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kZThreads)
csr_z_kernel(const int* __restrict__ idx, const float* __restrict__ val,
             const int* __restrict__ offsets, const uint8_t* __restrict__ mask,
             const float* __restrict__ pi, int pi_vector, const float* __restrict__ prices,
             int U, int B, int k_bound, int R, CsrZPlan L, int* __restrict__ chosen,
             float* __restrict__ z) {
  extern __shared__ __align__(16) float smem[];
  int* s_off = reinterpret_cast<int*>(smem) + L.off;
  int* s_idx = reinterpret_cast<int*>(smem) + L.idx;
  float* s_val = smem + L.val;
  float* s_pi = smem + L.pi;
  float* s_prices = smem + L.prices;
  int* s_sel = reinterpret_cast<int*>(smem) + L.sel;
  float* s_z = smem + L.z;
  const int u0 = blockIdx.x * L.span;
  const int nu = min(L.span, U - u0);
  const size_t row0 = static_cast<size_t>(u0) * B;
  const int pi_len = pi_vector ? B : 1;
  const int t = threadIdx.x, nt = blockDim.x;

  // 1. stage the span's offsets, pi, mask and prices and, when it fits, its
  //    stretch of the streams; zero the z tiles
  stage_flat(offsets + row0, nu * B + 1, s_off);
  if (L.pv == pi_len) stage_flat(pi + static_cast<size_t>(u0) * pi_len, nu * pi_len, s_pi);
  else stage_rows(pi + static_cast<size_t>(u0) * pi_len, nu, pi_len, L.pv, s_pi);
  const uint8_t* mask0 = mask + row0;
  const int mshift = static_cast<int>(reinterpret_cast<uintptr_t>(mask0) & 3);
  const uint8_t* s_mask = reinterpret_cast<const uint8_t*>(smem + L.mask) + mshift;
  stage_flat(reinterpret_cast<const int*>(mask0 - mshift), (mshift + nu * B + 3) / 4,
             reinterpret_cast<int*>(smem + L.mask));
  if (L.stage_prices) stage_flat(prices, R, s_prices);
  // the stretch [base, end), staged from the 16-byte boundary at or below
  // base: element e lands at s_idx[e - (base & ~3)]
  const int base = offsets[row0], end = offsets[row0 + static_cast<size_t>(nu) * B];
  const int head = base & 3;
  const bool staged = end - base + head <= L.cap;
  if (staged) {
    stage_flat(idx + (base - head), end - base + head, s_idx);
    stage_flat(val + (base - head), end - base + head, s_val);
  }
  const int z_words = L.z_mode == kZWarpTiles ? nt / 32 * R : L.z_mode == kZTile ? R : 0;
  for (int r = t; r < z_words; r += nt) s_z[r] = 0.f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float* p = L.stage_prices ? s_prices : prices;
  // element e of the streams is I[e - base], V[e - base]: staged, or in
  // device memory (the explicit branch for a stretch longer than cap)
  const int* I = staged ? s_idx + head : idx + base;
  const float* V = staged ? s_val + head : val + base;

  // 2. select: one thread a user
  for (int q = t; q < nu; q += nt) {
    const int* ob = s_off + q * B;
    int bhat = 0;
    float best = 0.f;
    for (int b = 0; b < B; ++b) {
      const int s = ob[b] - base;
      const int c = min(ob[b + 1] - ob[b], k_bound);
      float cost = 0.f;
      if (c > 0) {
        cost = __fmul_rn(V[s], p[I[s]]);
        for (int k = 1; k < c; ++k) cost = __fmaf_rn(V[s + k], p[I[s + k]], cost);
      }
      float score;
      if (!pi_vector) {
        score = s_mask[q * B + b] ? cost : __int_as_float(0x7f800000);
        if (b == 0 || score < best) { best = score; bhat = b; }
      } else {
        score = s_mask[q * B + b] ? __fsub_rn(s_pi[q * L.pv + b], cost)
                                  : -__int_as_float(0x7f800000);
        if (b == 0 || score > best) { best = score; bhat = b; }
      }
    }
    const bool active = pi_vector ? best >= 0.f : best <= s_pi[q * L.pv];
    chosen[u0 + q] = active ? bhat : -1;
    s_sel[q] = active ? bhat : -1;
  }
  __syncthreads();

  // 3. scatter the chosen segments into the tiles
  if (L.z_mode == kZWarpTiles) {
    // each warp into its own tile, without atomics (R <= 128, where shared
    // atomics on few addresses serialize); the warp steps through its
    // longest chosen segment
    const int lane = t % 32;
    float* tile = s_z + t / 32 * R;
    for (int q0 = t - lane; q0 < nu; q0 += nt) {
      const int q = q0 + lane;
      const int bh = q < nu ? s_sel[q] : -1;
      const int s = bh >= 0 ? s_off[q * B + bh] - base : 0;
      const int c = bh >= 0 ? min(s_off[q * B + bh + 1] - s_off[q * B + bh], k_bound) : 0;
      const int steps = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(c));
      for (int k = 0; k < steps; ++k)
        warp_add(tile, k < c ? I[s + k] : -1 - lane, k < c ? V[s + k] : 0.f, lane);
    }
  } else {
    for (int q = t; q < nu; q += nt) {
      const int bh = s_sel[q];
      if (bh < 0) continue;
      const int s = s_off[q * B + bh] - base;
      const int c = min(s_off[q * B + bh + 1] - s_off[q * B + bh], k_bound);
      for (int k = 0; k < c; ++k) {
        if (L.z_mode == kZTile) atomicAdd(&s_z[I[s + k]], V[s + k]);
        else atomicAdd(&z[I[s + k]], V[s + k]);
      }
    }
  }
  if (L.z_mode == kZGlobal) return;
  __syncthreads();

  // 4. flush: one global atomic a touched pool (the warp tiles summed first)
  const int tiles = L.z_mode == kZWarpTiles ? nt / 32 : 1;
  for (int r = t; r < R; r += nt) {
    float x = s_z[r];
    for (int w = 1; w < tiles; ++w) x = __fadd_rn(x, s_z[w * R + r]);
    if (x != 0.f) atomicAdd(&z[r], x);
  }
}

// z = 0 ahead of the scatter (a kernel node: see the design note above)
__global__ void zero_kernel(float* __restrict__ z, int R) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R; r += gridDim.x * blockDim.x)
    z[r] = 0.f;
}

}  // namespace

extern "C" {

// plan: the host's span plan (kPlanInts ints, CsrZPlan's order).  A small
// launch zeroes z, then one of ceil(U / span) CTAs.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan of another length.
int sparse_bid_eval_csr_z(const int* idx, const float* val, const int* offsets,
                          const uint8_t* mask, const float* pi, int pi_vector,
                          const float* prices, int U, int B, int k_bound, int R, const int* plan,
                          int plan_len, int* chosen, float* z, void* stream_ptr) {
  static size_t allowed = 48 * 1024;
  if (plan_len != kPlanInts) return static_cast<int>(cudaErrorInvalidValue);
  CsrZPlan L;
  memcpy(&L, plan, sizeof(L));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (R > 0)
    zero_kernel<<<min((R + kZThreads - 1) / kZThreads, 1024), kZThreads, 0, stream>>>(z, R);
  const cudaError_t zeroed = cudaGetLastError();
  if (zeroed != cudaSuccess || U == 0) return static_cast<int>(zeroed);
  const size_t smem = sizeof(float) * L.words;
  if (smem > allowed) {  // raised once per size, before any capture into a CUDA graph
    const cudaError_t err = cudaFuncSetAttribute(
        csr_z_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  csr_z_kernel<<<(U + L.span - 1) / L.span, L.threads, smem, stream>>>(
      idx, val, offsets, mask, pi, pi_vector, prices, U, B, k_bound, R, L, chosen, z);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
