// Chunked RWKV-6 (WKV) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py (wkv6 -> _wkv6_kernel).
// Per (batch, head), over tokens t with decays w_t in (0, 1]:
//
//   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t          (K x V state)
//   o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
//
// computed a chunk of L tokens at a time in log space (cs = inclusive
// cumsum of log w down the chunk, cs_ex[t] = cs[t-1], cs_ex[0] = 0):
//
//   o_t    = (r_t ⊙ e^{cs_ex[t]}) · S
//            + Σ_{s<t} [Σ_k r_t[k] k_s[k] e^{cs_ex[t,k] - cs[s,k]}] v_s
//            + (r_t ⊙ u · k_t) v_t
//   S_next = diag(e^{cs[L-1]}) S + (k ⊙ e^{cs[L-1] - cs})ᵀ v
//
// Every exponent is <= 0, so nothing overflows for strong decay (splitting
// e^{cs_ex - cs} into e^{cs_ex}·e^{-cs} would).  Same algebra as the plain
// version, ref.wkv6_chunked; no bitwise contract, float tolerance only.
//
// Grid and tiles.  One CTA of 256 threads owns one (batch, head) and a
// block of up to 64 columns of V, and walks the chunks in a loop: the TPU
// grid's sequential chunk axis.  At the served shape (B = 4, H = 64,
// K = V = 64) that is 256 CTAs on 132 SMs, two resident on each.  A chunk
// is one tile of 32 rows by 64 k: L <= 32 tokens and K <= 64 are padded in
// shared memory (r = k = v = 0 and log w = 0 on padding, which leaves every
// sum unchanged), and no o row or column outside the input is written.
// Inputs are read in place from their (B, T, H, ·) layout; r, k, v come in
// as float32 or bfloat16, w, u and the state as float32; all arithmetic is
// float32 on CUDA cores (logf/expf, no fast math, no tensor cores).
//
// What bounds it: at the served prefill (B = 4, T = 500, H = 64, K = V = 64,
// L = 32) the float32 FMAs, the exponentials and logs, and the bytes set the
// bound about equally (~40 us; chip_smoke.py computes it from each run's
// shapes).  The first version of this kernel was bound instead by
// shared-memory loads: every FMA of the output and state products read two
// operands from shared memory.  This design:
//   * register tiles: each thread owns a 4 x 4 tile of S in registers for
//     the whole sequence (the state update reads a float4 of decayed k and a
//     float4 of v per 16 FMAs) and a 2 x 4 tile of the chunk's outputs (a
//     float2 of decayed r or scores and a float4 of S or v per 8 FMAs); the
//     operands sit in shared arrays laid out for those vector loads, and S
//     is copied to shared memory once a chunk for the output product;
//   * overlapped loads: two staging buffers; chunk c+2's r, k, v and w go
//     in by cp.async (16-byte pieces, zero registers) while chunk c and c+1
//     are in flight, and cp.async.wait_group replaces the load barrier;
//   * four barriers a chunk instead of six: the cumsum runs as 4 segments of
//     8 rows a k column (all 256 threads, fused with the conversion of the
//     staged tiles), the scores and the decayed r and k share one step;
//   * the strictly lower-triangular decayed scores, one (t, s) pair to four
//     threads, each a quarter of k, summed by two shuffles.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 32;                // tile rows: a chunk of L <= 32 tokens
constexpr int kK = 64;                // tile k: K <= 64
constexpr int kV = 64;                // columns of V per CTA
constexpr int kRS = kK + 4;           // row stride of r, k, cs, decayed k: float4 rows, 4 banks apart
constexpr int kSeg = 8;               // cumsum segment rows
constexpr int kPairs = kL * (kL + 1) / 2;  // (t, s) pairs with s <= t
static_assert(kThreads == kK * (kL / kSeg), "one thread per (k, cumsum segment)");
static_assert(kThreads == (kL / 2) * (kV / 4) && kThreads == (kK / 4) * (kV / 4), "tiles");
static_assert(kPairs % 8 == 0, "a warp's eight quads stay in the pair loop together");

// floats of the compute arrays, each a multiple of 4
constexpr int kRf = 0;                          // (kL, kRS): r
constexpr int kKf = kRf + kL * kRS;             // (kL, kRS): k
constexpr int kCs = kKf + kL * kRS;             // (kL + 1, kRS): row t+1 = cs[t], row 0 = 0
constexpr int kVf = kCs + ((kL + 1) * kRS + 3) / 4 * 4;  // (kL, kV): v
constexpr int kRd = kVf + kL * kV;              // (kK, kL): r ⊙ e^{cs_ex}, transposed
constexpr int kKd = kRd + kK * kL;              // (kL, kRS): k ⊙ e^{cs[L-1] - cs}
constexpr int kAt = kKd + kL * kRS;             // (kL, kL): scores, transposed [s][t]
constexpr int kSt = kAt + kL * kL;              // (kK, kV): the state at the chunk's start
constexpr int kSegTot = kSt + kK * kV;          // (4, kK): cumsum segment totals
constexpr int kEtot = kSegTot + (kL / kSeg) * kK;  // (kK): e^{cs[L-1]}
constexpr int kU = kEtot + kK;                  // (kK): u
constexpr int kFloats = kU + kK;

template <typename In>
__host__ __device__ constexpr size_t stage_bytes() {  // one staging buffer: r, k, v in their type, w float32
  return 3 * static_cast<size_t>(kL) * kK * sizeof(In) + static_cast<size_t>(kL) * kK * 4;
}
template <typename In>
__host__ __device__ constexpr size_t smem_bytes() { return 2 * stage_bytes<In>() + sizeof(float) * kFloats; }

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename In>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_kernel(const In* __restrict__ r, const In* __restrict__ k, const In* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, int T, int H, int K, int V, int L, int async,
            float* __restrict__ o, float* __restrict__ s_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTile = kL * kK;
  float* f = reinterpret_cast<float*>(smem + 2 * stage_bytes<In>());
  float* rf = f + kRf;
  float* kf = f + kKf;
  float* csx = f + kCs;
  float* vf = f + kVf;
  float* rd = f + kRd;
  float* kd = f + kKd;
  float* at = f + kAt;
  float* st = f + kSt;
  float* segtot = f + kSegTot;
  float* etot = f + kEtot;
  float* us = f + kU;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * kV;
  const int vb = min(kV, V - v0);
  const int tid = threadIdx.x;
  const int n_chunks = (T + L - 1) / L;

  // the staging buffer of chunk c; rows past the chunk's tokens stay stale
  // and are masked when converted
  auto staged = [&](int c, In*& rr, In*& kr, In*& vr, float*& wr) {
    rr = reinterpret_cast<In*>(smem + (c & 1) * stage_bytes<In>());
    kr = rr + kTile;
    vr = kr + kTile;
    wr = reinterpret_cast<float*>(vr + kTile);
  };
  auto prefetch = [&](int c) {
    if (c >= n_chunks) return;
    const int t0 = c * L, rows = min(L, T - t0);
    In *rr, *kr, *vr;
    float* wr;
    staged(c, rr, kr, vr, wr);
    const size_t row0 = (static_cast<size_t>(b) * T + t0) * H + h;  // token t: row0 + t*H
    if (async) {
      constexpr int per = 16 / sizeof(In);
      const int nk = K / per, nv = vb / per, nw = K / 4;
      for (int e = tid; e < rows * nk; e += kThreads) {
        const int t = e / nk, q = e % nk;
        const size_t g = (row0 + static_cast<size_t>(t) * H) * K + q * per;
        cp_async16(rr + t * kK + q * per, r + g);
        cp_async16(kr + t * kK + q * per, k + g);
      }
      for (int e = tid; e < rows * nv; e += kThreads) {
        const int t = e / nv, q = e % nv;
        cp_async16(vr + t * kV + q * per, v + (row0 + static_cast<size_t>(t) * H) * V + v0 + q * per);
      }
      for (int e = tid; e < rows * nw; e += kThreads) {
        const int t = e / nw, q = e % nw;
        cp_async16(wr + t * kK + q * 4, w + (row0 + static_cast<size_t>(t) * H) * K + q * 4);
      }
    } else {  // unaligned rows: plain loads
      for (int e = tid; e < rows * K; e += kThreads) {
        const int t = e / K, kk = e % K;
        const size_t g = (row0 + static_cast<size_t>(t) * H) * K + kk;
        rr[t * kK + kk] = r[g];
        kr[t * kK + kk] = k[g];
        wr[t * kK + kk] = w[g];
      }
      for (int e = tid; e < rows * vb; e += kThreads) {
        const int t = e / vb, vv = e % vb;
        vr[t * kV + vv] = v[(row0 + static_cast<size_t>(t) * H) * V + v0 + vv];
      }
    }
  };

  prefetch(0);
  cp_async_commit();
  prefetch(1);
  cp_async_commit();

  // this thread's 4 x 4 tile of S: rows 4kq.., columns 4vq..
  const int kq = tid / 16, vq = tid % 16;
  float S[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 4 * kq + i, vv = 4 * vq + j;
      S[i][j] = (s0 != nullptr && kk < K && vv < vb)
                    ? s0[(static_cast<size_t>(bh) * K + kk) * V + v0 + vv] : 0.f;
    }
  if (tid < kK) {
    us[tid] = tid < K ? u[h * K + tid] : 0.f;
    csx[tid] = 0.f;
  }
  for (int i = tid; i < kL * kL; i += kThreads) at[i] = 0.f;  // s > t stays 0

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L, rows = min(L, T - t0);
    cp_async_wait_all_but_one();
    __syncthreads();  // chunk c is staged; chunk c-1 is done with every array

    // 1. S to shared memory; the staged tiles to float32, masked; log w and
    //    its prefix within this thread's 8-row segment of one k column
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(st + (4 * kq + i) * kV + 4 * vq) =
          make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
    {
      In *rr, *kr, *vr;
      float* wr;
      staged(c, rr, kr, vr, wr);
      for (int e = tid; e < kTile; e += kThreads) {
        const int t = e / kK, kk = e % kK;
        const bool live = t < rows && kk < K;
        rf[t * kRS + kk] = live ? load_f(rr + e) : 0.f;
        kf[t * kRS + kk] = live ? load_f(kr + e) : 0.f;
      }
      for (int e = tid; e < kL * kV; e += kThreads) {
        const int t = e / kV, vv = e % kV;
        vf[e] = (t < rows && vv < vb) ? load_f(vr + e) : 0.f;
      }
    }
    const int ck = tid % kK, seg = tid / kK;
    float pre[kSeg];
    {
      In *rr, *kr, *vr;
      float* wr;
      staged(c, rr, kr, vr, wr);
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int t = seg * kSeg + i;
        run += (t < rows && ck < K) ? logf(fmaxf(wr[t * kK + ck], 1e-38f)) : 0.f;
        pre[i] = run;
      }
      segtot[seg * kK + ck] = run;
    }
    __syncthreads();  // the staging buffer is consumed

    // 2. start chunk c+2's loads into it; finish the cumsum
    prefetch(c + 2);
    cp_async_commit();
    {
      float off = 0.f;
      for (int j = 0; j < seg; ++j) off += segtot[j * kK + ck];
#pragma unroll
      for (int i = 0; i < kSeg; ++i) csx[(seg * kSeg + i + 1) * kRS + ck] = off + pre[i];
    }
    __syncthreads();

    // 3a. scores at[s][t] for s <= t < rows: four threads a pair, a quarter
    //     of k each (float4 groups q, q+4, q+8, q+12)
    {
      const int quarter = tid & 3;
      for (int p = tid / 4; p < kPairs; p += kThreads / 4) {
        int t = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
        while (t * (t + 1) / 2 > p) --t;
        while ((t + 1) * (t + 2) / 2 <= p) ++t;
        const int s = p - t * (t + 1) / 2;
        float acc = 0.f;
        if (t < rows) {
          const float* rt = rf + t * kRS;
          const float* ks = kf + s * kRS;
          if (s == t) {  // the diagonal bonus r_t ⊙ u · k_t
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int kk = 4 * (quarter + 4 * j);
              const float4 a = ld4(rt + kk), bk = ld4(ks + kk), uu = ld4(us + kk);
              acc = fmaf(a.x * uu.x, bk.x, acc);
              acc = fmaf(a.y * uu.y, bk.y, acc);
              acc = fmaf(a.z * uu.z, bk.z, acc);
              acc = fmaf(a.w * uu.w, bk.w, acc);
            }
          } else {
            const float* cet = csx + t * kRS;        // cs_ex[t]
            const float* css = csx + (s + 1) * kRS;  // cs[s]
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int kk = 4 * (quarter + 4 * j);
              const float4 a = ld4(rt + kk), bk = ld4(ks + kk);
              const float4 e1 = ld4(cet + kk), e2 = ld4(css + kk);
              acc = fmaf(a.x * bk.x, expf(fminf(e1.x - e2.x, 0.f)), acc);
              acc = fmaf(a.y * bk.y, expf(fminf(e1.y - e2.y, 0.f)), acc);
              acc = fmaf(a.z * bk.z, expf(fminf(e1.z - e2.z, 0.f)), acc);
              acc = fmaf(a.w * bk.w, expf(fminf(e1.w - e2.w, 0.f)), acc);
            }
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (quarter == 0) at[s * kL + t] = acc;
      }
    }
    // 3b. decayed r (transposed) and k: lane = row, a float4 group of k
    {
      const int t = tid % 32;
      for (int j = tid / 32; j < kK / 4; j += kThreads / 32) {
        const int kk = 4 * j;
        const float4 rv = ld4(rf + t * kRS + kk), kv = ld4(kf + t * kRS + kk);
        const float4 ce = ld4(csx + t * kRS + kk), cs = ld4(csx + (t + 1) * kRS + kk);
        const float4 tot = ld4(csx + kL * kRS + kk);
        rd[(kk + 0) * kL + t] = rv.x * expf(ce.x);
        rd[(kk + 1) * kL + t] = rv.y * expf(ce.y);
        rd[(kk + 2) * kL + t] = rv.z * expf(ce.z);
        rd[(kk + 3) * kL + t] = rv.w * expf(ce.w);
        *reinterpret_cast<float4*>(kd + t * kRS + kk) =
            make_float4(kv.x * expf(tot.x - cs.x), kv.y * expf(tot.y - cs.y),
                        kv.z * expf(tot.z - cs.z), kv.w * expf(tot.w - cs.w));
      }
      if (tid < kK) etot[tid] = expf(csx[kL * kRS + tid]);
    }
    __syncthreads();

    // 4a. outputs: rows 2tq, 2tq+1 and columns 4vq.. of the chunk
    {
      const int tq = tid / 16;
      float acc[2][4] = {};
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) {
        const float2 a = ld2(rd + kk * kL + 2 * tq);
        const float4 sv = ld4(st + kk * kV + 4 * vq);
        acc[0][0] = fmaf(a.x, sv.x, acc[0][0]);
        acc[0][1] = fmaf(a.x, sv.y, acc[0][1]);
        acc[0][2] = fmaf(a.x, sv.z, acc[0][2]);
        acc[0][3] = fmaf(a.x, sv.w, acc[0][3]);
        acc[1][0] = fmaf(a.y, sv.x, acc[1][0]);
        acc[1][1] = fmaf(a.y, sv.y, acc[1][1]);
        acc[1][2] = fmaf(a.y, sv.z, acc[1][2]);
        acc[1][3] = fmaf(a.y, sv.w, acc[1][3]);
      }
      for (int s = 0; s <= 2 * tq + 1; ++s) {
        const float2 a = ld2(at + s * kL + 2 * tq);
        const float4 vv = ld4(vf + s * kV + 4 * vq);
        acc[0][0] = fmaf(a.x, vv.x, acc[0][0]);
        acc[0][1] = fmaf(a.x, vv.y, acc[0][1]);
        acc[0][2] = fmaf(a.x, vv.z, acc[0][2]);
        acc[0][3] = fmaf(a.x, vv.w, acc[0][3]);
        acc[1][0] = fmaf(a.y, vv.x, acc[1][0]);
        acc[1][1] = fmaf(a.y, vv.y, acc[1][1]);
        acc[1][2] = fmaf(a.y, vv.z, acc[1][2]);
        acc[1][3] = fmaf(a.y, vv.w, acc[1][3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 2 * tq + i;
        if (t >= rows) continue;
        float* orow = o + ((static_cast<size_t>(b) * T + t0 + t) * H + h) * V + v0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * vq + j < vb) orow[4 * vq + j] = acc[i][j];
      }
    }
    // 4b. the state for the next chunk, in registers
    {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = etot[4 * kq + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) S[i][j] *= e;
      }
#pragma unroll 4
      for (int t = 0; t < kL; ++t) {
        const float4 kv = ld4(kd + t * kRS + 4 * kq);
        const float4 vv = ld4(vf + t * kV + 4 * vq);
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w}, va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) S[i][j] = fmaf(ka[i], va[j], S[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 4 * kq + i, vv = 4 * vq + j;
      if (kk < K && vv < vb) s_out[(static_cast<size_t>(bh) * K + kk) * V + v0 + vv] = S[i][j];
    }
}

template <typename In>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, int B, int T, int H, int K, int V, int L, float* o, float* s_out,
           cudaStream_t stream) {
  if (K < 1 || K > kK || L < 1 || L > kL) return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB a block's dynamic shared memory must be allowed first, once,
  // before any capture into a CUDA graph (the first call runs outside one).
  constexpr size_t smem = smem_bytes<In>();
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  // cp.async moves 16-byte pieces: every row must start on a 16-byte boundary
  constexpr int per = 16 / sizeof(In);
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int async = K % per == 0 && V % per == 0 && K % 4 == 0 && aligned(r) && aligned(k) &&
                    aligned(v) && aligned(w);
  const dim3 grid(B * H, (V + kV - 1) / kV);
  wkv6_kernel<In><<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(r), static_cast<const In*>(k), static_cast<const In*>(v), w, u, s0,
      T, H, K, V, L, async, o, s_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, w (B, T, H, K) and v (B, T, H, V), contiguous; r, k, v float32
// (bf16 = 0) or bfloat16 (bf16 = 1); w float32; u (H, K) float32; s0
// (B, H, K, V) float32 or null for zeros; chunk length L, 1 <= L <= T.
// K <= 64 and L <= 32 (one tile), any V.  Writes o (B, T, H, V) and s_out
// (B, H, K, V), float32.  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for K or L outside the tile, or the error of raising
// the block's dynamic shared-memory limit.
int wkv6(const void* r, const void* k, const void* v, const float* w, const float* u,
         const float* s0, int B, int T, int H, int K, int V, int L, int bf16, float* o,
         float* s_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, B, T, H, K, V, L, o, s_out, stream);
  return launch<float>(r, k, v, w, u, s0, B, T, H, K, V, L, o, s_out, stream);
}

}  // extern "C"
