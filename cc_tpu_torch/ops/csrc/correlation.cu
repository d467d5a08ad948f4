// Local correlation cost volume, forward and backward, fp32 and bf16, for
// Hopper (sm_90a).
//
// FORWARD. Replaces the TPU kernel cc_tpu/ops/correlation_pallas.py::_forward
// (body _corr_kernel). For f1, f2 of shape [B,H,W,C] (NHWC, C innermost):
//
//   out[b,h,w,pi*P+pj] = (1/C) * sum_c f1[b,h,w,c]
//                                     * f2[b, h+(pi-P/2)*d, w+(pj-P/2)*d, c]
//
// with f2 read as 0 out of bounds; out is [B,H,W,P*P].
//
// Bound. A launch must read f1 and f2 once and write the cost volume once,
// 4*(2C + P*P) bytes a pixel, and do 2*P*P*C operations a pixel. At
// Back2Future's five shapes (P=9, d=1, [4,64,208,32] .. [4,4,13,192]) that
// is bytes: 30.9 MB at level 2 against 0.28 GFLOP. At FlowNetC6's
// ([4,32,104,256], P=21, d=2) it is operations: 3.0 GFLOP against 51 MB.
//
// Why CUDA cores and not tensor cores: for one displacement row the forward
// is a banded product, [TW x C] times [C x (TW+P-1)], of which only the P
// diagonals are wanted; a dense product over the band does (TW+P-1)/P times
// the useful work (3.6x at 56 pixels, P=21), and the port runs fp32 held to
// 1e-5, which 3xTF32 would triple again. So the sums are fp32 FMAs, and the
// design keeps the FMA units fed from registers, where one shared-memory
// load fed one FMA before:
//
// 1. A block is one residue class, one image row and one displacement row:
//    pixels x = r + d*m of one residue r (mod d) form a dilation-1 problem
//    in m, so a block stages TW consecutive m of f1's row h and the TW + P
//    - 1 columns of its class in f2's row h + (pi-P/2)*d, the halo
//    included. A block whose f2 row lies outside the image stages nothing
//    and writes its zeros.
// 2. A register tile along the diagonal. A thread owns NP consecutive m and
//    all P taps of row pi, NP*P sums. Its pixel i at tap j reads staged
//    column s = i + j, so for each channel quad it loads its NP f1 float4s
//    once, then each of the NP + P - 1 columns' float4 once, and does 4
//    FMAs for every live (s, i): 4*NP*P FMAs for 2*NP + P - 1 sixteen-byte
//    loads (336 for 28 at P=21, NP=4; 288 for 24 at P=9, NP=8). The loops
//    unroll fully, since which (s, i) pairs are live is fixed by P and NP.
// 3. Channels across the lanes of a pixel group, reduced by warp shuffles.
//    KG consecutive lanes share a pixel group, and lane k sums channel quad
//    k of every chunk of CK = 4*KG channels. After the last chunk the NP*P
//    sums are reduced over the KG lanes by a butterfly of __shfl_xor_sync,
//    log2(KG) rounds that each halve what a lane holds: a lane sends the
//    half its partner keeps and adds the half it keeps, so the group moves
//    about NP*P*(KG-1) values, not NP*P*KG*log2(KG) as a full butterfly
//    would. The order of every sum is fixed, so the bits are the same on
//    every run. The sums then pass through shared memory once, so that
//    consecutive threads write consecutive floats of the output. No
//    shared-memory reduction, no atomics, nothing across blocks.
// 4. Overlapped staging: two buffers, each f1's [TW x CK] and f2's [(TW+P-1)
//    x CK]; chunk k+1 goes in by cp.async (16-byte copies, 4-byte ones when
//    C % 4 != 0 or an input is not 16-byte aligned; channels past C
//    zero-filled) while chunk k computes, with one barrier per chunk.
// 5. Tiles by shape, in fwd_shape: wide rows take TW = 56 (52 of
//    FlowNetC6's 104 pixels a residue) with NP = 8 up to P = 9 and NP = 4
//    above, near 84 sums a thread; rows of at most 32 pixels a residue
//    (Back2Future's levels 5-6) take NP = 2 and TW = 16, so that
//    [4,4,13,192] still has 144 blocks; KG = 8, or 16 on narrow rows of
//    more than 64 channels, which halves their chain of chunks.
//
// BACKWARD. Replaces cc_tpu/ops/correlation_pallas.py::_corr_bwd, the
// custom_vjp backward of the Pallas kernel (XLA there). For the output
// gradient g [B,H,W,P*P] and dvec(d) = ((pi-P/2)*dil, (pj-P/2)*dil):
//
//   df1[b,y,x,c] = (1/C) sum_d g[b,y,x,d] * f2[b, (y,x) + dvec(d), c]
//   df2[b,y,x,c] = (1/C) sum_d g[b, (y,x) - dvec(d), d] * f1[b, (y,x) - dvec(d), c]
//
// with terms outside the image 0. Both are gathers: each output element is
// summed by one thread, in registers, in a fixed order, with no atomics, so
// the result is the same on every run. df1 and df2 run in one launch.
//
// Bound. A launch must read f1, f2 and g once and write df1 and df2 once,
// 4*(4C + P*P) bytes a pixel, and do 4*P*P*C operations a pixel. At
// FlowNetC6's shape ([4,32,104,256], P=21, d=2) that is operations: 6.0
// GFLOP against 78 MB. At Back2Future's five shapes (P=9, d=1, C=32..192)
// it is bytes.
//
// Why CUDA cores and not tensor cores: the port runs fp32 and holds the
// kernel to 1e-5 of its plain version. A row's df1 is a banded product
// ([pixels x span] with P live diagonals, d apart, times [span x C]); a
// dense product over the band would do span/P times the useful work (5x at
// 64 pixels, P=21, d=2), and 3xTF32 to keep fp32 accuracy triples it again.
// So the sums are fp32 FMAs, and the design keeps the FMA units fed from
// registers:
//
// 1. Register tile along the diagonal. Pixels x = r + d*m of one residue r
//    (mod d) form a dilation-1 problem in m: a block takes one residue
//    class, TW consecutive m of one image row, and stages only the columns
//    of that class (TW + P - 1 of them, the halo included). A thread owns NP
//    consecutive m and NC channels, NP*NC sums in registers. Within a
//    displacement row pi, its pixel i at tap j reads staged column s = i + j,
//    so one column's NC values, loaded once from shared memory (16-byte
//    loads), serve every pixel i with 0 <= s - i < P, one g value each:
//    NP*NC FMAs for NC + NP loads, where one load fed one FMA before. df2 is
//    the mirror image: staged column s is the source pixel of tap P-1-(s-i),
//    and g is read there.
// 2. Wide channel blocks. A block's threads cover CB = NC*CG channels (32
//    to 256), so one staged row of g serves them all, where a block of 16
//    channels staged it again for every 16.
// 3. Overlapped staging. Two shared-memory buffers; the value row and the g
//    row of displacement row pi+1 go in by cp.async while row pi computes,
//    with one barrier per row. Rows outside the image are skipped whole.
// 4. Tiles by shape, in launch_bwd: wide rows take NP = 7 (TW = 56: 52 of
//    FlowNetC6's 104 pixels a residue, 93% of the lanes live) and a channel
//    block by C; narrow rows (at most 32 pixels a residue, Back2Future's
//    levels 5-6) take NP = 2, so that the grid still fills the 132 SMs.
//    W, C and H off the tile are masked in the kernel.
//
// The values are still staged once per displacement row (the one-row
// structure): at FlowNetC6's shape that is about 0.6 GB from L2 into shared
// memory per launch, against 78 MB read and written once in device memory.
//
// BF16. Both kernels are templates on the element type T of f1, f2, g and
// the outputs: float, or __nv_bfloat16 (under cc_tpu's compute_dtype
// bfloat16 the correlation runs on bf16 features, correlation_pallas.py:
// 102-103). The float instantiations are the code above. A bf16 launch
// stages bf16 (16-byte copies of 8 channels, so a forward chunk holds 8*KG
// channels where a float one holds 4*KG, in the same bytes), widens to
// float where it reads shared memory, sums in float in the same fixed order
// and rounds once, at the store. Where C % 8 != 0 or an input is not
// 16-byte aligned, it stages element by element with plain loads (cp.async
// moves 4 bytes at least); the backward's g is widened as it is staged, so
// its rows are floats in shared memory for either type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

using bf16 = __nv_bfloat16;

// Channels in one 16-byte copy of T.
template <typename T>
constexpr int VEC = 16 / sizeof(T);

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (std::is_same_v<T, float>)
    return x;
  else
    return __float2bfloat16_rn(x);
}

// Eight bf16 channels, one 16-byte load, widened to float.
__device__ __forceinline__ void widen8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Four bf16 channels, one 8-byte load, widened to float.
__device__ __forceinline__ void widen4(const bf16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// The forward's tiles: NP pixels (of one residue class) a thread, KG lanes
// a pixel group, NPG pixel groups a block (head note, points 1-4), for
// element type E.
template <typename E, int P, int NP, int KG, int NPG>
struct FwdTile {
  static constexpr int R = P / 2;
  static constexpr int TW = NPG * NP;       // pixels (of one residue) a block
  static constexpr int SPAN = TW + P - 1;   // staged f2 columns, halo included
  static constexpr int CK = VEC<E> * KG;    // channels a chunk
  static constexpr int THREADS = NPG * KG;
  static constexpr int V = NP * P;          // sums a thread
  // one buffer: f1 [TW][CK], then f2 [SPAN][CK], elements of E
  static constexpr int BUF = (TW + SPAN) * CK;
};

// Start the copies of one chunk (channels c0 .. c0+CK-1) into one buffer:
// f1's row at the block's TW pixels, then f2's row at its SPAN columns.
// Zero outside the image and past C.
template <typename E, int P, int NP, int KG, int NPG>
__device__ __forceinline__ void fwd_stage(
    E* buf, const E* __restrict__ row1, const E* __restrict__ row2,
    const E* __restrict__ any, int r, int m0, int W, int C, int c0,
    int dil, bool vec) {
  using T = FwdTile<E, P, NP, KG, NPG>;
  constexpr int V16 = VEC<E>;
  const int t = threadIdx.x;
  if (vec) {  // 16-byte copies: KG of them a staged column
    for (int e = t; e < (T::TW + T::SPAN) * KG; e += T::THREADS) {
      const int u = e / KG, q = e % KG;
      const bool first = u < T::TW;
      const int m = first ? m0 + u : m0 - T::R + (u - T::TW);
      const int x = r + dil * m, c = c0 + V16 * q;
      const bool ok = m >= 0 && x < W && c < C;
      cp_async16(buf + V16 * e,
                 ok ? (first ? row1 : row2) + (long long)x * C + c : any, ok);
    }
  } else {
    for (int e = t; e < (T::TW + T::SPAN) * T::CK; e += T::THREADS) {
      const int u = e / T::CK, k = e % T::CK;
      const bool first = u < T::TW;
      const int m = first ? m0 + u : m0 - T::R + (u - T::TW);
      const int x = r + dil * m, c = c0 + k;
      const bool ok = m >= 0 && x < W && c < C;
      if constexpr (std::is_same_v<E, float>)
        cp_async4(buf + e,
                  ok ? (first ? row1 : row2) + (long long)x * C + c : any, ok);
      else
        buf[e] = ok ? (first ? row1 : row2)[(long long)x * C + c]
                    : __float2bfloat16_rn(0.f);
    }
  }
}

// One chunk's sums for a thread: its NP pixels (staged f1 rows a .. a+NP-1,
// staged f2 columns a .. a+NP+P-2) at channel quad `lane` of the chunk (an
// octet in bf16). acc[i*P + j] is pixel i at tap j.
template <int P, int NP, int KG, int NPG>
__device__ __forceinline__ void fwd_chunk(const float* buf, int a, int lane,
                                          float (&acc)[NP * P]) {
  using T = FwdTile<float, P, NP, KG, NPG>;
  const float* s1 = buf + a * T::CK + 4 * lane;
  const float* s2 = buf + (T::TW + a) * T::CK + 4 * lane;
  float4 f[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i)
    f[i] = *reinterpret_cast<const float4*>(s1 + i * T::CK);
#pragma unroll
  for (int s = 0; s < NP + P - 1; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(s2 + s * T::CK);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int j = s - i;  // the tap of pixel i that reads column s
      if (j < 0 || j >= P) continue;
      float& x = acc[i * P + j];
      x = fmaf(f[i].x, v.x, x);
      x = fmaf(f[i].y, v.y, x);
      x = fmaf(f[i].z, v.z, x);
      x = fmaf(f[i].w, v.w, x);
    }
  }
}

template <int P, int NP, int KG, int NPG>
__device__ __forceinline__ void fwd_chunk(const bf16* buf, int a, int lane,
                                          float (&acc)[NP * P]) {
  using T = FwdTile<bf16, P, NP, KG, NPG>;
  const bf16* s1 = buf + a * T::CK + 8 * lane;
  const bf16* s2 = buf + (T::TW + a) * T::CK + 8 * lane;
  float f[NP][8];
#pragma unroll
  for (int i = 0; i < NP; ++i) widen8(s1 + i * T::CK, f[i]);
#pragma unroll
  for (int s = 0; s < NP + P - 1; ++s) {
    float v[8];
    widen8(s2 + s * T::CK, v);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int j = s - i;  // the tap of pixel i that reads column s
      if (j < 0 || j >= P) continue;
      float& x = acc[i * P + j];
#pragma unroll
      for (int k = 0; k < 8; ++k) x = fmaf(f[i][k], v[k], x);
    }
  }
}

// The number of values a lane holds after each round halves it: (n+1)/2
// for every round of a butterfly over KG lanes.
__host__ __device__ constexpr int halved(int n, int kg) {
  return kg > 1 ? halved((n + 1) / 2, kg / 2) : n;
}

// Sum a lane's N values v[0..N) over the lanes of its group whose index
// differs in bits M, M/2, .., 1, leaving each lane the total of a part: a
// round splits the values in halves, a lane with bit M keeps the upper half
// and sends the lower one, its partner the other way round, and each adds
// what it received to what it kept. Logical value lo + s is in v[s] for
// lo + s < hi afterwards (v[s] is garbage otherwise); the order of every
// sum is fixed.
template <int N, int M, int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane,
                                               unsigned group, int& lo,
                                               int& hi) {
  if constexpr (M >= 1) {
    constexpr int H = (N + 1) / 2;
    const bool upper = lane & M;
#pragma unroll
    for (int s = 0; s < H; ++s) {
      const float a = v[s];
      const float b = s + H < N ? v[s + H] : 0.f;
      const float keep = upper ? b : a;
      v[s] = keep + __shfl_xor_sync(group, upper ? a : b, M);
    }
    if (upper)
      lo += H;
    else
      hi = min(hi, lo + H);
    reduce_scatter<H, M / 2>(v, lane, group, lo, hi);
  }
}

// Grid: x = residue r (mod dil) times column tile, y = image row h,
// z = (batch, displacement row pi).
template <typename E, int P, int NP, int KG, int NPG>
__global__ void __launch_bounds__(NPG * KG)
corr_fwd_kernel(const E* __restrict__ f1, const E* __restrict__ f2,
                E* __restrict__ out, int H, int W, int C, int dil,
                float inv_c, bool vec) {
  using T = FwdTile<E, P, NP, KG, NPG>;
  constexpr int R = T::R;
  extern __shared__ __align__(16) float fwd_smem[];
  E* const stage = reinterpret_cast<E*>(fwd_smem);

  const int ntile = ((W + dil - 1) / dil + T::TW - 1) / T::TW;
  const int r = blockIdx.x / ntile;
  const int m0 = (blockIdx.x % ntile) * T::TW;
  const int wr = (W - r + dil - 1) / dil;  // pixels of residue r in a row
  if (m0 >= wr) return;  // the same for the whole block
  const int h = blockIdx.y;
  const int b = blockIdx.z / P;
  const int pi = blockIdx.z % P;
  const int y2 = h + (pi - R) * dil;
  const bool live = y2 >= 0 && y2 < H;  // the same for the whole block
  const int t = threadIdx.x;
  const int lane = t % KG;
  const int a = (t / KG) * NP;  // the group's first pixel in the tile
  float* so = fwd_smem;         // [TW][P] after the last chunk

  if (live) {
    const E* row1 = f1 + ((long long)b * H + h) * W * C;
    const E* row2 = f2 + ((long long)b * H + y2) * W * C;
    float acc[T::V];
#pragma unroll
    for (int i = 0; i < T::V; ++i) acc[i] = 0.f;
    const int nchunk = (C + T::CK - 1) / T::CK;
    fwd_stage<E, P, NP, KG, NPG>(stage, row1, row2, f1, r, m0, W, C, 0, dil,
                                 vec);
    cp_async_commit();
    for (int k = 0; k < nchunk; ++k) {
      cp_async_wait_all();  // this thread's copies of chunk k have landed
      __syncthreads();      // everyone's have, and chunk k-1's buffer is free
      if (k + 1 < nchunk)
        fwd_stage<E, P, NP, KG, NPG>(stage + ((k + 1) & 1) * T::BUF, row1,
                                     row2, f1, r, m0, W, C, (k + 1) * T::CK,
                                     dil, vec);
      cp_async_commit();
      fwd_chunk<P, NP, KG, NPG>(stage + (k & 1) * T::BUF, a, lane, acc);
    }
    // the group's KG lanes, aligned within the warp
    const unsigned group = ((1u << KG) - 1) << (t % 32 / KG * KG);
    int lo = 0, hi = T::V;
    reduce_scatter<T::V, KG / 2>(acc, lane, group, lo, hi);
    __syncthreads();  // everyone is done with the last chunk's buffer
    constexpr int HELD = halved(T::V, KG);
#pragma unroll
    for (int s = 0; s < HELD; ++s)
      if (lo + s < hi) so[a * P + lo + s] = acc[s] * inv_c;
    __syncthreads();
  }

  // consecutive threads write consecutive floats of each pixel's P outputs
  const int npix = min(T::TW, wr - m0);
  E* orow = out + ((long long)b * H + h) * W * (P * P) + pi * P;
  for (int e = t; e < npix * P; e += T::THREADS) {
    const int p = e / P, j = e - p * P;
    orow[(long long)(r + dil * (m0 + p)) * (P * P) + j] =
        narrow<E>(live ? so[e] : 0.f);
  }
}

// The backward's tiles (see the head note): NC channels a thread and PX
// pixel groups a block; NP pixels a group and CG channel groups a block
// are template parameters.
constexpr int NC = 8;
constexpr int PX = 8;

template <typename E, int P, int NP, int CG>
struct BwdTile {
  static constexpr int R = P / 2;
  static constexpr int TW = PX * NP;        // pixels (of one residue) a block
  static constexpr int SPAN = TW + P - 1;   // staged columns, halo included
  static constexpr int CB = CG * NC;        // channels a block
  static constexpr int THREADS = PX * CG;
  // the values [SPAN][CB] of E, in floats (CB is even)
  static constexpr int VALS = SPAN * CB * (int)sizeof(E) / 4;
  // one buffer, in floats: the values, then g [SPAN][P] as floats; a
  // multiple of 4 floats so that the second buffer's values stay 16-byte
  // aligned
  static constexpr int BUF = (VALS + SPAN * P + 3) / 4 * 4;
};

// Start the copies of displacement row pi into one buffer: the value row vy
// (f2 for df1, f1 for df2) at the block's SPAN columns and CB channels, and
// the P entries of g for row pi (at the block's TW pixels of row h for df1;
// at the SPAN source pixels of row vy for df2). Zero outside the image.
template <typename E, int P, int NP, int CG>
__device__ __forceinline__ void bwd_stage(
    float* buf, const E* __restrict__ vals, const E* __restrict__ g,
    bool second, int b, int h, int vy, int pi, int r, int m0, int H, int W,
    int C, int c0, int dil, bool vec) {
  using T = BwdTile<E, P, NP, CG>;
  constexpr int PP = P * P;
  constexpr int V16 = VEC<E>;
  const int t = threadIdx.x;
  E* sv = reinterpret_cast<E*>(buf);
  float* sg = buf + T::VALS;
  const E* vrow = vals + ((long long)b * H + vy) * W * C;
  if (vec) {  // C % V16 == 0: 16-byte copies, 16-byte aligned
    constexpr int Q = T::CB / V16;
    for (int e = t; e < T::SPAN * Q; e += T::THREADS) {
      const int u = e / Q, q = e % Q;
      const int m = m0 - T::R + u, x = r + dil * m, c = c0 + V16 * q;
      const bool ok = m >= 0 && x < W && c < C;
      cp_async16(sv + u * T::CB + V16 * q,
                 ok ? vrow + (long long)x * C + c : vals, ok);
    }
  } else {
    for (int e = t; e < T::SPAN * T::CB; e += T::THREADS) {
      const int u = e / T::CB, k = e % T::CB;
      const int m = m0 - T::R + u, x = r + dil * m, c = c0 + k;
      const bool ok = m >= 0 && x < W && c < C;
      if constexpr (std::is_same_v<E, float>)
        cp_async4(sv + e, ok ? vrow + (long long)x * C + c : vals, ok);
      else
        sv[e] = ok ? vrow[(long long)x * C + c] : __float2bfloat16_rn(0.f);
    }
  }
  const E* grow = g + ((long long)b * H + (second ? vy : h)) * W * PP
                  + pi * P;
  const int glen = second ? T::SPAN : T::TW;
  const int gm0 = second ? m0 - T::R : m0;
  for (int e = t; e < glen * P; e += T::THREADS) {
    const int u = e / P, j = e % P;
    const int m = gm0 + u, x = r + dil * m;
    const bool ok = m >= 0 && x < W;
    if constexpr (std::is_same_v<E, float>)
      cp_async4(sg + e, ok ? grow + (long long)x * PP + j : g, ok);
    else
      sg[e] = ok ? widen(grow[(long long)x * PP + j]) : 0.f;
  }
}

// One displacement row's sums for a thread's NP pixels (staged columns a ..
// a+NP-1) and NC channels (cg*4 .. +4 and CG*4 + cg*4 .. +4 of the block's).
// The loops unroll fully: which (s, i) pairs are live is known at compile
// time.
template <int P, int NP, int CG, bool SECOND>
__device__ __forceinline__ void bwd_row(const float* sv, const float* sg,
                                        int a, int cg, float (&acc)[NP][NC]) {
  constexpr int CB = CG * NC;
#pragma unroll
  for (int s = 0; s < NP + P - 1; ++s) {
    const float4 lo = *reinterpret_cast<const float4*>(sv + (a + s) * CB
                                                        + cg * 4);
    const float4 hi = *reinterpret_cast<const float4*>(sv + (a + s) * CB
                                                        + (CG + cg) * 4);
    const float v[NC] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int j = s - i;  // the tap of pixel i that reads column s
      if (j < 0 || j >= P) continue;
      // df1: g at the pixel, tap j; df2: g at the source column s, tap P-1-j
      const float w = SECOND ? sg[(a + s) * P + (P - 1 - j)]
                             : sg[(a + i) * P + j];
#pragma unroll
      for (int k = 0; k < NC; ++k) acc[i][k] = fmaf(w, v[k], acc[i][k]);
    }
  }
}

// The same for bf16 values, widened as they are read (the same channels:
// two 8-byte loads of four).
template <int P, int NP, int CG, bool SECOND>
__device__ __forceinline__ void bwd_row(const bf16* sv, const float* sg,
                                        int a, int cg, float (&acc)[NP][NC]) {
  constexpr int CB = CG * NC;
#pragma unroll
  for (int s = 0; s < NP + P - 1; ++s) {
    float v[NC];
    widen4(sv + (a + s) * CB + cg * 4, v);
    widen4(sv + (a + s) * CB + (CG + cg) * 4, v + 4);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int j = s - i;
      if (j < 0 || j >= P) continue;
      const float w = SECOND ? sg[(a + s) * P + (P - 1 - j)]
                             : sg[(a + i) * P + j];
#pragma unroll
      for (int k = 0; k < NC; ++k) acc[i][k] = fmaf(w, v[k], acc[i][k]);
    }
  }
}

// Grid: x = residue r (mod dil) times column tile, y = image row h,
// z = (output, batch, channel block), df1's blocks first.
template <typename E, int P, int NP, int CG>
__global__ void __launch_bounds__(PX * CG)
corr_bwd_kernel(const E* __restrict__ f1, const E* __restrict__ f2,
                const E* __restrict__ g, E* __restrict__ df1,
                E* __restrict__ df2, int B, int H, int W, int C, int dil,
                float inv_c) {
  using T = BwdTile<E, P, NP, CG>;
  constexpr int R = T::R;
  extern __shared__ __align__(16) float bwd_smem[];

  const int ntile = ((W + dil - 1) / dil + T::TW - 1) / T::TW;
  const int r = blockIdx.x / ntile;
  const int m0 = (blockIdx.x % ntile) * T::TW;
  const int wr = (W - r + dil - 1) / dil;  // pixels of residue r in a row
  if (m0 >= wr) return;  // the same for the whole block
  const int h = blockIdx.y;
  const int ncb = (C + T::CB - 1) / T::CB;
  const bool second = blockIdx.z >= B * ncb;  // false: df1, true: df2
  const int z = second ? blockIdx.z - B * ncb : blockIdx.z;
  const int b = z / ncb;
  const int c0 = (z % ncb) * T::CB;
  const E* vals = second ? f1 : f2;
  // 16-byte copies of the values: float rows of C % 4 == 0 channels (torch
  // allocates 16-byte aligned); bf16 rows of C % 8 == 0, inputs checked
  bool vec;
  if constexpr (std::is_same_v<E, float>)
    vec = C % 4 == 0;
  else
    vec = C % 8 == 0 && (reinterpret_cast<uintptr_t>(f1)
                         | reinterpret_cast<uintptr_t>(f2)) % 16 == 0;
  const int t = threadIdx.x;
  const int cg = t % CG;
  const int a = (t / CG) * NP;

  // displacement rows whose value row lies in the image: df1 reads row
  // h + (pi-R)*dil, df2 the source row h - (pi-R)*dil; pi = R always does
  const int up = h / dil, down = (H - 1 - h) / dil;
  const int lo = second ? max(0, R - down) : max(0, R - up);
  const int hi = second ? min(P - 1, R + up) : min(P - 1, R + down);
  auto value_row = [&](int pi) {
    return second ? h - (pi - R) * dil : h + (pi - R) * dil;
  };

  float acc[NP][NC];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[i][k] = 0.f;

  bwd_stage<E, P, NP, CG>(bwd_smem, vals, g, second, b, h, value_row(lo), lo,
                          r, m0, H, W, C, c0, dil, vec);
  cp_async_commit();
  for (int pi = lo; pi <= hi; ++pi) {
    float* buf = bwd_smem + ((pi - lo) & 1) * T::BUF;
    cp_async_wait_all();  // this thread's copies of row pi have landed
    __syncthreads();      // everyone's have, and row pi-1's buffer is free
    if (pi < hi)
      bwd_stage<E, P, NP, CG>(bwd_smem + ((pi + 1 - lo) & 1) * T::BUF, vals,
                              g, second, b, h, value_row(pi + 1), pi + 1, r,
                              m0, H, W, C, c0, dil, vec);
    cp_async_commit();
    const E* sv = reinterpret_cast<const E*>(buf);
    const float* sg = buf + T::VALS;
    if (second)
      bwd_row<P, NP, CG, true>(sv, sg, a, cg, acc);
    else
      bwd_row<P, NP, CG, false>(sv, sg, a, cg, acc);
  }

  // each thread writes its own sums: consecutive threads cover consecutive
  // 16-byte chunks of a pixel's channels
  E* out = second ? df2 : df1;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int m = m0 + a + i;
    if (m >= wr) continue;
    E* orow = out + (((long long)b * H + h) * W + r + dil * m) * C;
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      const int c = c0 + (q * CG + cg) * 4;
      const float* s = &acc[i][4 * q];
      if (vec) {
        if (c < C) {
          if constexpr (std::is_same_v<E, float>) {
            *reinterpret_cast<float4*>(orow + c) = make_float4(
                s[0] * inv_c, s[1] * inv_c, s[2] * inv_c, s[3] * inv_c);
          } else {  // four bf16, 8 bytes: c is a multiple of 4
            const __nv_bfloat162 lo =
                __floats2bfloat162_rn(s[0] * inv_c, s[1] * inv_c);
            const __nv_bfloat162 hi =
                __floats2bfloat162_rn(s[2] * inv_c, s[3] * inv_c);
            uint2 u;
            u.x = *reinterpret_cast<const unsigned*>(&lo);
            u.y = *reinterpret_cast<const unsigned*>(&hi);
            *reinterpret_cast<uint2*>(orow + c) = u;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < C) orow[c + e] = narrow<E>(s[e] * inv_c);
      }
    }
  }
}

// Allow more than 48 KB of dynamic shared memory where a launch needs it.
template <typename Kernel>
cudaError_t fit_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int N>
using Int = std::integral_constant<int, N>;

// Calls fn(std::integral_constant<int, P>) for the odd patch P <= 21.
template <typename Fn>
cudaError_t with_patch(int patch, Fn fn) {
  switch (patch) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    case 9: return fn(std::integral_constant<int, 9>{});
    case 11: return fn(std::integral_constant<int, 11>{});
    case 13: return fn(std::integral_constant<int, 13>{});
    case 15: return fn(std::integral_constant<int, 15>{});
    case 17: return fn(std::integral_constant<int, 17>{});
    case 19: return fn(std::integral_constant<int, 19>{});
    case 21: return fn(std::integral_constant<int, 21>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename E, int P, int NP, int CG>
cudaError_t launch_bwd_tiles(const E* f1, const E* f2, const E* g, E* df1,
                             E* df2, int B, int H, int W, int C, int dil,
                             cudaStream_t stream) {
  using T = BwdTile<E, P, NP, CG>;
  const size_t smem = 2 * sizeof(float) * (size_t)T::BUF;
  cudaError_t e = fit_smem(corr_bwd_kernel<E, P, NP, CG>, smem);
  if (e != cudaSuccess) return e;
  const int ntile = ((W + dil - 1) / dil + T::TW - 1) / T::TW;
  const dim3 grid(dil * ntile, H, 2 * B * ((C + T::CB - 1) / T::CB));
  corr_bwd_kernel<E, P, NP, CG><<<grid, T::THREADS, smem, stream>>>(
      f1, f2, g, df1, df2, B, H, W, C, dil, 1.0f / C);
  return cudaGetLastError();
}

// The backward's tiles from the shape: NP pixels a thread, CG channel
// groups a block. A row of at most 32 pixels a residue (Back2Future's
// levels 5-6: [26,128], [13,192]) takes 16-pixel tiles (NP = 2), wider rows
// 56-pixel tiles (NP = 7). A block takes all of C up to 32 or 64 channels,
// 256 where C is a multiple of it (FlowNetC6), else 128 (64 on narrow
// rows), so that one staged g row serves as many channels as it can; the
// block is halved while the grid has fewer blocks than the card's 132 SMs
// ([4,4,13,192] then takes 32 channels, 192 blocks).
struct BwdShape {
  int np, cg;
};

BwdShape bwd_shape(int B, int H, int W, int C, int dil) {
  constexpr int SMS = 132;
  const int wd = (W + dil - 1) / dil;
  const bool narrow = wd <= 32;
  const int np = narrow ? 2 : 7, tw = PX * np;
  int cb = C <= 32 ? 32 : C <= 64 || narrow ? 64 : C % 256 == 0 ? 256 : 128;
  auto blocks = [&](int cb) {
    return (long long)dil * ((wd + tw - 1) / tw) * H * 2 * B
           * ((C + cb - 1) / cb);
  };
  while (cb > 32 && blocks(cb) < SMS) cb /= 2;
  return {np, cb / NC};
}

template <typename E, int P>
cudaError_t launch_bwd(const E* f1, const E* f2, const E* g, E* df1, E* df2,
                       int B, int H, int W, int C, int dil,
                       cudaStream_t stream) {
  auto tiles = [&](auto np, auto cg) {
    return launch_bwd_tiles<E, P, decltype(np)::value, decltype(cg)::value>(
        f1, f2, g, df1, df2, B, H, W, C, dil, stream);
  };
  const BwdShape t = bwd_shape(B, H, W, C, dil);
  if (t.np == 2)
    return t.cg == 4 ? tiles(Int<2>{}, Int<4>{}) : tiles(Int<2>{}, Int<8>{});
  switch (t.cg) {
    case 4: return tiles(Int<7>{}, Int<4>{});
    case 8: return tiles(Int<7>{}, Int<8>{});
    case 16: return tiles(Int<7>{}, Int<16>{});
    default: return tiles(Int<7>{}, Int<32>{});
  }
}

// The forward's tiles from the shape (head note, point 5): NP pixels a
// thread and KG lanes a pixel group. Rows of more than 32 pixels a residue
// take 56-pixel tiles with NP = 8 up to P = 9 and 4 above (72 to 84 sums a
// thread); narrower rows (Back2Future's levels 5-6: [26,128], [13,192])
// take 16-pixel tiles with NP = 2, so that the grid still fills the 132
// SMs, and KG = 16 where C > 64, which halves their chain of chunks.
struct FwdShape {
  int np, kg;
};

constexpr int fwd_wide_np(int patch) { return patch <= 9 ? 8 : 4; }

FwdShape fwd_shape(int W, int C, int dil, int patch) {
  const int wd = (W + dil - 1) / dil;
  if (wd > 32) return {fwd_wide_np(patch), 8};
  return {2, C > 64 ? 16 : 8};
}

// pixel groups a block: 56 pixels on wide rows, 16 on narrow ones
constexpr int fwd_groups(int np) { return np == 2 ? 8 : 56 / np; }

template <typename E, int P, int NP, int KG>
cudaError_t launch_fwd_tiles(const E* f1, const E* f2, E* out, int B, int H,
                             int W, int C, int dil, cudaStream_t stream) {
  constexpr int NPG = fwd_groups(NP);
  using T = FwdTile<E, P, NP, KG, NPG>;
  const size_t smem = sizeof(E) * (size_t)(C > T::CK ? 2 : 1) * T::BUF;
  cudaError_t e = fit_smem(corr_fwd_kernel<E, P, NP, KG, NPG>, smem);
  if (e != cudaSuccess) return e;
  const int ntile = ((W + dil - 1) / dil + T::TW - 1) / T::TW;
  const dim3 grid(dil * ntile, H, B * P);
  const bool vec = C % VEC<E> == 0
                   && (reinterpret_cast<uintptr_t>(f1)
                       | reinterpret_cast<uintptr_t>(f2)) % 16 == 0;
  corr_fwd_kernel<E, P, NP, KG, NPG><<<grid, T::THREADS, smem, stream>>>(
      f1, f2, out, H, W, C, dil, 1.0f / C, vec);
  return cudaGetLastError();
}

template <typename E, int P>
cudaError_t launch_fwd(const E* f1, const E* f2, E* out, int B, int H, int W,
                       int C, int dil, cudaStream_t stream) {
  const FwdShape t = fwd_shape(W, C, dil, P);
  if (t.np != 2)
    return launch_fwd_tiles<E, P, fwd_wide_np(P), 8>(f1, f2, out, B, H, W, C,
                                                     dil, stream);
  if (t.kg == 16)
    return launch_fwd_tiles<E, P, 2, 16>(f1, f2, out, B, H, W, C, dil,
                                         stream);
  return launch_fwd_tiles<E, P, 2, 8>(f1, f2, out, B, H, W, C, dil, stream);
}

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t: 0 when the
// launch was accepted. The caller checks shapes, types and contiguity. The
// source compiles twice, in parallel (ops/_build.py): the float32 entries,
// and with CC_CORRELATION_BF16 the bf16 ones; each instantiates its own
// type's kernels.
#ifndef CC_CORRELATION_BF16
extern "C" int cc_correlation_forward(const float* f1, const float* f2,
                                      float* out, int B, int H, int W, int C,
                                      int patch, int dilation, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_patch(patch, [&](auto p) {
    return launch_fwd<float, decltype(p)::value>(f1, f2, out, B, H, W, C,
                                                 dilation, s);
  });
}


// The forward's tiles for a shape, as cc_correlation_forward takes them:
// pixels of one residue class a block, pixels a thread, channels a chunk.
extern "C" void cc_correlation_forward_tiles(int W, int C, int patch,
                                             int dilation, int* pixels,
                                             int* per_thread, int* channels) {
  const FwdShape t = fwd_shape(W, C, dilation, patch);
  *pixels = fwd_groups(t.np) * t.np;
  *per_thread = t.np;
  *channels = 4 * t.kg;  // 8 * t.kg in a bf16 launch
}

// The backward's tiles for a shape, as cc_correlation_backward takes them:
// pixels of one residue class a block and channels a block.
extern "C" void cc_correlation_backward_tiles(int B, int H, int W, int C,
                                              int dilation, int* pixels,
                                              int* channels) {
  const BwdShape t = bwd_shape(B, H, W, C, dilation);
  *pixels = PX * t.np;
  *channels = NC * t.cg;
}

extern "C" int cc_correlation_backward(const float* f1, const float* f2,
                                       const float* g, float* df1, float* df2,
                                       int B, int H, int W, int C, int patch,
                                       int dilation, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_patch(patch, [&](auto p) {
    return launch_bwd<float, decltype(p)::value>(f1, f2, g, df1, df2, B, H,
                                                 W, C, dilation, s);
  });
}

#else
// The same for bf16 f1, f2 and out (pointers to __nv_bfloat16).
extern "C" int cc_correlation_forward_bf16(const void* f1, const void* f2,
                                           void* out, int B, int H, int W,
                                           int C, int patch, int dilation,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_patch(patch, [&](auto p) {
    return launch_fwd<bf16, decltype(p)::value>(
        static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
        static_cast<bf16*>(out), B, H, W, C, dilation, s);
  });
}

// The same for bf16 f1, f2, g, df1 and df2 (pointers to __nv_bfloat16).
extern "C" int cc_correlation_backward_bf16(const void* f1, const void* f2,
                                            const void* g, void* df1,
                                            void* df2, int B, int H, int W,
                                            int C, int patch, int dilation,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_patch(patch, [&](auto p) {
    return launch_bwd<bf16, decltype(p)::value>(
        static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
        static_cast<const bf16*>(g), static_cast<bf16*>(df1),
        static_cast<bf16*>(df2), B, H, W, C, dilation, s);
  });
}
#endif  // CC_CORRELATION_BF16
