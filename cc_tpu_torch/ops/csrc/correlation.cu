// Local correlation cost volume, forward and backward, fp32, for Hopper
// (sm_90a).
//
// FORWARD. Replaces the TPU kernel cc_tpu/ops/correlation_pallas.py::_forward
// (body _corr_kernel). For f1, f2 of shape [B,H,W,C] (NHWC, C innermost):
//
//   out[b,h,w,pi*P+pj] = (1/C) * sum_c f1[b,h,w,c]
//                                     * f2[b, h+(pi-P/2)*d, w+(pj-P/2)*d, c]
//
// with f2 read as 0 out of bounds; out is [B,H,W,P*P].
//
// Bound: memory. A launch must read f1 and f2 once and write P*P floats per
// pixel. On the main path (P=9, d=1, B=4) that is 30.9 MB at pyramid level 2
// ([64,208,32]) down to 0.39 MB at level 6 ([4,13,192]); the whole forward
// does about 1 GFLOP of it, far under the fp32 compute line.
//
// Design against that bound: each input tile is read once from device
// memory into shared memory and reused from there. One block owns one
// displacement row pi for TW pixels of one image row: it stages the f1 tile
// [TW x CC] and the f2 row segment [(TW + 2*halo) x CC] (zero-filled outside
// the image) in shared memory, CC channels at a time, and each thread keeps P
// fp32 sums for its pixel. The P sums of a pixel are contiguous in `out`, so
// they go through shared memory once more and are written by consecutive
// threads to consecutive addresses. Whole rows of f2 outside the image are
// not read at all. The f1 tile is read by the P blocks of its pixels, which
// run close together and hit L2. P is a template parameter, so the sums stay
// in registers for every odd P up to 21 (P=21, d=2 is FlowNetC6's case).
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

#include <cuda_runtime.h>

#include <type_traits>

namespace {

// The forward's tiles
constexpr int TW = 64;      // pixels per block, one per thread
constexpr int CC = 16;      // channels staged per step
constexpr int LD = CC + 1;  // odd row stride: thread t's rows hit distinct banks

template <int P>
__global__ void __launch_bounds__(TW)
corr_fwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                float* __restrict__ out, int H, int W, int C, int dil,
                float inv_c) {
  constexpr int R = P / 2;
  const int halo = R * dil;
  const int span = TW + 2 * halo;
  extern __shared__ float smem[];
  float* s1 = smem;              // [TW][LD]
  float* s2 = s1 + TW * LD;      // [span][LD]
  float* so = s2 + span * LD;    // [TW][P]

  const int t = threadIdx.x;
  const int w0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  const int b = blockIdx.z / P;
  const int pi = blockIdx.z % P;
  const int y2 = h + (pi - R) * dil;

  float acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = 0.f;

  if (y2 >= 0 && y2 < H) {  // the same for the whole block
    const float* row1 = f1 + ((long long)b * H + h) * W * C;
    const float* row2 = f2 + ((long long)b * H + y2) * W * C;
    for (int c0 = 0; c0 < C; c0 += CC) {
      for (int i = t; i < TW * CC; i += TW) {
        const int p = i / CC, k = i % CC, x = w0 + p, c = c0 + k;
        s1[p * LD + k] = (x < W && c < C) ? row1[(long long)x * C + c] : 0.f;
      }
      for (int i = t; i < span * CC; i += TW) {
        const int p = i / CC, k = i % CC, x = w0 - halo + p, c = c0 + k;
        s2[p * LD + k] = (x >= 0 && x < W && c < C)
                             ? row2[(long long)x * C + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < CC; ++k) {
        const float a = s1[t * LD + k];
#pragma unroll
        for (int j = 0; j < P; ++j)
          acc[j] = fmaf(a, s2[(t + j * dil) * LD + k], acc[j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < P; ++j) so[t * P + j] = acc[j] * inv_c;
  __syncthreads();

  const int npix = min(TW, W - w0);
  float* orow = out + (((long long)b * H + h) * W + w0) * (P * P) + pi * P;
  for (int i = t; i < npix * P; i += TW) {
    const int p = i / P, j = i % P;
    orow[(long long)p * (P * P) + j] = so[i];
  }
}

// The backward's tiles (see the head note): NC channels a thread and PX
// pixel groups a block; NP pixels a group and CG channel groups a block
// are template parameters.
constexpr int NC = 8;
constexpr int PX = 8;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

template <int P, int NP, int CG>
struct BwdTile {
  static constexpr int R = P / 2;
  static constexpr int TW = PX * NP;        // pixels (of one residue) a block
  static constexpr int SPAN = TW + P - 1;   // staged columns, halo included
  static constexpr int CB = CG * NC;        // channels a block
  static constexpr int THREADS = PX * CG;
  // one buffer: values [SPAN][CB], then g [SPAN][P]; a multiple of 4 floats
  // so that the second buffer's values stay 16-byte aligned
  static constexpr int BUF = (SPAN * (CB + P) + 3) / 4 * 4;
};

// Start the copies of displacement row pi into one buffer: the value row vy
// (f2 for df1, f1 for df2) at the block's SPAN columns and CB channels, and
// the P entries of g for row pi (at the block's TW pixels of row h for df1;
// at the SPAN source pixels of row vy for df2). Zero outside the image.
template <int P, int NP, int CG>
__device__ __forceinline__ void bwd_stage(
    float* buf, const float* __restrict__ vals, const float* __restrict__ g,
    bool second, int b, int h, int vy, int pi, int r, int m0, int H, int W,
    int C, int c0, int dil, bool vec) {
  using T = BwdTile<P, NP, CG>;
  constexpr int PP = P * P;
  const int t = threadIdx.x;
  float* sv = buf;
  float* sg = buf + T::SPAN * T::CB;
  const float* vrow = vals + ((long long)b * H + vy) * W * C;
  if (vec) {  // C % 4 == 0: 16-byte copies, 16-byte aligned
    constexpr int Q = T::CB / 4;
    for (int e = t; e < T::SPAN * Q; e += T::THREADS) {
      const int u = e / Q, q = e % Q;
      const int m = m0 - T::R + u, x = r + dil * m, c = c0 + 4 * q;
      const bool ok = m >= 0 && x < W && c < C;
      cp_async16(sv + u * T::CB + 4 * q,
                 ok ? vrow + (long long)x * C + c : vals, ok);
    }
  } else {
    for (int e = t; e < T::SPAN * T::CB; e += T::THREADS) {
      const int u = e / T::CB, k = e % T::CB;
      const int m = m0 - T::R + u, x = r + dil * m, c = c0 + k;
      const bool ok = m >= 0 && x < W && c < C;
      cp_async4(sv + e, ok ? vrow + (long long)x * C + c : vals, ok);
    }
  }
  const float* grow = g + ((long long)b * H + (second ? vy : h)) * W * PP
                      + pi * P;
  const int glen = second ? T::SPAN : T::TW;
  const int gm0 = second ? m0 - T::R : m0;
  for (int e = t; e < glen * P; e += T::THREADS) {
    const int u = e / P, j = e % P;
    const int m = gm0 + u, x = r + dil * m;
    const bool ok = m >= 0 && x < W;
    cp_async4(sg + e, ok ? grow + (long long)x * PP + j : g, ok);
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

// Grid: x = residue r (mod dil) times column tile, y = image row h,
// z = (output, batch, channel block), df1's blocks first.
template <int P, int NP, int CG>
__global__ void __launch_bounds__(PX * CG)
corr_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                const float* __restrict__ g, float* __restrict__ df1,
                float* __restrict__ df2, int B, int H, int W, int C, int dil,
                float inv_c) {
  using T = BwdTile<P, NP, CG>;
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
  const float* vals = second ? f1 : f2;
  const bool vec = C % 4 == 0;
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

  bwd_stage<P, NP, CG>(bwd_smem, vals, g, second, b, h, value_row(lo), lo, r,
                       m0, H, W, C, c0, dil, vec);
  cp_async_commit();
  for (int pi = lo; pi <= hi; ++pi) {
    float* buf = bwd_smem + ((pi - lo) & 1) * T::BUF;
    cp_async_wait_all();  // this thread's copies of row pi have landed
    __syncthreads();      // everyone's have, and row pi-1's buffer is free
    if (pi < hi)
      bwd_stage<P, NP, CG>(bwd_smem + ((pi + 1 - lo) & 1) * T::BUF, vals, g,
                           second, b, h, value_row(pi + 1), pi + 1, r, m0, H,
                           W, C, c0, dil, vec);
    cp_async_commit();
    const float* sg = buf + T::SPAN * T::CB;
    if (second)
      bwd_row<P, NP, CG, true>(buf, sg, a, cg, acc);
    else
      bwd_row<P, NP, CG, false>(buf, sg, a, cg, acc);
  }

  // each thread writes its own sums: consecutive threads cover consecutive
  // 16-byte chunks of a pixel's channels
  float* out = second ? df2 : df1;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int m = m0 + a + i;
    if (m >= wr) continue;
    float* orow = out + (((long long)b * H + h) * W + r + dil * m) * C;
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      const int c = c0 + (q * CG + cg) * 4;
      const float* s = &acc[i][4 * q];
      if (vec) {
        if (c < C)
          *reinterpret_cast<float4*>(orow + c) = make_float4(
              s[0] * inv_c, s[1] * inv_c, s[2] * inv_c, s[3] * inv_c);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < C) orow[c + e] = s[e] * inv_c;
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

template <int P, int NP, int CG>
cudaError_t launch_bwd_tiles(const float* f1, const float* f2, const float* g,
                             float* df1, float* df2, int B, int H, int W,
                             int C, int dil, cudaStream_t stream) {
  using T = BwdTile<P, NP, CG>;
  const size_t smem = 2 * sizeof(float) * (size_t)T::BUF;
  cudaError_t e = fit_smem(corr_bwd_kernel<P, NP, CG>, smem);
  if (e != cudaSuccess) return e;
  const int ntile = ((W + dil - 1) / dil + T::TW - 1) / T::TW;
  const dim3 grid(dil * ntile, H, 2 * B * ((C + T::CB - 1) / T::CB));
  corr_bwd_kernel<P, NP, CG><<<grid, T::THREADS, smem, stream>>>(
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

template <int P>
cudaError_t launch_bwd(const float* f1, const float* f2, const float* g,
                       float* df1, float* df2, int B, int H, int W, int C,
                       int dil, cudaStream_t stream) {
  auto tiles = [&](auto np, auto cg) {
    return launch_bwd_tiles<P, decltype(np)::value, decltype(cg)::value>(
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

template <int P>
cudaError_t launch(const float* f1, const float* f2, float* out, int B, int H,
                   int W, int C, int dil, cudaStream_t stream) {
  const int span = TW + 2 * (P / 2) * dil;
  const size_t smem = sizeof(float) * ((size_t)(TW + span) * LD + TW * P);
  cudaError_t e = fit_smem(corr_fwd_kernel<P>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + TW - 1) / TW, H, B * P);
  corr_fwd_kernel<P><<<grid, TW, smem, stream>>>(f1, f2, out, H, W, C, dil,
                                                  1.0f / C);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t: 0 when the
// launch was accepted. The caller checks shapes, types and contiguity.
extern "C" int cc_correlation_forward(const float* f1, const float* f2,
                                      float* out, int B, int H, int W, int C,
                                      int patch, int dilation, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_patch(patch, [&](auto p) {
    return launch<decltype(p)::value>(f1, f2, out, B, H, W, C, dilation, s);
  });
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
    return launch_bwd<decltype(p)::value>(f1, f2, g, df1, df2, B, H, W, C,
                                          dilation, s);
  });
}
