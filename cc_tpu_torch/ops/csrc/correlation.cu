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
// summed by one thread over all P*P taps, in registers, with no atomics, so
// the result is the same on every run.
//
// Bound: memory as well. A launch must read f1, f2 and g once and write df1
// and df2 once; at 4*P*P*C operations per pixel against 4*(4C + P*P) bytes
// it stays under the fp32 compute line at the main path's C <= 192.
//
// Design: the forward's, turned around. One block owns TW pixels of one
// image row and CC channels of one of the two outputs; df1's and df2's
// blocks run in the same launch. Each thread keeps CC fp32 sums for its
// pixel. For each displacement row pi the block stages the row segment of
// the values it sums over ([TW + 2*halo] x CC of f2 for df1, of f1 for df2,
// zero-filled outside the image) and the P entries of g for that row (at its
// own pixels for df1; at the source pixels, halo included, for df2) in
// shared memory; rows outside the image are skipped whole. The sums go out
// through shared memory so that consecutive threads write consecutive
// addresses.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

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

template <int P>
__global__ void __launch_bounds__(TW)
corr_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                const float* __restrict__ g, float* __restrict__ df1,
                float* __restrict__ df2, int B, int H, int W, int C, int dil,
                float inv_c) {
  constexpr int R = P / 2;
  constexpr int PP = P * P;
  const int halo = R * dil;
  const int span = TW + 2 * halo;
  extern __shared__ float smem[];
  float* sv = smem;            // [span][LD]: the values summed over
  float* sg = sv + span * LD;  // [span][P]: g of one displacement row

  const int t = threadIdx.x;
  const int w0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  const int nchunk = (C + CC - 1) / CC;
  const bool second = blockIdx.z >= B * nchunk;  // false: df1, true: df2
  const int z = second ? blockIdx.z - B * nchunk : blockIdx.z;
  const int b = z / nchunk;
  const int c0 = (z % nchunk) * CC;
  const float* vals = second ? f1 : f2;

  float acc[CC];
#pragma unroll
  for (int k = 0; k < CC; ++k) acc[k] = 0.f;

  for (int pi = 0; pi < P; ++pi) {
    // df1 reads row h + dy; df2 reads the source row h - dy
    const int dy = (pi - R) * dil;
    const int y = second ? h - dy : h + dy;
    if (y < 0 || y >= H) continue;  // the same for the whole block
    const float* vrow = vals + ((long long)b * H + y) * W * C;
    for (int i = t; i < span * CC; i += TW) {
      const int p = i / CC, k = i % CC, x = w0 - halo + p, c = c0 + k;
      sv[p * LD + k] = (x >= 0 && x < W && c < C)
                           ? vrow[(long long)x * C + c] : 0.f;
    }
    const int gx0 = second ? w0 - halo : w0;
    const int glen = second ? span : TW;
    const float* grow =
        g + ((long long)b * H + (second ? y : h)) * W * PP + pi * P;
    for (int i = t; i < glen * P; i += TW) {
      const int p = i / P, j = i % P, x = gx0 + p;
      sg[i] = (x >= 0 && x < W) ? grow[(long long)x * PP + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < P; ++j) {
      // df1: f2 at column w + (j-R)*dil, staged at t + j*dil;
      // df2: the source at column w - (j-R)*dil, staged at t + (2R-j)*dil
      const int l = second ? t + (2 * R - j) * dil : t + j * dil;
      const float gv = second ? sg[l * P + j] : sg[t * P + j];
#pragma unroll
      for (int k = 0; k < CC; ++k) acc[k] = fmaf(gv, sv[l * LD + k], acc[k]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < CC; ++k) sv[t * LD + k] = acc[k] * inv_c;
  __syncthreads();
  const int npix = min(TW, W - w0);
  float* orow = (second ? df2 : df1) + (((long long)b * H + h) * W + w0) * C;
  for (int i = t; i < npix * CC; i += TW) {
    const int p = i / CC, k = i % CC;
    if (c0 + k < C) orow[(long long)p * C + c0 + k] = sv[p * LD + k];
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

template <int P>
cudaError_t launch_bwd(const float* f1, const float* f2, const float* g,
                       float* df1, float* df2, int B, int H, int W, int C,
                       int dil, cudaStream_t stream) {
  const int span = TW + 2 * (P / 2) * dil;
  const size_t smem = sizeof(float) * (size_t)span * (LD + P);
  cudaError_t e = fit_smem(corr_bwd_kernel<P>, smem);
  if (e != cudaSuccess) return e;
  const int nchunk = (C + CC - 1) / CC;
  const dim3 grid((W + TW - 1) / TW, H, 2 * B * nchunk);
  corr_bwd_kernel<P><<<grid, TW, smem, stream>>>(f1, f2, g, df1, df2, B, H, W,
                                                  C, dil, 1.0f / C);
  return cudaGetLastError();
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
