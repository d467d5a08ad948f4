// Local correlation cost volume, forward, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel cc_tpu/ops/correlation_pallas.py::_forward (body
// _corr_kernel). For f1, f2 of shape [B,H,W,C] (NHWC, C innermost):
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

#include <cuda_runtime.h>

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
cudaError_t launch(const float* f1, const float* f2, float* out, int B, int H,
                   int W, int C, int dil, cudaStream_t stream) {
  const int span = TW + 2 * (P / 2) * dil;
  const size_t smem = sizeof(float) * ((size_t)(TW + span) * LD + TW * P);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_fwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + TW - 1) / TW, H, B * P);
  corr_fwd_kernel<P><<<grid, TW, smem, stream>>>(f1, f2, out, H, W, C, dil,
                                                  1.0f / C);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Returns a cudaError_t: 0 when the launch
// was accepted. The caller checks shapes, types and contiguity.
extern "C" int cc_correlation_forward(const float* f1, const float* f2,
                                      float* out, int B, int H, int W, int C,
                                      int patch, int dilation, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (patch) {
    case 1: return launch<1>(f1, f2, out, B, H, W, C, dilation, s);
    case 3: return launch<3>(f1, f2, out, B, H, W, C, dilation, s);
    case 5: return launch<5>(f1, f2, out, B, H, W, C, dilation, s);
    case 7: return launch<7>(f1, f2, out, B, H, W, C, dilation, s);
    case 9: return launch<9>(f1, f2, out, B, H, W, C, dilation, s);
    case 11: return launch<11>(f1, f2, out, B, H, W, C, dilation, s);
    case 13: return launch<13>(f1, f2, out, B, H, W, C, dilation, s);
    case 15: return launch<15>(f1, f2, out, B, H, W, C, dilation, s);
    case 17: return launch<17>(f1, f2, out, B, H, W, C, dilation, s);
    case 19: return launch<19>(f1, f2, out, B, H, W, C, dilation, s);
    case 21: return launch<21>(f1, f2, out, B, H, W, C, dilation, s);
    default: return cudaErrorInvalidValue;
  }
}
