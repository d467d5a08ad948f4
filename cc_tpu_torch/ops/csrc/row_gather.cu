// Row gather, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel of experiment E5 in scripts/exp_gather.py (the
// pallas_call at :173, body k2 at :162-170), a select loop over the rows of
// the table. For a table img [R,W] (f32) and indices idx [N,W] (int32):
//
//   out[i,j] = img[idx[i,j], j]   where 0 <= idx[i,j] < R,   else 0
//
// which is what the select loop gives: an index outside [0,R) matches no
// row and leaves the zero it started from.
//
// Bound: memory. One launch must read idx and the table entries that the
// indices name, and write out: at [256,832] some 2.5 MB, under a
// microsecond at 3.35 TB/s; there is no arithmetic to speak of. The TPU's
// select loop reads the whole table once per output tile (R compares per
// output); here one thread per output reads its index and its one table
// entry, so the table is read only where indexed. Consecutive threads take
// consecutive j: the idx and out accesses coalesce, and the table reads of
// a warp fall in the same columns of (possibly) different rows.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 256;  // threads per block, along j

__global__ void __launch_bounds__(TB)
row_gather_kernel(const float* __restrict__ img, const int* __restrict__ idx,
                  float* __restrict__ out, int R, int W) {
  const int j = blockIdx.x * TB + threadIdx.x;
  if (j >= W) return;
  const long long o = (long long)blockIdx.y * W + j;
  const int r = idx[o];
  out[o] = (r >= 0 && r < R) ? __ldg(img + (long long)r * W + j) : 0.f;
}

}  // namespace

// Plain C entry point for ctypes. Returns a cudaError_t: 0 when the launch
// was accepted. The caller checks shapes, types and contiguity.
extern "C" int cc_row_gather(const float* img, const int* idx, float* out,
                             int R, int N, int W, void* stream) {
  const dim3 grid((W + TB - 1) / TB, N);
  row_gather_kernel<<<grid, TB, 0, static_cast<cudaStream_t>(stream)>>>(
      img, idx, out, R, W);
  return cudaGetLastError();
}
