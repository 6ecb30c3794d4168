// rotate.cu — per-line fractional shear of an NHWC batch, for Hopper.
//
// Replaces the Pallas TPU kernel
// floodplanet_code_tpu/ops/rotate.py::_shear_x_pallas_single (jit wrapper
// _shear_x_pallas_batch, dispatched by _shear_x_batch(impl="pallas")), the
// resampling step of the 3-shear rotation that training augmentation runs
// three times per batch (x, y, x). It computes, for img [B, H, W, C]:
//
//   axis 2 (shear along W): out[b,y,x,c] = (1-f)*P(x+k) + f*P(x+k+1)
//                           with (k, f) of line (b, y), P(s) = img[b,y,s,c]
//   axis 1 (shear along H): out[b,y,x,c] = (1-f)*P(y+k) + f*P(y+k+1)
//                           with (k, f) of line (b, x), P(s) = img[b,s,x,c]
//
// where P(s) is cval outside [0, len). k is the integer tap offset and f the
// fraction quantized to 1/65536 (fq / 65536), both computed per line by the
// wrapper exactly as rotate.py:248-275 does; channels >= nearest_from use
// rintf(f) (nearest neighbour: label and validity channels). The blend runs
// in f32 with no FMA contraction, as the Pallas body's two products and a
// sum, and rounds once to the output type at the store.
//
// Design: one flat elementwise pass. blockIdx.y walks the rows (b, y) and
// each thread writes one (x, c) element of its row, so stores are fully
// coalesced; the taps are read through bounds checks, so there is no padded
// copy of the input (the TPU kernel's jnp.pad, W_BLK column blocks and row
// padding were VMEM layout artifacts). Shear along H needs no transpose:
// neighbouring threads read neighbouring (x, c) of rows whose offsets differ
// by at most one between adjacent columns. Any H, W and C work, every
// output element is written.
//
// What bounds it on an H100: it reads each input element about once (the
// second tap is a neighbour, served by L1/L2) and writes each output once,
// a handful of integer and f32 operations per element: bytes bound. At the
// augmentation shape [8, 512, 512, 6] bf16 that is 2 x 25.2 MB, ~15 us at
// 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
shear_kernel(const T* __restrict__ in, T* __restrict__ out,
             const int* __restrict__ koff, const int* __restrict__ fq,
             int B, int H, int W, int C, int axis, int nearest_from, float cval) {
  const int wc = W * C;
  const int n_lines = axis == 2 ? H : W;
  const int len = axis == 2 ? W : H;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    const int b = row / H;
    const int y = row - b * H;
    const int64_t img = static_cast<int64_t>(b) * H * wc;
    for (int e = blockIdx.x * THREADS + threadIdx.x; e < wc; e += gridDim.x * THREADS) {
      const int x = e / C;
      const int c = e - x * C;
      const int line = axis == 2 ? y : x;
      const int pos = axis == 2 ? x : y;
      const int k = __ldg(koff + b * n_lines + line);
      float f = static_cast<float>(__ldg(fq + b * n_lines + line)) * (1.0f / 65536.0f);
      if (c >= nearest_from) f = rintf(f);
      const int s0 = pos + k;
      const int s1 = s0 + 1;
      // Element offset of tap s along the shear axis.
      const int64_t step = axis == 2 ? C : wc;
      const int64_t base = axis == 2 ? static_cast<int64_t>(y) * wc + c
                                     : static_cast<int64_t>(x) * C + c;
      const float p0 = (s0 >= 0 && s0 < len) ? to_f32(in[img + base + s0 * step]) : cval;
      const float p1 = (s1 >= 0 && s1 < len) ? to_f32(in[img + base + s1 * step]) : cval;
      const float v = __fadd_rn(__fmul_rn(p0, __fsub_rn(1.0f, f)), __fmul_rn(p1, f));
      store(out + img + static_cast<int64_t>(y) * wc + e, v);
    }
  }
}

}  // namespace

extern "C" {

// Shears ``in`` into ``out`` (both [B, H, W, C], contiguous, f32 or bf16)
// on ``stream``. koff, fq: int32 [B, n_lines] (n_lines = H for axis 2, W
// for axis 1). ``cval`` is already rounded to the tensor's type. Returns
// the cudaError_t of the launch (0 on success).
int rs_shear(const void* in, void* out, const void* koff, const void* fq,
             int B, int H, int W, int C, int axis, int nearest_from, float cval,
             int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  const int wc = W * C;
  const int rows = B * H;
  dim3 grid((wc + THREADS - 1) / THREADS, rows < MAX_GRID_Y ? rows : MAX_GRID_Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(koff);
  const int* q = static_cast<const int*>(fq);
  if (is_bf16) {
    shear_kernel<bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(in), static_cast<bf16*>(out), k, q, B, H, W, C,
        axis, nearest_from, cval);
  } else {
    shear_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), k, q, B, H, W, C,
        axis, nearest_from, cval);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
