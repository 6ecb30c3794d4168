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
// where P(s) is cval outside [0, len). The kernel takes each line's shift
// and computes (k, f) itself, with the Pallas path's clip and arithmetic
// (rotate.py:248-275, 326-334) as IEEE round-to-nearest f32 operations with
// no contraction: src = clamp(shift, -pad+1, pad-1) + pad, k = floor(src)
// (order 1) or rint(src) (order 0), fq = rint((src - k) * 65536) (0 for
// order 0), f = fq / 65536, k -= pad. ops/rotate.py::_quantize is the same
// arithmetic in PyTorch and the oracle. Channels >= nearest_from use
// rint(f) (nearest neighbour: label and validity channels). The blend runs
// in f32, two products and a sum, and rounds once to the output type.
//
// Design: each thread computes its line's (k, f) once, outside the channel
// loop, and there is no integer division per element. C is a template
// parameter for the C the augmentation uses (6: image bands, label,
// validity); any other C takes a one-element-at-a-time kernel.
//   * Along W (axis 2): one thread writes 4 consecutive pixels of one row,
//     all C channels; a pixel's channels load as 4-byte words (bf16 pairs
//     or f32) and the 4 x C outputs store as 16-byte vectors where the
//     row's alignment allows (W % 4 == 0: 48 bytes for 4 bf16 pixels).
//   * Along H (axis 1): one thread writes 4 consecutive rows of one pixel
//     column, which share their line: 5 source pixels serve 4 outputs. It
//     reads NHWC in place, with no transpose: neighbouring threads read
//     neighbouring pixels of rows whose offsets differ by at most one.
// Taps outside the line read cval through bounds checks, so there is no
// padded copy of the input. Any H, W and C work.
//
// What bounds it on an H100: it reads each input element about once (the
// second tap is a neighbour, served by L1/L2) and writes each output once,
// a handful of f32 operations per element: bytes bound. At the augmentation
// shape [8, 512, 512, 6] bf16 that is 2 x 25.2 MB, ~15 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;
constexpr int PX = 4;  // pixels per thread
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ bf16 from_f32(float v, bf16) { return __float2bfloat16_rn(v); }

// Tap offset k and fraction f of one line (see the header).
__device__ __forceinline__ void quantize(float shift, int pad, int order, int& k, float& f) {
  const float src = __fadd_rn(fminf(fmaxf(shift, static_cast<float>(1 - pad)),
                                    static_cast<float>(pad - 1)),
                              static_cast<float>(pad));
  const float kf = order == 0 ? rintf(src) : floorf(src);
  const float frac = order == 0 ? 0.f : __fsub_rn(src, kf);
  k = static_cast<int>(kf) - pad;
  f = rintf(__fmul_rn(frac, 65536.f)) * (1.0f / 65536.0f);
}

__device__ __forceinline__ float blend(float p0, float p1, float f) {
  return __fadd_rn(__fmul_rn(p0, __fsub_rn(1.0f, f)), __fmul_rn(p1, f));
}

// The C channels of one pixel as f32; cval when ``inside`` is false.
template <typename T, int C>
__device__ __forceinline__ void load_px(const T* __restrict__ p, bool inside, float cval,
                                        float* v) {
  if (!inside) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = cval;
    return;
  }
  if constexpr (sizeof(T) == 2 && C % 2 == 0) {
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int c = 0; c < C / 2; ++c) {
      const float2 t = __bfloat1622float2(__ldg(q + c));
      v[2 * c] = t.x;
      v[2 * c + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = to_f32(__ldg(p + c));
  }
}

// Shear along W (axis 2), C known at compile time: 4 pixels x C channels of
// one row per thread.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
shear_kernel(const T* __restrict__ in, T* __restrict__ out, const float* __restrict__ shifts,
             int B, int H, int W, int order, int pad, int nearest_from, float cval,
             int vec_store) {
  const int x0 = (blockIdx.x * THREADS + threadIdx.x) * PX;
  if (x0 >= W) return;
  const int64_t wc = static_cast<int64_t>(W) * C;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    const T* src = in + static_cast<int64_t>(row) * wc;
    int k;
    float f;
    quantize(__ldg(shifts + row), pad, order, k, f);
    const float fn = rintf(f);
    __align__(16) T res[PX * C];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const int s0 = x0 + i + k;
      float p0[C], p1[C];
      load_px<T, C>(src + s0 * C, x0 + i < W && s0 >= 0 && s0 < W, cval, p0);
      load_px<T, C>(src + (s0 + 1) * C, x0 + i < W && s0 + 1 >= 0 && s0 + 1 < W, cval, p1);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        res[i * C + c] = from_f32(blend(p0[c], p1[c], c >= nearest_from ? fn : f), T());
      }
    }
    T* dst = out + static_cast<int64_t>(row) * wc + static_cast<int64_t>(x0) * C;
    if (vec_store && x0 + PX <= W) {
      static_assert((PX * C * sizeof(T)) % 16 == 0, "4 pixels must be whole 16-byte vectors");
#pragma unroll
      for (int v = 0; v < PX * C * static_cast<int>(sizeof(T)) / 16; ++v) {
        reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(res)[v];
      }
    } else {
      for (int e = 0; e < PX * C && x0 + e / C < W; ++e) dst[e] = res[e];
    }
  }
}

// Shear along H (axis 1), C known at compile time: one thread writes 4
// consecutive rows of one pixel column. The 4 outputs share their line (the
// column), so (k, f) is computed once and 5 source pixels serve 4 outputs;
// neighbouring threads read and write neighbouring pixels of one row.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
shear_h_kernel(const T* __restrict__ in, T* __restrict__ out, const float* __restrict__ shifts,
               int B, int H, int W, int order, int pad, int nearest_from, float cval) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  if (x >= W) return;
  const int groups = (H + PX - 1) / PX;
  const int64_t wc = static_cast<int64_t>(W) * C;
  for (int rg = blockIdx.y; rg < B * groups; rg += gridDim.y) {
    const int b = rg / groups;
    const int y0 = (rg - b * groups) * PX;
    const T* col = in + static_cast<int64_t>(b) * H * wc + static_cast<int64_t>(x) * C;
    int k;
    float f;
    quantize(__ldg(shifts + b * W + x), pad, order, k, f);
    const float fn = rintf(f);
    float p[PX + 1][C];
#pragma unroll
    for (int i = 0; i <= PX; ++i) {
      const int s = y0 + k + i;
      load_px<T, C>(col + s * wc, s >= 0 && s < H, cval, p[i]);
    }
    T* dst = out + static_cast<int64_t>(b) * H * wc + static_cast<int64_t>(x) * C;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      if (y0 + i >= H) break;
      __align__(8) T res[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        res[c] = from_f32(blend(p[i][c], p[i + 1][c], c >= nearest_from ? fn : f), T());
      }
      T* d = dst + (y0 + i) * wc;
      if constexpr ((C * sizeof(T)) % 4 == 0) {
#pragma unroll
        for (int v = 0; v < static_cast<int>(C * sizeof(T)) / 4; ++v) {
          reinterpret_cast<uint32_t*>(d)[v] = reinterpret_cast<const uint32_t*>(res)[v];
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) d[c] = res[c];
      }
    }
  }
}

// Any C, one element at a time.
template <typename T>
__global__ void __launch_bounds__(THREADS)
shear_kernel_any_c(const T* __restrict__ in, T* __restrict__ out,
                   const float* __restrict__ shifts, int B, int H, int W, int C, int axis,
                   int order, int pad, int nearest_from, float cval) {
  const int n_lines = axis == 2 ? H : W;
  const int len = axis == 2 ? W : H;
  const int x0 = (blockIdx.x * THREADS + threadIdx.x) * PX;
  if (x0 >= W) return;
  const int64_t wc = static_cast<int64_t>(W) * C;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    const int b = row / H;
    const int y = row - b * H;
    const T* img = in + static_cast<int64_t>(b) * H * wc;
    int k = 0;
    float f = 0.f;
    if (axis == 2) quantize(__ldg(shifts + b * n_lines + y), pad, order, k, f);
    for (int x = x0; x < x0 + PX && x < W; ++x) {
      if (axis == 1) quantize(__ldg(shifts + b * n_lines + x), pad, order, k, f);
      const int pos = axis == 2 ? x : y;
      const int s0 = pos + k;
      const int64_t step = axis == 2 ? C : wc;
      const int64_t base = axis == 2 ? y * wc : static_cast<int64_t>(x) * C;
      const bool in0 = s0 >= 0 && s0 < len, in1 = s0 + 1 >= 0 && s0 + 1 < len;
      const float fn = rintf(f);
      T* dst = out + static_cast<int64_t>(row) * wc + static_cast<int64_t>(x) * C;
      for (int c = 0; c < C; ++c) {
        const float p0 = in0 ? to_f32(__ldg(img + base + s0 * step + c)) : cval;
        const float p1 = in1 ? to_f32(__ldg(img + base + (s0 + 1) * step + c)) : cval;
        dst[c] = from_f32(blend(p0, p1, c >= nearest_from ? fn : f), T());
      }
    }
  }
}

template <typename T>
int launch(const void* in, void* out, const float* shifts, int B, int H, int W, int C, int axis,
           int order, int pad, int nearest_from, float cval, int aligned, cudaStream_t s) {
  const int rows = B * H;
  const dim3 grid((W + THREADS * PX - 1) / (THREADS * PX), rows < MAX_GRID_Y ? rows : MAX_GRID_Y);
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  // 4-byte pixel loads need 4-byte pixels at 4-byte aligned addresses; the
  // 16-byte stores need whole 4-pixel groups at 16-byte aligned addresses.
  if (C == 6 && aligned && axis == 1) {
    const int groups = B * ((H + PX - 1) / PX);
    const dim3 grid_h((W + THREADS - 1) / THREADS, groups < MAX_GRID_Y ? groups : MAX_GRID_Y);
    shear_h_kernel<T, 6><<<grid_h, THREADS, 0, s>>>(src, dst, shifts, B, H, W, order, pad,
                                                     nearest_from, cval);
  } else if (C == 6 && aligned) {
    shear_kernel<T, 6><<<grid, THREADS, 0, s>>>(src, dst, shifts, B, H, W, order, pad,
                                                 nearest_from, cval, W % PX == 0);
  } else {
    shear_kernel_any_c<T><<<grid, THREADS, 0, s>>>(src, dst, shifts, B, H, W, C, axis, order,
                                                    pad, nearest_from, cval);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shears ``in`` into ``out`` (both [B, H, W, C], contiguous, f32 or bf16)
// on ``stream``. shifts: f32 [B, n_lines] (n_lines = H for axis 2, W for
// axis 1); ``pad`` is the Pallas kernel's pad for n_lines. ``cval`` is
// already rounded to the tensor's type. ``aligned``: both tensors start at
// 16-byte aligned addresses. Returns the cudaError_t of the launch (0 on
// success).
int rs_shear(const void* in, void* out, const void* shifts, int B, int H, int W, int C,
             int axis, int order, int pad, int nearest_from, float cval, int is_bf16,
             int aligned, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sh = static_cast<const float*>(shifts);
  if (is_bf16) {
    return launch<bf16>(in, out, sh, B, H, W, C, axis, order, pad, nearest_from, cval, aligned,
                        s);
  }
  return launch<float>(in, out, sh, B, H, W, C, axis, order, pad, nearest_from, cval, aligned,
                       s);
}

const char* rs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
