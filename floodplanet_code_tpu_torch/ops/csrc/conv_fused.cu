// conv_fused.cu — fused BN-apply + ReLU + 3x3 SAME convolution for Hopper.
//
// Replaces the Pallas TPU kernel floodplanet_code_tpu/ops/conv_fused.py::_kernel
// (launched by _pallas_impl, wrapped by relu_affine_conv3x3). It computes
//
//     out = conv3x3_SAME(z, w),   z = relu(y * a + b)
//
// where SAME padding applies to z: a tap outside the image adds 0, not
// relu(b). z only ever exists in shared memory.
//
// Layouts (all dense):
//   y   [B, H, W, C1]   NHWC, i.e. the memory of a channels_last NCHW tensor
//   a,b [C1p]           the folded BN apply, already in y's dtype, zero past C1
//   w   [9, C1p, C2p]   tap-major (dy*3+dx), input channel, output channel;
//                       zero past C1 and C2 (the wrapper pads it)
//   out [B, H, W, C2]   NHWC, y's dtype
// C1p is a multiple of KC and C2p of BN; H, W, C1, C2 are otherwise free
// (ragged tiles and channel tails are masked), so odd pooled sizes work.
//
// Rounding: z is rounded to y's dtype after the product and after the sum,
// as the unfused chain relu(y*a + b) of two tensor ops materializes it.
// Products accumulate in f32; the output is rounded once to y's dtype.
//
// What bounds it on an H100: per output pixel the work is 2*9*C1*C2 FLOP
// against (C1 + C2) * 2 bytes that must move (bf16), i.e. 9*C1*C2/(C1+C2)
// FLOP per byte: 288 at C1 = C2 = 64, near the card's bf16 balance point of
// ~295, and 576 or more at every deeper level. So the tensor cores bound it.
//
// Design (the simple first version; not yet tuned for Hopper):
//   * One block of 4 warps computes an 8 x 16 pixel x 64 output-channel tile.
//   * The K loop walks the input channels KC = 32 at a time. Each step
//     stages the (8+2) x (16+2) x KC halo of z in shared memory, applying
//     relu(y*a+b) as it loads and writing 0 outside the image, and the
//     9 x KC x 64 slice of w.
//   * bf16: each warp owns two output rows. A row of 16 pixels is one WMMA
//     A tile read straight out of the halo at the tap's (dy, dx) offset, so
//     the nine taps are nine shifted reads of the same staged halo. The
//     products run on the tensor cores (WMMA 16x16x16, f32 accumulators).
//   * f32: the same staging; each thread accumulates 8 pixels x 8 channels
//     with FMA, so the f32 path keeps f32 accuracy (no TF32).
//   * The grid walks the output-channel blocks fastest, so blocks that read
//     the same input halo run close together and find it in L2.
// Not done yet: cp.async/TMA double buffering, wgmma, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block: one WMMA M tile
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;
constexpr int BN = 64;   // output channels per block
constexpr int KC = 32;   // input channels per K step
constexpr int THREADS = 128;

// bf16 path. WMMA wants 32-byte aligned tile pointers: a pixel stride of
// 48 elements (96 bytes) keeps every (dy, dx) offset aligned.
constexpr int ZLD_H = KC + 16;
constexpr int WLD_H = BN + 16;
constexpr int CLD = BN + 4;  // f32 epilogue tile stride
constexpr int SMEM_Z_H = HALO_PIX * ZLD_H * 2;
constexpr int SMEM_H = SMEM_Z_H + 9 * KC * WLD_H * 2;
static_assert(TH * TW * CLD * 4 <= SMEM_H, "epilogue tile must fit");
static_assert(TH == 2 * (THREADS / 32), "each warp owns two output rows");

// f32 path.
constexpr int ZLD_F = KC + 1;
constexpr int SMEM_Z_F = HALO_PIX * ZLD_F * 4;
constexpr int SMEM_F = SMEM_Z_F + 9 * KC * BN * 4;
static_assert(SMEM_Z_F % 16 == 0, "weight tile must stay 16-byte aligned");

struct Tile {
  int n, h0, w0, n0;
};

__device__ __forceinline__ Tile tile_of(int W, int c2_blocks) {
  const int tiles_w = (W + TW - 1) / TW;
  const int cb = blockIdx.x % c2_blocks;
  const int t = blockIdx.x / c2_blocks;
  Tile r;
  r.n = blockIdx.y;
  r.n0 = cb * BN;
  r.h0 = (t / tiles_w) * TH;
  r.w0 = (t % tiles_w) * TW;
  return r;
}

__device__ __forceinline__ float affine_relu(float y, float a, float b) {
  const float t = __fadd_rn(__fmul_rn(y, a), b);
  return t > 0.f ? t : 0.f;
}

__device__ __forceinline__ bf16 affine_relu(bf16 y, bf16 a, bf16 b) {
  const float p = __bfloat162float(
      __float2bfloat16(__fmul_rn(__bfloat162float(y), __bfloat162float(a))));
  const float t = __bfloat162float(
      __float2bfloat16(__fadd_rn(p, __bfloat162float(b))));
  return __float2bfloat16(t > 0.f ? t : 0.f);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// 8 consecutive elements, 16-byte aligned at both ends.
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
  constexpr int N = 8 * sizeof(T) / 16;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
}

// Stage z = relu(y*a+b) for the block's (TH+2) x (TW+2) halo and input
// channels [c0, c0+KC), as groups of 8 channels. 0 outside the image and
// past C1. ``vec``: C1 % 8 == 0 and y is 16-byte aligned.
template <typename T, int ZLD>
__device__ __forceinline__ void stage_z(T* zs, const T* __restrict__ y,
                                        const T* __restrict__ a,
                                        const T* __restrict__ b, const Tile& t,
                                        int c0, int H, int W, int C1,
                                        bool vec) {
  constexpr int G = KC / 8;
  for (int g = threadIdx.x; g < HALO_PIX * G; g += THREADS) {
    const int pix = g / G;
    const int c = c0 + (g % G) * 8;
    const int ih = t.h0 - 1 + pix / HALO_W;
    const int iw = t.w0 - 1 + pix % HALO_W;
    __align__(16) T v[8];
    if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < C1) {
      const T* src = y + ((static_cast<size_t>(t.n) * H + ih) * W + iw) * C1 + c;
      if (vec) {
        copy8(v, src);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = affine_relu(v[j], a[c + j], b[c + j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = c + j < C1 ? affine_relu(src[j], a[c + j], b[c + j]) : zero<T>();
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = zero<T>();
    }
    T* dst = zs + pix * ZLD + (c - c0);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = v[j];
  }
}

// Stage w[tap, c0:c0+KC, n0:n0+BN] as [9*KC][WLD]. The padded weight
// tensor makes every group in range and 16-byte aligned.
template <typename T, int WLD>
__device__ __forceinline__ void stage_w(T* ws, const T* __restrict__ w,
                                        const Tile& t, int c0, int C1p,
                                        int C2p) {
  constexpr int G = BN / 8;
  for (int g = threadIdx.x; g < 9 * KC * G; g += THREADS) {
    const int row = g / G;  // tap * KC + k
    const int cg = g % G;
    const int tap = row / KC;
    const int k = row % KC;
    copy8(ws + row * WLD + cg * 8,
          w + (static_cast<size_t>(tap) * C1p + c0 + k) * C2p + t.n0 + cg * 8);
  }
}

__global__ void __launch_bounds__(THREADS)
    conv_bf16_kernel(const bf16* __restrict__ y, const bf16* __restrict__ a,
                     const bf16* __restrict__ b, const bf16* __restrict__ w,
                     bf16* __restrict__ out, int H, int W, int C1, int C2,
                     int C1p, int C2p, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* zs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + SMEM_Z_H);
  float* cs = reinterpret_cast<float*>(smem);
  const Tile t = tile_of(W, C2p / BN);
  const int row0 = 2 * (threadIdx.x / 32);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  for (int c0 = 0; c0 < C1p; c0 += KC) {
    __syncthreads();  // the previous step's reads are done
    stage_z<bf16, ZLD_H>(zs, y, a, b, t, c0, H, W, C1, vec != 0);
    stage_w<bf16, WLD_H>(ws, w, t, c0, C1p, C2p);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // A(m, k) = z at halo pixel (row0+i+dy, m+dx), channel kk+k.
          wmma::load_matrix_sync(
              fa[i], zs + ((row0 + i + dy) * HALO_W + dx) * ZLD_H + kk, ZLD_H);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, ws + (tap * KC + kk) * WLD_H + j * 16, WLD_H);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
  }

  __syncthreads();  // the halo and weight tiles become the epilogue tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs + (row0 + i) * TW * CLD + j * 16, acc[i][j], CLD,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  const bool vec_out = C2 % 8 == 0;
  for (int g = threadIdx.x; g < TH * TW * (BN / 8); g += THREADS) {
    const int p = g / (BN / 8);
    const int co = t.n0 + (g % (BN / 8)) * 8;
    const int oh = t.h0 + p / TW;
    const int ow = t.w0 + p % TW;
    if (oh >= H || ow >= W || co >= C2) continue;
    const float* src = cs + p * CLD + (co - t.n0);
    bf16* dst = out + ((static_cast<size_t>(t.n) * H + oh) * W + ow) * C2 + co;
    if (vec_out) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(src[j]);
      copy8(dst, v);
    } else {
      for (int j = 0; j < 8 && co + j < C2; ++j) dst[j] = __float2bfloat16(src[j]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    conv_f32_kernel(const float* __restrict__ y, const float* __restrict__ a,
                    const float* __restrict__ b, const float* __restrict__ w,
                    float* __restrict__ out, int H, int W, int C1, int C2,
                    int C1p, int C2p, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + SMEM_Z_F);
  const Tile t = tile_of(W, C2p / BN);
  // Thread -> 8 output channels (cg) x 8 consecutive pixels of one row.
  const int cg = threadIdx.x % 8;
  const int pg = threadIdx.x / 8;
  const int r = pg / 2;
  const int cb = (pg % 2) * 8;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  }

  for (int c0 = 0; c0 < C1p; c0 += KC) {
    __syncthreads();
    stage_z<float, ZLD_F>(zs, y, a, b, t, c0, H, W, C1, vec != 0);
    stage_w<float, BN>(ws, w, t, c0, C1p, C2p);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      const float* zrow = zs + ((r + dy) * HALO_W + cb + dx) * ZLD_F;
      const float* wrow = ws + tap * KC * BN + cg * 8;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float4 w0 = *reinterpret_cast<const float4*>(wrow + k * BN);
        const float4 w1 = *reinterpret_cast<const float4*>(wrow + k * BN + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float z = zrow[p * ZLD_F + k];
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(z, wv[q], acc[p][q]);
        }
      }
    }
  }

  const int oh = t.h0 + r;
  if (oh >= H) return;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ow = t.w0 + cb + p;
    if (ow >= W) break;
    float* dst = out + ((static_cast<size_t>(t.n) * H + oh) * W + ow) * C2;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int co = t.n0 + cg * 8 + q;
      if (co < C2) dst[co] = acc[p][q];
    }
  }
}

}  // namespace

extern "C" {

// Lets both kernels use more than 48 KiB of dynamic shared memory on the
// current device. Call once per device before the first launch there;
// returns the cudaError_t (0 = success).
int fp_prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F));
}

// Launches the kernel on ``stream``; returns the cudaError_t of the launch
// (0 = success). ``is_bf16`` selects bf16 (tensor cores) or f32 (FMA);
// ``vec`` says C1 % 8 == 0 and y is 16-byte aligned. ``fp_prepare`` must
// have run on the stream's device.
int fp_relu_affine_conv3x3(const void* y, const void* a, const void* b,
                           const void* w, void* out, int B, int H, int W,
                           int C1, int C2, int C1p, int C2p, int is_bf16,
                           int vec, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C1 < 1 || C2 < 1 || B > 65535 || C1p % KC ||
      C2p % BN || C1p < C1 || C2p < C2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>((H + TH - 1) / TH) *
                           ((W + TW - 1) / TW) * (C2p / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    conv_bf16_kernel<<<grid, THREADS, SMEM_H, s>>>(
        static_cast<const bf16*>(y), static_cast<const bf16*>(a),
        static_cast<const bf16*>(b), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), H, W, C1, C2, C1p, C2p, vec);
  } else {
    conv_f32_kernel<<<grid, THREADS, SMEM_F, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<const float*>(w),
        static_cast<float*>(out), H, W, C1, C2, C1p, C2p, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
