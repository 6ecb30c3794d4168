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
//   w   bf16: [C2p/BN, C1p/64, 9, BN, 64], each [BN, 64] slice the exact
//       shared-memory image of one pipeline stage (K-major, 128-byte swizzle:
//       the 16-byte group g of row n sits at position g ^ (n % 8));
//       f32: [9, C1p, C2p] tap-major (tap = dy*3 + dx). Zero past C1 and C2.
//       ops/conv_fused.py::pack builds both.
//   out [B, H, W, C2]   NHWC, y's dtype
// H, W, C1, C2 are otherwise free: ragged tiles and channel tails are
// masked, so odd pooled sizes work.
//
// Rounding: z is rounded to y's dtype after the product and after the sum,
// as the unfused chain relu(y*a + b) of two tensor ops materializes it.
// Products accumulate in f32; the output is rounded once to y's dtype.
//
// What bounds it on an H100: per output pixel the work is 2*9*C1*C2 FLOP
// against (C1 + C2) * 2 bytes that must move (bf16), i.e. 9*C1*C2/(C1+C2)
// FLOP per byte: 288 at C1 = C2 = 64 (inc, up4: 0.31-0.32 ms per batch-16
// level, bytes and operations about even), 576 or more at every deeper level
// (0.08 ms at down4 to 0.31 ms at down1/up3 per batch of 16, operations).
// So the tensor cores bound it, and only wgmma reaches their full rate.
//
// Design of the bf16 kernel (an implicit GEMM: M = output pixels, N = C2,
// K = 9 taps x C1):
//   * A block is two consumer warpgroups and one producer warpgroup. It owns
//     an output tile of TH x 16 pixels (TH = 8*MT) x BN channels and walks
//     the tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... (a persistent
//     grid, one block per SM), the output-channel tiles of one pixel tile
//     next to each other so their halo is read from L2. Tiles per C2
//     (ops/conv_fused.py::tile_config): BN 64 x 32x16 pixels, BN 128 x
//     16x16, BN 256 x 8x16.
//   * K runs over chunks of 64 input channels and, per chunk, the 9 taps.
//     One producer warp issues a TMA load per chunk for the raw
//     (TH+2) x 18 x 64 halo of y (the tensor map zero-fills outside the image
//     and past C1; 128-byte swizzle) into a 2-3 stage ring, and one
//     cp.async.bulk per (chunk, tap) for the [BN, 64] weight stage that pack()
//     laid out as its exact shared-memory image, into a 4-6 stage ring. Full
//     and empty mbarriers pace both rings, so loads run ahead of the math
//     and across tile boundaries.
//   * The producer warpgroup's other three warps turn each raw halo into z
//     in place, once per chunk: relu(y*a+b) with both roundings, and 0
//     outside the image (a zero-filled y would give relu(b) there). A third
//     barrier tells the consumers that z is ready, so the pass never stops
//     their wgmmas. setmaxnreg gives the consumers 224 registers and the
//     producer side 56.
//   * The nine taps are nine shifted views of one halo. A wgmma descriptor
//     cannot start a tile one pixel into an 8-row core matrix, but ldmatrix
//     takes one row address per lane: each warp loads its 16-pixel row of the
//     tap's A fragment from the shifted halo address and issues
//     wgmma.mma_async m64nBNk16 with A in registers and B (the weight stage)
//     from shared memory through a 128-byte-swizzle descriptor. The halo is
//     swizzled the same way (pixel p's group g at g ^ (p % 8)), so the eight
//     rows of each ldmatrix hit eight different bank groups.
//   * Each warpgroup owns MT m64 tiles; f32 accumulators stay in registers.
//     A warp's rows are consecutive, so tap (dy, dx) of row r is tap (0, dx)
//     of row r + dy. At BN = 64, whose MMAs are bound by shared-memory
//     reads, the K loop runs dx-major: per k16 step a warp loads its MT + 2
//     halo rows once for the three dy taps (3*MT loads tap by tap). The
//     other tiles go tap by tap. Two register sets for A
//     alternate between groups, and wgmma.wait_group 1 keeps one group
//     queued behind the running one.
//   * Epilogue: each warp rounds its accumulators to bf16, stmatrix-es 16
//     pixels x 64 channels at a time into its staging rows and writes them
//     as 16-byte stores, 128 contiguous bytes per pixel (C2 % 8 == 0; other
//     C2 store straight from registers), masked at the image edge and past C2.
//   * y needs C1 % 8 == 0 and 16-byte alignment for the tensor map; other
//     shapes (channel tails) take a scalar halo load in the producer warp,
//     in the same kernel.
// The f32 kernel (FMA, no TF32: the tests' f32 step, on no bf16 main path)
// stages synchronously: 4 warps per 8 x 16 pixel x 64 channel tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32 z, as the unfused chain computes it in f32.

__device__ __forceinline__ float affine_relu(float y, float a, float b) {
  const float t = __fadd_rn(__fmul_rn(y, a), b);
  return t > 0.f ? t : 0.f;
}

// ---------------------------------------------------------------------------
// bf16: wgmma implicit GEMM.

constexpr int KCH = 64;           // input channels per chunk: one 128-byte row
constexpr int TW = 16;            // output columns per tile: one warp's A rows
constexpr int HALO_W = TW + 2;
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int ZPASS = 96;         // threads of the z pass: 3 producer-side warps
constexpr int STG_WARP = 16 * 128;  // a warp's epilogue staging: 16 pixels x 64 channels
// + a producer warpgroup: setmaxnreg.inc only takes registers that other
// warps released with setmaxnreg.dec, so the producer side must be a whole
// warpgroup for the consumers to get 224 registers.
constexpr int THREADS_H = CONSUMERS + 128;

template <int BN, int MT>
struct Cfg {
  // dx-major K loop (see the header) for the 64-channel tile, whose MMAs
  // are bound by shared-memory reads; it consumes weight stages three at a
  // time, so its ring is deeper.
  static constexpr bool DX_MAJOR = MT >= 4;
  static constexpr int WST = DX_MAJOR ? 6 : 4;
  static constexpr int ZST = MT >= 4 ? 2 : 3;
  static constexpr int TH = 8 * MT;
  static constexpr int HALO_H = TH + 2;
  static constexpr int HALO_PIX = HALO_H * HALO_W;
  static constexpr int Z_TX = HALO_PIX * KCH * 2;        // bytes of one halo
  static constexpr int Z_BYTES = (Z_TX + 1023) / 1024 * 1024;
  static constexpr int W_BYTES = BN * KCH * 2;           // one weight stage
  static constexpr int STG_OFF = WST * W_BYTES + ZST * Z_BYTES;  // epilogue staging
  static constexpr int BAR_OFF = STG_OFF + (CONSUMERS / 32) * STG_WARP;
  static constexpr int SMEM = 1024 + BAR_OFF + (3 * ZST + 2 * WST) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int x, int y, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(n), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t* r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of ``v`` across a wgmma fence.
__device__ __forceinline__ void fence_operand(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// Shared-memory descriptor of a K-major [BN, 64] bf16 stage in the 128-byte
// swizzle (8-row atoms of 1024 bytes; the leading offset is unused).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// D[64 x N] += A[64 x 16] (registers, bf16) * B[16 x N] (descriptor), f32.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

struct TileH {
  int n, h0, w0, n0;
};

template <int TH>
__device__ __forceinline__ TileH tile_h(int t, int H, int W, int n_tiles_c2, int bn) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_hw = ((H + TH - 1) / TH) * tiles_w;
  const int m = t / n_tiles_c2;
  const int r = m % tiles_hw;
  TileH o;
  o.n0 = (t - m * n_tiles_c2) * bn;
  o.n = m / tiles_hw;
  o.h0 = (r / tiles_w) * TH;
  o.w0 = (r % tiles_w) * TW;
  return o;
}

// z = relu(y*a+b) in place for thread j's 16-byte groups of one staged halo
// (swizzled: pixel p's group g at byte p*128 + ((g ^ (p % 8)) * 16)), 0
// outside the image. Thread j of NT owns group g = j % 8 of the pixels
// p = j / 8 + (NT / 8) i. bf16 products round once from the exact product,
// which is the f32 product rounded; the sum runs in f32 and rounds to bf16
// (with the ReLU) as the unfused chain's two ops do.
template <int HALO_PIX, int NT>
__device__ __forceinline__ void transform_halo(unsigned char* zs, const TileH& t, int c0,
                                               const bf16* __restrict__ a,
                                               const bf16* __restrict__ b, int H, int W,
                                               int j) {
  static_assert(NT % 8 == 0, "a thread keeps one group of channels");
  const int g = j & 7;
  const uint4 araw = *reinterpret_cast<const uint4*>(a + c0 + g * 8);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&araw);
  float bfv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bfv[i] = __bfloat162float(b[c0 + g * 8 + i]);
#pragma unroll 2
  for (int p = j >> 3; p < HALO_PIX; p += NT / 8) {
    const int hr = p / HALO_W;
    const int ih = t.h0 - 1 + hr;
    const int iw = t.w0 - 1 + (p - hr * HALO_W);
    uint4* ptr = reinterpret_cast<uint4*>(zs + p * 128 + ((g ^ (p & 7)) << 4));
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
      v = *ptr;
      uint32_t* h = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&h[i]), a2[i]));
        asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;"
            : "=r"(h[i])
            : "f"(__fadd_rn(f.y, bfv[2 * i + 1])), "f"(__fadd_rn(f.x, bfv[2 * i])));
      }
    }
    *ptr = v;
  }
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS_H, 1)
    conv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap ymap,
                           const bf16* __restrict__ y, const bf16* __restrict__ a,
                           const bf16* __restrict__ b, const bf16* __restrict__ w,
                           bf16* __restrict__ out, int B, int H, int W, int C1, int C2, int nk,
                           int n_tiles_c2, int n_tiles, int vec) {
  using C = Cfg<BN, MT>;
  constexpr int WST = C::WST;
  constexpr int ZST = C::ZST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* wsm = smem;                         // WST x W_BYTES
  unsigned char* zsm = smem + C::WST * C::W_BYTES;   // ZST x Z_BYTES
  const uint32_t bars = smem_u32(smem + C::BAR_OFF);
  const uint32_t full_z = bars, empty_z = bars + 8 * ZST;
  const uint32_t full_w = bars + 16 * ZST, empty_w = bars + 16 * ZST + 8 * WST;
  const uint32_t zready = bars + 16 * ZST + 16 * WST;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < ZST; ++s) {
      mbar_init(full_z + 8 * s, vec ? 1 : 32);
      mbar_init(empty_z + 8 * s, CONSUMERS / 32);
      mbar_init(zready + 8 * s, ZPASS / 32);
    }
    for (int s = 0; s < WST; ++s) {
      mbar_init(full_w + 8 * s, 1);
      mbar_init(empty_w + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // This block's tiles and chunks: chunk q is chunk q % nk of its tile q / nk.
  const int my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int n_chunks = my_tiles * nk;
  auto tile_of_chunk = [&](int q) {
    return tile_h<C::TH>(blockIdx.x + (q / nk) * gridDim.x, H, W, n_tiles_c2, BN);
  };

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: warp 0 loads, warps 1-3 run the z pass ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int lane = tid & 31;
    if (tid >= CONSUMERS + 32) {
      const int j = tid - CONSUMERS - 32;
      for (int q = 0; q < n_chunks; ++q) {
        const int s = q % ZST;
        mbar_wait(full_z + 8 * s, (q / ZST) & 1);
        transform_halo<C::HALO_PIX, ZPASS>(zsm + s * C::Z_BYTES, tile_of_chunk(q), (q % nk) * KCH,
                                           a, b, H, W, j);
        // Generic writes before the next TMA into the stage, then release.
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(zready + 8 * s);
      }
      return;
    }
    auto load_z = [&](int q) {
      const int s = q % ZST;
      mbar_wait(empty_z + 8 * s, ((q / ZST) & 1) ^ 1);
      const TileH t = tile_of_chunk(q);
      const int c0 = (q % nk) * KCH;
      unsigned char* dst = zsm + s * C::Z_BYTES;
      if (vec) {
        if (lane == 0) {
          mbar_expect_tx(full_z + 8 * s, C::Z_TX);
          tma_load_4d(smem_u32(dst), &ymap, full_z + 8 * s, c0, t.w0 - 1, t.h0 - 1, t.n);
        }
      } else {
        // Scalar load of the raw halo in the same swizzled layout, 0 outside
        // the image and past C1 (the z pass masks the border again).
        for (int e = lane; e < C::HALO_PIX * KCH; e += 32) {
          const int p = e / KCH, c = e % KCH;
          const int hr = p / HALO_W;
          const int ih = t.h0 - 1 + hr, iw = t.w0 - 1 + (p - hr * HALO_W);
          bf16 v = __float2bfloat16(0.f);
          if (ih >= 0 && ih < H && iw >= 0 && iw < W && c0 + c < C1) {
            v = y[((static_cast<size_t>(t.n) * H + ih) * W + iw) * C1 + c0 + c];
          }
          *reinterpret_cast<bf16*>(dst + p * 128 + (((c >> 3) ^ (p & 7)) << 4) + (c & 7) * 2) = v;
        }
        mbar_arrive(full_z + 8 * s);
      }
    };
    if (n_chunks > 0) load_z(0);
    for (int q = 0; q < n_chunks; ++q) {
      if (q + 1 < n_chunks) load_z(q + 1);
      const TileH t = tile_of_chunk(q);
      const int kc = q % nk;
      for (int st = 0; st < 9; ++st) {
        // Stage st of the chunk: tap st, or st = dx*3 + dy in the dx-major order.
        const int tap = C::DX_MAJOR ? (st % 3) * 3 + st / 3 : st;
        const int i = q * 9 + st;
        const int s = i % WST;
        mbar_wait(empty_w + 8 * s, ((i / WST) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full_w + 8 * s, C::W_BYTES);
          const bf16* src =
              w + ((static_cast<size_t>(t.n0 / BN) * nk + kc) * 9 + tap) * (BN * KCH);
          bulk_load(smem_u32(wsm + s * C::W_BYTES), src, C::W_BYTES, full_w + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  // This warp owns output rows warp*MT + mt (mt < MT) of its warpgroup's
  // 4*MT; m64 tile mt is row warp*MT + mt of each of the four warps. hp0:
  // the halo pixel of this lane's A row (pixel column lane % 16) in the
  // warp's first row for tap (0, 0); khalf: the lane's 8-channel half of a
  // k16 step.
  const int hp0 = (wg * 4 * MT + warp * MT) * HALO_W + (lane & 15);
  const int khalf = lane >> 4;
  float acc[MT][BN / 2];

  for (int q = 0; q < n_chunks; ++q) {
    mbar_wait(zready + 8 * (q % ZST), (q / ZST) & 1);  // z(q) is ready
    const int kc = q % nk;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
      }
    }
    const uint32_t zbase = smem_u32(zsm + (q % ZST) * C::Z_BYTES);
    const int i0 = q * 9;  // this chunk's first weight stage in the ring
    if constexpr (C::DX_MAJOR) {
      // dx-major: the three dy taps of one dx read halo rows that overlap,
      // since row r at tap dy is row r + dy at tap 0. Per k16 step a warp
      // loads its MT + 2 rows once (3*MT loads tap by tap) and feeds them to
      // 3*MT wgmmas over the three resident weight stages (dx, dy).
      uint32_t fr[2][MT + 2][4];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        uint32_t wb[3];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int i = i0 + dx * 3 + dy;
          mbar_wait(full_w + 8 * (i % WST), (i / WST) & 1);
          wb[dy] = smem_u32(wsm + (i % WST) * C::W_BYTES);
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int set = (dx * 4 + kk) & 1;
#pragma unroll
          for (int j = 0; j < MT + 2; ++j) {
            const int hp = hp0 + j * HALO_W + dx;
            ldmatrix_x4(fr[set][j], zbase + hp * 128 + (((kk * 2 + khalf) ^ (hp & 7)) << 4));
          }
          wgmma_fence();
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const uint64_t desc = desc_sw128(wb[dy] + kk * 32);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) wgmma_rs<BN>(acc[mt], fr[set][mt + dy], desc);
          }
          wgmma_commit();
          wgmma_wait<1>();
          // The group before this one is done: if it closed a dx, its three
          // weight stages are free.
          if (kk == 0 && dx > 0 && (tid & 127) == 0) {
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) mbar_arrive(empty_w + 8 * ((i0 + dx * 3 - 3 + dy) % WST));
          }
        }
      }
    } else {
      // Tap by tap, one group of four k16 steps per tap.
      uint32_t afr[2][MT][4][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const int i = i0 + tap;
        mbar_wait(full_w + 8 * (i % WST), (i / WST) & 1);
        const uint32_t wbase = smem_u32(wsm + (i % WST) * C::W_BYTES);
        __syncwarp();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int hp = hp0 + (mt + dy) * HALO_W + dx;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            ldmatrix_x4(afr[tap & 1][mt][kk],
                        zbase + hp * 128 + (((kk * 2 + khalf) ^ (hp & 7)) << 4));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t desc = desc_sw128(wbase + kk * 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) wgmma_rs<BN>(acc[mt], afr[tap & 1][mt][kk], desc);
        }
        wgmma_commit();
        wgmma_wait<1>();
        // The tap before this one is done: its weight stage is free.
        if (tap > 0 && (tid & 127) == 0) mbar_arrive(empty_w + 8 * ((i - 1) % WST));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[mt][i]);
    }
    if ((tid & 127) == 0) {
#pragma unroll
      for (int t = C::DX_MAJOR ? 6 : 8; t < 9; ++t) mbar_arrive(empty_w + 8 * ((i0 + t) % WST));
    }
    // This warp's reads of z(q) are done; they are ordered before the next
    // TMA into the stage.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_z + 8 * (q % ZST));

    if (kc == nk - 1) {
      // Epilogue. The accumulator layout of wgmma m64nN: this lane holds
      // rows lane/4 and lane/4 + 8 of its warp's 16 (pixel columns), columns
      // 8j + 2(lane%4) + {0, 1} of each n8 block j.
      const TileH t = tile_of_chunk(q);
      if ((C2 & 7) == 0) {
        // stmatrix each 16-pixel x 64-channel block into this warp's staging
        // rows (groups swizzled by row), then 16-byte stores: 8 lanes write
        // one pixel's 128 contiguous bytes.
        const uint32_t stg = smem_u32(smem + C::STG_OFF + (tid >> 5) * STG_WARP);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int oh = t.h0 + wg * 4 * MT + warp * MT + mt;
#pragma unroll
          for (int blk = 0; blk < BN / 64; ++blk) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
#pragma unroll
              for (int jj = 0; jj < 8; jj += 4) {
                uint32_t r[4];
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                  const int j = blk * 8 + jj + m;
                  r[m] = pack_bf16x2(acc[mt][4 * j + 2 * half], acc[mt][4 * j + 2 * half + 1]);
                }
                const int row = half * 8 + (lane & 7), grp = jj + (lane >> 3);
                stmatrix_x4(stg + row * 128 + ((grp ^ (row & 7)) << 4), r);
              }
            }
            __syncwarp();
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int c = lane + 32 * k;
              const int row = c >> 3, grp = c & 7;
              const int ow = t.w0 + row;
              const int co = t.n0 + blk * 64 + grp * 8;
              const uint4 v = *reinterpret_cast<const uint4*>(
                  smem + C::STG_OFF + (tid >> 5) * STG_WARP + row * 128 + ((grp ^ (row & 7)) << 4));
              if (t.n < B && oh < H && ow < W && co < C2) {
                *reinterpret_cast<uint4*>(
                    out + ((static_cast<size_t>(t.n) * H + oh) * W + ow) * C2 + co) = v;
              }
            }
            __syncwarp();
          }
        }
      } else {
        const bool pair = (C2 & 1) == 0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int oh = t.h0 + wg * 4 * MT + warp * MT + mt;
          if (oh >= H) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ow = t.w0 + (lane >> 2) + half * 8;
            if (ow >= W) continue;
            bf16* dst = out + ((static_cast<size_t>(t.n) * H + oh) * W + ow) * C2;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int co = t.n0 + j * 8 + (lane & 3) * 2;
              const float v0 = acc[mt][4 * j + 2 * half], v1 = acc[mt][4 * j + 2 * half + 1];
              if (pair) {
                if (co < C2) {
                  *reinterpret_cast<__nv_bfloat162*>(dst + co) = __floats2bfloat162_rn(v0, v1);
                }
              } else {
                if (co < C2) dst[co] = __float2bfloat16(v0);
                if (co + 1 < C2) dst[co + 1] = __float2bfloat16(v1);
              }
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA on 8 x 16 pixel x 64 channel tiles.

constexpr int TH_F = 8;
constexpr int HALO_PIX_F = (TH_F + 2) * HALO_W;
constexpr int BN_F = 64;   // output channels per block
constexpr int KC_F = 32;   // input channels per K step
constexpr int THREADS_F = 128;
constexpr int ZLD_F = KC_F + 1;
constexpr int SMEM_Z_F = HALO_PIX_F * ZLD_F * 4;
constexpr int SMEM_F = SMEM_Z_F + 9 * KC_F * BN_F * 4;
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
  r.n0 = cb * BN_F;
  r.h0 = (t / tiles_w) * TH_F;
  r.w0 = (t % tiles_w) * TW;
  return r;
}

// Stage z = relu(y*a+b) for the block's halo and input channels
// [c0, c0+KC_F), as groups of 8 channels; 0 outside the image and past C1.
// ``vec``: C1 % 8 == 0 and y is 16-byte aligned.
__device__ __forceinline__ void stage_z_f32(float* zs, const float* __restrict__ y,
                                            const float* __restrict__ a,
                                            const float* __restrict__ b, const Tile& t, int c0,
                                            int H, int W, int C1, bool vec) {
  constexpr int G = KC_F / 8;
  for (int g = threadIdx.x; g < HALO_PIX_F * G; g += THREADS_F) {
    const int pix = g / G;
    const int c = c0 + (g % G) * 8;
    const int ih = t.h0 - 1 + pix / HALO_W;
    const int iw = t.w0 - 1 + pix % HALO_W;
    float v[8];
    if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < C1) {
      const float* src = y + ((static_cast<size_t>(t.n) * H + ih) * W + iw) * C1 + c;
      if (vec) {
        const float4 u0 = reinterpret_cast<const float4*>(src)[0];
        const float4 u1 = reinterpret_cast<const float4*>(src)[1];
        const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = affine_relu(u[j], a[c + j], b[c + j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = c + j < C1 ? affine_relu(src[j], a[c + j], b[c + j]) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    float* dst = zs + pix * ZLD_F + (c - c0);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = v[j];
  }
}

// Stage w[tap, c0:c0+KC_F, n0:n0+BN_F] as [9*KC_F][BN_F]. The padded weight
// tensor makes every group in range and 16-byte aligned.
__device__ __forceinline__ void stage_w_f32(float* ws, const float* __restrict__ w,
                                            const Tile& t, int c0, int C1p, int C2p) {
  constexpr int G = BN_F / 8;
  for (int g = threadIdx.x; g < 9 * KC_F * G; g += THREADS_F) {
    const int row = g / G;  // tap * KC_F + k
    const int cg = g % G;
    const int tap = row / KC_F;
    const int k = row % KC_F;
    const float4* src = reinterpret_cast<const float4*>(
        w + (static_cast<size_t>(tap) * C1p + c0 + k) * C2p + t.n0 + cg * 8);
    float4* dst = reinterpret_cast<float4*>(ws + row * BN_F + cg * 8);
    dst[0] = src[0];
    dst[1] = src[1];
  }
}

__global__ void __launch_bounds__(THREADS_F)
    conv_f32_kernel(const float* __restrict__ y, const float* __restrict__ a,
                    const float* __restrict__ b, const float* __restrict__ w,
                    float* __restrict__ out, int H, int W, int C1, int C2, int C1p, int C2p,
                    int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + SMEM_Z_F);
  const Tile t = tile_of(W, C2p / BN_F);
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

  for (int c0 = 0; c0 < C1p; c0 += KC_F) {
    __syncthreads();
    stage_z_f32(zs, y, a, b, t, c0, H, W, C1, vec != 0);
    stage_w_f32(ws, w, t, c0, C1p, C2p);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      const float* zrow = zs + ((r + dy) * HALO_W + cb + dx) * ZLD_F;
      const float* wrow = ws + tap * KC_F * BN_F + cg * 8;
#pragma unroll 4
      for (int k = 0; k < KC_F; ++k) {
        const float4 w0 = *reinterpret_cast<const float4*>(wrow + k * BN_F);
        const float4 w1 = *reinterpret_cast<const float4*>(wrow + k * BN_F + 4);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled = nullptr;

#define FP_BF16_CONFIGS(X) \
  X(64, 4) X(128, 2) X(256, 1)

// Lets the kernels use more than 48 KiB of dynamic shared memory on the
// current device and finds the driver's tensor-map encoder. Call once per
// device before the first launch there; returns the cudaError_t (0 = success).
int fp_prepare() {
  cudaError_t err;
#define FP_SET_SMEM(BN, MT)                                                                \
  err = cudaFuncSetAttribute(conv_bf16_wgmma_kernel<BN, MT>,                                 \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN, MT>::SMEM); \
  if (err != cudaSuccess) return static_cast<int>(err);
  FP_BF16_CONFIGS(FP_SET_SMEM)
#undef FP_SET_SMEM
  err = cudaFuncSetAttribute(conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_F);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (encode_tiled == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return static_cast<int>(cudaErrorSymbolNotFound);
    }
    encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  }
  return 0;
}

// Launches the kernel on ``stream``; returns the cudaError_t of the launch
// (0 = success). ``is_bf16`` selects bf16 (wgmma; ``bn`` x ``mt`` name the
// tile, ``n_blocks`` the persistent grid) or f32 (FMA); ``vec`` says
// C1 % 8 == 0 and y is 16-byte aligned. ``fp_prepare`` must have run on the
// stream's device.
int fp_relu_affine_conv3x3(const void* y, const void* a, const void* b, const void* w,
                           void* out, int B, int H, int W, int C1, int C2, int C1p, int C2p,
                           int is_bf16, int vec, int bn, int mt, int n_blocks,
                           void* stream) {
  if (B < 1 || H < 1 || W < 1 || C1 < 1 || C2 < 1 || C1p < C1 || C2p < C2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (B > 65535 || C1p % KC_F || C2p % BN_F) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks =
        static_cast<long long>((H + TH_F - 1) / TH_F) * ((W + TW - 1) / TW) * (C2p / BN_F);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
    conv_f32_kernel<<<grid, THREADS_F, SMEM_F, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<const float*>(w), static_cast<float*>(out), H,
        W, C1, C2, C1p, C2p, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (C1p % KCH || C2p % bn || n_blocks < 1 || encode_tiled == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int th = 8 * mt;
  const long long tiles = static_cast<long long>(B) * ((H + th - 1) / th) * ((W + TW - 1) / TW) *
                          (C2p / bn);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = static_cast<int>(tiles);
  const int grid = n_tiles < n_blocks ? n_tiles : n_blocks;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (vec) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C1), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C1) * 2,
                                   static_cast<cuuint64_t>(W) * C1 * 2,
                                   static_cast<cuuint64_t>(H) * W * C1 * 2};
    const cuuint32_t box[4] = {KCH, HALO_W, static_cast<cuuint32_t>(th + 2), 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult r = encode_tiled(
        &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(y), dims, strides, box,
        estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nk = C1p / KCH;
  const int n_tiles_c2 = C2p / bn;
#define FP_LAUNCH(BN, MT)                                                                    \
  if (bn == BN && mt == MT) {                                                                          \
    conv_bf16_wgmma_kernel<BN, MT><<<grid, THREADS_H, Cfg<BN, MT>::SMEM, s>>>(             \
        map, static_cast<const bf16*>(y), static_cast<const bf16*>(a),                     \
        static_cast<const bf16*>(b), static_cast<const bf16*>(w), static_cast<bf16*>(out), \
        B, H, W, C1, C2, nk, n_tiles_c2, n_tiles, vec);                                       \
    return static_cast<int>(cudaGetLastError());                                           \
  }
  FP_BF16_CONFIGS(FP_LAUNCH)
#undef FP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);  // no such tile configuration
}

const char* fp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
