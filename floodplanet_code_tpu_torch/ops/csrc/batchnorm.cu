// batchnorm.cu — train-mode BatchNorm + ReLU, forward and backward, for Hopper.
//
// Replaces no TPU kernel: the JAX package computes this function
// (floodplanet_code_tpu/ops/batchnorm.py::bn_relu_train) in plain jnp and
// leaves its fusion to XLA. On the card the same arithmetic in plain PyTorch
// (ops/batchnorm.py::_BNReLUTrain, which CPU tensors still run) takes ~26
// elementwise and reduction launches each way and moves ~140 bytes per bf16
// element of activation, forward and backward together; these kernels take
// three launches each way.
//
// An activation is a row-major [M, C] matrix: an NCHW tensor in channels_last
// memory, M = N*H*W. T is its type (bf16, f32, f64); A the statistics' type
// (f32, and f64 for an f64 x).
//
//   forward   stats      per row slab p: sum_x, sum_x^2 per channel    -> part [2, P, C]
//             finalize   the P partials summed in a fixed order: mean, m2 = E[x^2];
//                        var = max(m2 - mean*mean, 0), inv = rsqrt(var + eps),
//                        a = T(inv*scale), b = T(bias - mean*inv*scale)
//             apply      z = relu(T(T(x*a) + b))
//   backward  stats      dzm = T(T(x*a) + b) > 0 ? dz : 0, xhat = (x - mean)*inv;
//                        per slab: sum dzm, sum dzm*xhat                -> part [2, P, C]
//             finalize   the two sums; g = scale*inv, c1 = sum_dz/n, c2 = sum_dz_xhat/n
//             apply      dx = T(g*((dzm - c1) - xhat*c2))
//
// Every per-element and per-channel expression is the plain version's, in its
// order and with its roundings (T's products and sums computed in A and
// rounded to T, as PyTorch's elementwise kernels do; no contraction into an
// FMA: the __*_rn intrinsics), so that given the same statistics the outputs
// are the same bits. Only the sums run in another order, a fixed one: no
// atomics, so two launches on one input give the same bits. ``sum_dz/n`` is
// ``sum_dz * (1/n)`` with a host integer n, as PyTorch divides by a CPU
// scalar, and a true division by the group's count (a device tensor) with a
// process group.
//
// With a process group (SyncBN) the wrapper runs stage 1 (stats and the
// finalize's sums), its collective on those sums, then stage 2 (the rest of
// the finalize, then the apply). Stage 0 is both in one call.
//
// What bounds it on an H100: bytes. The forward reads x twice and writes z,
// the backward reads x and dz twice and writes dx: 16 bytes a bf16 element
// against the least 10 (x in, z out; x and dz in, dx out), ~3 us a million
// elements at 3.35 TB/s. The design: each thread owns 8 contiguous channels
// (one 16-byte load of bf16, two of f32, four of f64) and walks the rows of
// its slab, UNROLL rows in flight; its per-channel constants sit in
// registers; a block is TX channel threads by RY = 256/TX row lanes, so a
// warp reads whole 512-byte runs of consecutive rows where C is small. The
// grid (slabs P by channel tiles) comes from M and C
// (ops/batchnorm.py::grid): a 3,240-row level and a 2.6M-row level both fill
// the SMs. The partials stay small ([2, P, C], P ~ 1,000 at most) and the
// finalize (32 channels by 8 lanes a block) sums them in a fixed tree.
//
// One library per type and load width: built with -DBNR_DTYPE=0 (bf16), 1
// (f32) or 2 (f64) and -DBNR_VEC=1 (16-byte loads) or 0, each holding those
// kernels alone, so that a bf16 UNet fit compiles a sixth of them
// (ops/batchnorm.py loads a call's library at its first launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;
#if BNR_DTYPE == 0
using Elem = bf16;
#elif BNR_DTYPE == 1
using Elem = float;
#elif BNR_DTYPE == 2
using Elem = double;
#else
#error "build with -DBNR_DTYPE=0 (bf16), 1 (f32) or 2 (f64)"
#endif
#if !defined(BNR_VEC) || (BNR_VEC != 0 && BNR_VEC != 1)
#error "build with -DBNR_VEC=1 (16-byte loads) or 0"
#endif
constexpr bool VEC_LOADS = BNR_VEC == 1;
constexpr int CPT = 8;        // channels a thread owns
constexpr int THREADS = 256;  // per block of the row kernels
constexpr int FIN_CH = 32;    // finalize: channels a block
constexpr int FIN_LANES = 8;  // finalize: lanes summing one channel's partials

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

// Rows in flight per thread: registers per element grow with the type.
template <typename T> struct Unroll { static constexpr int value = 4; };
template <> struct Unroll<float> { static constexpr int value = 2; };
template <> struct Unroll<double> { static constexpr int value = 1; };

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float rsqrt_(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_(double a) { return rsqrt(a); }
// torch.clamp_min(v, 0) and F.relu: NaN stays, else max(v, 0).
__device__ __forceinline__ float max0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }
__device__ __forceinline__ double max0(double v) { return isnan(v) ? v : fmax(v, 0.0); }

// T's value in A, and an A value rounded to T.
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ void narrow(float v, bf16& out) { out = __float2bfloat16_rn(v); }
__device__ __forceinline__ void narrow(float v, float& out) { out = v; }
__device__ __forceinline__ void narrow(double v, double& out) { out = v; }
template <typename T, typename A>
__device__ __forceinline__ A round_t(A v) {
  T t;
  narrow(v, t);
  return widen(t);
}

// T(T(x*a) + b): the affine as the plain version computes it in x's type.
template <typename T, typename A>
__device__ __forceinline__ A affine(A x, A a, A b) {
  return round_t<T>(add_rn(round_t<T>(mul_rn(x, a)), b));
}

__device__ __forceinline__ void zero(bf16& v) { v = __float2bfloat16_rn(0.0f); }
__device__ __forceinline__ void zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void zero(double& v) { v = 0.0; }

// The CPT channels [c0, c0 + CPT) of one row; VEC: 16-byte loads (C % 8 == 0
// and 16-byte aligned rows), else one element at a time, zero past C.
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int c0, int C, T (&v)[CPT]) {
  if (VEC) {
    constexpr int N = sizeof(T) * CPT / 16;
    uint4 raw[N];
    const uint4* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) raw[i] = src[i];
    memcpy(v, raw, sizeof(raw));
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (c0 + i < C) v[i] = p[i];
      else zero(v[i]);
    }
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_row(T* __restrict__ p, int c0, int C, const T (&v)[CPT]) {
  if (VEC) {
    constexpr int N = sizeof(T) * CPT / 16;
    uint4 raw[N];
    memcpy(raw, v, sizeof(raw));
    uint4* dst = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = raw[i];
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (c0 + i < C) p[i] = v[i];
  }
}

// A thread's place: lane lx of TX across channels, row lane ly of RY.
struct Place {
  int lx, ly, ry, c0;
  long long r0, r1;
  __device__ Place(long long M, int C, int rows_per_slab, int tx) {
    lx = threadIdx.x % tx;
    ly = threadIdx.x / tx;
    ry = THREADS / tx;
    c0 = (blockIdx.y * tx + lx) * CPT;
    r0 = static_cast<long long>(blockIdx.x) * rows_per_slab;
    r1 = r0 + rows_per_slab < M ? r0 + rows_per_slab : M;
  }
};

template <typename A>
__device__ __forceinline__ void load_channels(const A* __restrict__ p, int c0, int C,
                                              A (&v)[CPT]) {
#pragma unroll
  for (int i = 0; i < CPT; ++i) v[i] = c0 + i < C ? p[c0 + i] : A(0);
}

template <typename T, typename A>
__device__ __forceinline__ void load_channels_t(const T* __restrict__ p, int c0, int C,
                                                A (&v)[CPT]) {
#pragma unroll
  for (int i = 0; i < CPT; ++i) v[i] = c0 + i < C ? widen(p[c0 + i]) : A(0);
}

// The block's per-channel sums of s and q over its RY row lanes, in a fixed
// tree, written as slab blockIdx.x's partials: part[0][p][c], part[1][p][c].
template <typename A>
__device__ __forceinline__ void block_partials(const Place& at, int tx, int C, const A (&s)[CPT],
                                               const A (&q)[CPT], A* __restrict__ part) {
  __shared__ A buf[THREADS * CPT];  // [CPT][RY][TX]: neighbouring lx, neighbouring words
  const long long P = gridDim.x;
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) buf[(i * at.ry + at.ly) * tx + at.lx] = pass ? q[i] : s[i];
    __syncthreads();
    for (int half = at.ry / 2; half > 0; half /= 2) {
      if (at.ly < half) {
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          buf[(i * at.ry + at.ly) * tx + at.lx] += buf[(i * at.ry + at.ly + half) * tx + at.lx];
      }
      __syncthreads();
    }
    if (at.ly == 0) {
      A* out = part + (pass * P + blockIdx.x) * C;
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        if (at.c0 + i < C) out[at.c0 + i] = buf[(i * at.ry) * tx + at.lx];
    }
    __syncthreads();
  }
}

// Forward statistics: per slab, sum x and sum x*x per channel.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
bnrelu_stats_kernel(const T* __restrict__ x, long long M, int C, int rows_per_slab, int tx,
                    typename Acc<T>::type* __restrict__ part) {
  using A = typename Acc<T>::type;
  constexpr int U = Unroll<T>::value;
  const Place at(M, C, rows_per_slab, tx);
  A s[CPT], q[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) s[i] = q[i] = A(0);
  if (at.c0 < C) {
    for (long long r = at.r0 + at.ly; r < at.r1; r += static_cast<long long>(at.ry) * U) {
      T v[U][CPT];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long row = r + static_cast<long long>(u) * at.ry;
        if (row < at.r1) {
          load_row<T, VEC>(x + row * C + at.c0, at.c0, C, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < CPT; ++i) zero(v[u][i]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          const A xv = widen(v[u][i]);
          s[i] += xv;
          q[i] += xv * xv;
        }
    }
  }
  block_partials(at, tx, C, s, q, part);
}

// Backward statistics: per slab, sum dzm and sum dzm*xhat per channel.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
bnrelu_grad_stats_kernel(const T* __restrict__ x, const T* __restrict__ dz, long long M, int C,
                         int rows_per_slab, int tx, const T* __restrict__ a,
                         const T* __restrict__ b, const typename Acc<T>::type* __restrict__ mean,
                         const typename Acc<T>::type* __restrict__ inv,
                         typename Acc<T>::type* __restrict__ part) {
  using A = typename Acc<T>::type;
  constexpr int U = Unroll<T>::value;
  const Place at(M, C, rows_per_slab, tx);
  A s[CPT], q[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) s[i] = q[i] = A(0);
  if (at.c0 < C) {
    A av[CPT], bv[CPT], mu[CPT], iv[CPT];
    load_channels_t(a, at.c0, C, av);
    load_channels_t(b, at.c0, C, bv);
    load_channels(mean, at.c0, C, mu);
    load_channels(inv, at.c0, C, iv);
    for (long long r = at.r0 + at.ly; r < at.r1; r += static_cast<long long>(at.ry) * U) {
      T xv[U][CPT], gv[U][CPT];
      bool in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long row = r + static_cast<long long>(u) * at.ry;
        in[u] = row < at.r1;
        if (in[u]) {
          load_row<T, VEC>(x + row * C + at.c0, at.c0, C, xv[u]);
          load_row<T, VEC>(dz + row * C + at.c0, at.c0, C, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!in[u]) continue;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          const A xa = widen(xv[u][i]);
          const A g = affine<T>(xa, av[i], bv[i]) > A(0) ? widen(gv[u][i]) : A(0);
          const A xhat = mul_rn(sub_rn(xa, mu[i]), iv[i]);
          s[i] += g;
          q[i] += g * xhat;
        }
      }
    }
  }
  block_partials(at, tx, C, s, q, part);
}

// z = relu(T(T(x*a) + b)).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
bnrelu_apply_kernel(const T* __restrict__ x, T* __restrict__ z, long long M, int C,
                    int rows_per_slab, int tx, const T* __restrict__ a,
                    const T* __restrict__ b) {
  using A = typename Acc<T>::type;
  constexpr int U = Unroll<T>::value;
  const Place at(M, C, rows_per_slab, tx);
  if (at.c0 >= C) return;
  A av[CPT], bv[CPT];
  load_channels_t(a, at.c0, C, av);
  load_channels_t(b, at.c0, C, bv);
  for (long long r = at.r0 + at.ly; r < at.r1; r += static_cast<long long>(at.ry) * U) {
    T v[U][CPT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = r + static_cast<long long>(u) * at.ry;
      if (row < at.r1) load_row<T, VEC>(x + row * C + at.c0, at.c0, C, v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = r + static_cast<long long>(u) * at.ry;
      if (row >= at.r1) continue;
      T out[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) narrow(max0(affine<T>(widen(v[u][i]), av[i], bv[i])), out[i]);
      store_row<T, VEC>(z + row * C + at.c0, at.c0, C, out);
    }
  }
}

// dx = T(g*((dzm - c1) - xhat*c2)).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
bnrelu_grad_apply_kernel(const T* __restrict__ x, const T* __restrict__ dz, T* __restrict__ dx,
                         long long M, int C, int rows_per_slab, int tx, const T* __restrict__ a,
                         const T* __restrict__ b, const typename Acc<T>::type* __restrict__ mean,
                         const typename Acc<T>::type* __restrict__ inv,
                         const typename Acc<T>::type* __restrict__ coef) {
  using A = typename Acc<T>::type;
  constexpr int U = Unroll<T>::value;
  const Place at(M, C, rows_per_slab, tx);
  if (at.c0 >= C) return;
  A av[CPT], bv[CPT], mu[CPT], iv[CPT], g[CPT], c1[CPT], c2[CPT];
  load_channels_t(a, at.c0, C, av);
  load_channels_t(b, at.c0, C, bv);
  load_channels(mean, at.c0, C, mu);
  load_channels(inv, at.c0, C, iv);
  load_channels(coef, at.c0, C, g);
  load_channels(coef + C, at.c0, C, c1);
  load_channels(coef + 2 * C, at.c0, C, c2);
  for (long long r = at.r0 + at.ly; r < at.r1; r += static_cast<long long>(at.ry) * U) {
    T xv[U][CPT], gv[U][CPT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = r + static_cast<long long>(u) * at.ry;
      if (row < at.r1) {
        load_row<T, VEC>(x + row * C + at.c0, at.c0, C, xv[u]);
        load_row<T, VEC>(dz + row * C + at.c0, at.c0, C, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = r + static_cast<long long>(u) * at.ry;
      if (row >= at.r1) continue;
      T out[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const A xa = widen(xv[u][i]);
        const A d = affine<T>(xa, av[i], bv[i]) > A(0) ? widen(gv[u][i]) : A(0);
        const A xhat = mul_rn(sub_rn(xa, mu[i]), iv[i]);
        narrow(mul_rn(g[i], sub_rn(sub_rn(d, c1[i]), mul_rn(xhat, c2[i]))), out[i]);
      }
      store_row<T, VEC>(dx + row * C + at.c0, at.c0, C, out);
    }
  }
}

// The sums of channel c's P partials (part[0][.][c], part[1][.][c]) in a
// fixed order: lane ly takes p = ly, ly + 8, ...; then a tree over the 8
// lanes. Every thread of the block must call it.
template <typename A>
__device__ __forceinline__ void sum_partials(const A* __restrict__ part, int P, int C, int c,
                                             A& t1, A& t2) {
  __shared__ A sh[2][FIN_LANES][FIN_CH];
  const int lx = threadIdx.x % FIN_CH, ly = threadIdx.x / FIN_CH;
  A u = A(0), v = A(0);
  if (c < C) {
    for (int p = ly; p < P; p += FIN_LANES) {
      u += part[static_cast<long long>(p) * C + c];
      v += part[static_cast<long long>(P + p) * C + c];
    }
  }
  sh[0][ly][lx] = u;
  sh[1][ly][lx] = v;
  __syncthreads();
  for (int half = FIN_LANES / 2; half > 0; half /= 2) {
    if (ly < half) {
      sh[0][ly][lx] += sh[0][ly + half][lx];
      sh[1][ly][lx] += sh[1][ly + half][lx];
    }
    __syncthreads();
  }
  t1 = sh[0][0][lx];
  t2 = sh[1][0][lx];
}

// Forward finalize. Stage 0: the partials, then the rest; 1: the partials
// into (mean, m2) alone; 2: the rest from the given (mean, m2).
template <typename T>
__global__ void __launch_bounds__(FIN_CH * FIN_LANES)
bnrelu_finalize_kernel(int stage, const typename Acc<T>::type* __restrict__ part, int P, int C,
                       long long M, typename Acc<T>::type* mean, typename Acc<T>::type* m2,
                       const typename Acc<T>::type* __restrict__ scale,
                       const typename Acc<T>::type* __restrict__ bias, double eps,
                       typename Acc<T>::type* __restrict__ var,
                       typename Acc<T>::type* __restrict__ inv, T* __restrict__ a,
                       T* __restrict__ b) {
  using A = typename Acc<T>::type;
  const int c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  const bool lead = threadIdx.x < FIN_CH && c < C;
  A mu = A(0), sq = A(0);
  if (stage != 2) {
    A s1, s2;
    sum_partials(part, P, C, c, s1, s2);
    mu = div_rn(s1, static_cast<A>(M));
    sq = div_rn(s2, static_cast<A>(M));
    if (lead) {
      mean[c] = mu;
      m2[c] = sq;
    }
  } else if (lead) {
    mu = mean[c];
    sq = m2[c];
  }
  if (stage == 1 || !lead) return;
  const A v = max0(sub_rn(sq, mul_rn(mu, mu)));
  const A iv = rsqrt_(add_rn(v, static_cast<A>(eps)));
  const A sc = scale[c];
  var[c] = v;
  inv[c] = iv;
  narrow(mul_rn(iv, sc), a[c]);
  narrow(sub_rn(bias[c], mul_rn(mul_rn(mu, iv), sc)), b[c]);
}

// Backward finalize. Stage 0: the partials into sums, then the coefficients;
// 1: the sums alone; 2: the coefficients from the given sums, divided by
// the group's count at n_total.
template <typename A>
__global__ void __launch_bounds__(FIN_CH * FIN_LANES)
bnrelu_grad_finalize_kernel(int stage, const A* __restrict__ part, int P, int C, long long M,
                            A* sums, const A* __restrict__ n_total, const A* __restrict__ scale,
                            const A* __restrict__ inv, A* __restrict__ coef) {
  const int c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  const bool lead = threadIdx.x < FIN_CH && c < C;
  A s1 = A(0), s2 = A(0);
  if (stage != 2) {
    sum_partials(part, P, C, c, s1, s2);
    if (lead) {
      sums[c] = s1;
      sums[C + c] = s2;
    }
  } else if (lead) {
    s1 = sums[c];
    s2 = sums[C + c];
  }
  if (stage == 1 || !lead) return;
  coef[c] = mul_rn(scale[c], inv[c]);
  if (n_total != nullptr) {
    const A n = *n_total;
    coef[C + c] = div_rn(s1, n);
    coef[2 * C + c] = div_rn(s2, n);
  } else {
    const A r = rcp_rn(static_cast<A>(M));
    coef[C + c] = mul_rn(s1, r);
    coef[2 * C + c] = mul_rn(s2, r);
  }
}

struct Grid {
  dim3 rows, fin;
  __host__ Grid(int slabs, int C, int tx)
      : rows(slabs, (C + CPT * tx - 1) / (CPT * tx)), fin((C + FIN_CH - 1) / FIN_CH) {}
};

template <typename T, bool VEC>
int forward(int stage, const void* x, void* z, long long M, int C, int slabs, int rows, int tx,
            const void* scale, const void* bias, double eps, void* part, void* mean, void* m2,
            void* var, void* inv, void* a, void* b, cudaStream_t s) {
  using A = typename Acc<T>::type;
  const Grid grid(slabs, C, tx);
  A* pa = static_cast<A*>(part);
  if (stage != 2) {
    bnrelu_stats_kernel<T, VEC><<<grid.rows, THREADS, 0, s>>>(static_cast<const T*>(x), M, C,
                                                              rows, tx, pa);
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  }
  bnrelu_finalize_kernel<T><<<grid.fin, FIN_CH * FIN_LANES, 0, s>>>(
      stage, pa, slabs, C, M, static_cast<A*>(mean), static_cast<A*>(m2),
      static_cast<const A*>(scale), static_cast<const A*>(bias), eps, static_cast<A*>(var),
      static_cast<A*>(inv), static_cast<T*>(a), static_cast<T*>(b));
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  if (stage != 1) {
    bnrelu_apply_kernel<T, VEC><<<grid.rows, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(z), M, C, rows, tx, static_cast<const T*>(a),
        static_cast<const T*>(b));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int backward(int stage, const void* x, const void* dz, void* dx, long long M, int C, int slabs,
             int rows, int tx, const void* a, const void* b, const void* mean, const void* inv,
             const void* scale, void* part, void* sums, const void* n_total, void* coef,
             cudaStream_t s) {
  using A = typename Acc<T>::type;
  const Grid grid(slabs, C, tx);
  A* pa = static_cast<A*>(part);
  if (stage != 2) {
    bnrelu_grad_stats_kernel<T, VEC><<<grid.rows, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dz), M, C, rows, tx,
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const A*>(mean),
        static_cast<const A*>(inv), pa);
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  }
  bnrelu_grad_finalize_kernel<A><<<grid.fin, FIN_CH * FIN_LANES, 0, s>>>(
      stage, pa, slabs, C, M, static_cast<A*>(sums), static_cast<const A*>(n_total),
      static_cast<const A*>(scale), static_cast<const A*>(inv), static_cast<A*>(coef));
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  if (stage != 1) {
    bnrelu_grad_apply_kernel<T, VEC><<<grid.rows, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dz), static_cast<T*>(dx), M, C, rows, tx,
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const A*>(mean),
        static_cast<const A*>(inv), static_cast<const A*>(coef));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward of one call on ``stream``; dtype 0 bf16, 1 f32, 2 f64; ``vec``:
// C % 8 == 0 and x, z 16-byte aligned (the library's BNR_DTYPE and BNR_VEC,
// else cudaErrorInvalidValue). x, z: [M, C]; scale, bias, mean, m2,
// var, inv: [C] in the statistics' type; a, b: [C] in x's type; part: [2,
// slabs, C] scratch. Stage 0: everything; 1: mean and m2 alone; 2: var, inv,
// a, b and z from the given mean and m2. Returns the cudaError_t of the
// launches (0 on success).
int bnr_forward(int stage, int dtype, int vec, const void* x, void* z, long long M, int C,
                int slabs, int rows_per_slab, int tx, const void* scale, const void* bias,
                double eps, void* part, void* mean, void* m2, void* var, void* inv, void* a,
                void* b, void* stream) {
  if (dtype != BNR_DTYPE || vec != BNR_VEC) return static_cast<int>(cudaErrorInvalidValue);
  return forward<Elem, VEC_LOADS>(stage, x, z, M, C, slabs, rows_per_slab, tx, scale, bias, eps,
                                  part, mean, m2, var, inv, a, b,
                                  static_cast<cudaStream_t>(stream));
}

// The backward of one call; x, dz, dx: [M, C]; a, b: [C] in x's type; mean,
// inv, scale: [C] in the statistics' type; sums: [2, C] (sum_dz,
// sum_dz_xhat); coef: [3, C] scratch; n_total: the group's count, one value
// in the statistics' type on the device, or null (the count is M). Stage 0:
// everything; 1: the sums alone; 2: dx from the given sums.
int bnr_backward(int stage, int dtype, int vec, const void* x, const void* dz, void* dx,
                 long long M, int C, int slabs, int rows_per_slab, int tx, const void* a,
                 const void* b, const void* mean, const void* inv, const void* scale, void* part,
                 void* sums, const void* n_total, void* coef, void* stream) {
  if (dtype != BNR_DTYPE || vec != BNR_VEC) return static_cast<int>(cudaErrorInvalidValue);
  return backward<Elem, VEC_LOADS>(stage, x, dz, dx, M, C, slabs, rows_per_slab, tx, a, b, mean,
                                   inv, scale, part, sums, n_total, coef,
                                   static_cast<cudaStream_t>(stream));
}

const char* bnr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
