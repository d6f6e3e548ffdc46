// w8a8 matmul for NVIDIA Hopper (sm_90a): kernel K5 of the port, and the
// per-row activation quantization that feeds it.
//
// Replaces the Pallas TPU kernel `_w8a8_kernel` / `_w8a8_matmul_2d`
// (diffusers_tpu/ops/pallas/quantized_matmul.py:38,85; public entry
// `w8a8_matmul`) and the XLA-side `quantize_rows` (:31) that runs before it.
// Same function:
//   qx[m,k], x_scale[m] = quantize_rows(x)        (f32 absmax per row,
//                          max(absmax, 1e-8) / 127, round half to even, clip +-127)
//   y[m,n] = out_t( f32(sum_k qx[m,k] * qw[n,k]) * x_scale[m] * w_scale[n] )
//   y[m,n] = out_t( f32(y[m,n]) + f32(bias[n]) )    (when a bias is given)
// The product order of the epilogue is JAX's; `__fmul_rn`/`__fadd_rn` keep
// nvcc from contracting it into an FMA, and the bias add rounds in the output
// type as `w8a8_matmul` adds it after the Pallas call. The int32 sums are
// exact (|sum| <= 127^2 * K < 2^31 for K <= 131,000), so the kernel equals its
// plain version bit for bit.
//
// What bounds it on an H100: at Flux's token counts (M = 512 to 4608) int8
// tensor-core operations (2*M*N*K at 1,979 TOPS dense); at M = 1 (the AdaLN
// and embedder linears) the int8 weight bytes (N*K at 3.35 TB/s). The
// quantization pass is bytes only (read x once, write qx once).
//
// What the design does about it:
//  * The weight stays in torch's [N, K] layout, which is exactly the `.col`
//    B operand of `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`: both
//    operands are K-major, so every A and B fragment is one 32-bit shared
//    memory load of four consecutive k.
//  * One block of 8 warps owns a 128 x 128 output tile; each warp a 64 x 32
//    sub-tile (4 x 4 mma tiles, 64 int32 accumulators a thread). A loop over
//    K in 64-byte tiles replaces the sequential Pallas grid axis; A and B
//    tiles stream through two shared-memory stages with 16-byte `cp.async`,
//    so the next tile's copy overlaps the current tile's mma. Smem rows are
//    padded to 80 bytes, which makes the fragment loads conflict-free.
//  * The int32 accumulators never leave registers: the f32 epilogue (scales,
//    cast, bias) runs in the kernel and writes the output once.
//  * Ragged M is masked in the kernel (zero-filled A rows, no stores), so the
//    M = 1 linears run without JAX's pad to 32 rows.
//  * Quantization is one block per row: the row is read twice (absmax, then
//    quantize and store int8), the second time from L1/L2.
// `ldmatrix`, a deeper copy pipeline (TMA) and `wgmma` are later PRs' work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;
constexpr int kBlockN = 128;
constexpr int kBlockK = 64;            // bytes of K per smem tile
constexpr int kLds = kBlockK + 16;     // padded smem row (bytes): conflict-free fragment loads
constexpr int kThreads = 256;          // 8 warps: 2 along M x 4 along N
constexpr int kQuantThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// ---------------------------------------------------------------- quantize

template <typename T>
__global__ void __launch_bounds__(kQuantThreads) quantize_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ qx, float* __restrict__ x_scale, int K) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const T* xr = x + static_cast<size_t>(blockIdx.x) * K;
  int8_t* qr = qx + static_cast<size_t>(blockIdx.x) * K;

  float amax = 0.f;
  for (int i = threadIdx.x * kVec; i < K; i += kQuantThreads * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) amax = fmaxf(amax, fabsf(to_float(v[j])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  __shared__ float warp_max[kQuantThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float scale = fmaxf(amax, 1e-8f) / 127.0f;  // IEEE division (no fast math)
  if (threadIdx.x == 0) x_scale[blockIdx.x] = scale;

  for (int i = threadIdx.x * kVec; i < K; i += kQuantThreads * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
    const T* v = reinterpret_cast<const T*>(&raw);
    uint32_t packed[kVec / 4] = {};
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float r = rintf(to_float(v[j]) / scale);  // round half to even, as torch.round / jnp.round
      const int q = static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
      packed[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(q)) << (8 * (j & 3));
    }
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint2*>(qr + i) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<uint32_t*>(qr + i) = packed[0];
    }
  }
}

// -------------------------------------------------------------------- gemm

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ uint32_t lds32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ void store_pair(T* out, float v0, float v1, const T* bias, int col) {
  T y0 = from_float<T>(v0), y1 = from_float<T>(v1);
  if (bias != nullptr) {
    y0 = from_float<T>(__fadd_rn(to_float(y0), to_float(bias[col])));
    y1 = from_float<T>(__fadd_rn(to_float(y1), to_float(bias[col + 1])));
  }
  out[0] = y0;
  out[1] = y1;
}

// qx [M, K] and qw [N, K] row-major int8; K % 64 == 0 and N % 128 == 0 (the
// wrapper's rule takes K, N % 128 == 0); out [M, N] row-major.
template <typename T>
__global__ void __launch_bounds__(kThreads) w8a8_gemm_kernel(
    const int8_t* __restrict__ qx, const int8_t* __restrict__ qw, const float* __restrict__ x_scale,
    const float* __restrict__ w_scale, const T* __restrict__ bias, T* __restrict__ out,
    int M, int N, int K, int skip_k_tile) {
  __shared__ __align__(16) int8_t smem_a[2][kBlockM * kLds];
  __shared__ __align__(16) int8_t smem_b[2][kBlockN * kLds];

  const int m0 = blockIdx.y * kBlockM;
  const int n0 = blockIdx.x * kBlockN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp sub-tile: rows wm*64.., cols wn*32..
  const int g = lane >> 2, t = lane & 3;    // mma fragment group / thread-in-group

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * kBlockK;
    // 128 rows x 64 bytes = 512 chunks of 16 bytes per operand; 2 per thread
#pragma unroll
    for (int c = tid; c < kBlockM * kBlockK / 16; c += kThreads) {
      const int r = c >> 2, col = (c & 3) * 16;
      const int gm = m0 + r;
      const int8_t* src_a = qx + static_cast<size_t>(gm < M ? gm : M - 1) * K + k0 + col;
      cp_async16(&smem_a[stage][r * kLds + col], src_a, gm < M ? 16 : 0);  // rows past M read as zeros
      const int8_t* src_b = qw + static_cast<size_t>(n0 + r) * K + k0 + col;
      cp_async16(&smem_b[stage][r * kLds + col], src_b, 16);
    }
  };

  const int k_tiles = K / kBlockK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < k_tiles) load_tile(kt + 1, stage ^ 1);
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = tile kt
    cp_async_wait_one();
    __syncthreads();
    if (kt != skip_k_tile) {  // skip_k_tile >= 0 only in the control run of chip_smoke.py
      const int8_t* a = smem_a[stage];
      const int8_t* b = smem_b[stage];
#pragma unroll
      for (int kk = 0; kk < kBlockK; kk += 32) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int8_t* p = a + (wm * 64 + i * 16 + g) * kLds + kk + t * 4;
          af[i][0] = lds32(p);
          af[i][1] = lds32(p + 8 * kLds);
          af[i][2] = lds32(p + 16);
          af[i][3] = lds32(p + 8 * kLds + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* p = b + (wn * 32 + j * 8 + g) * kLds + kk + t * 4;
          bf[j][0] = lds32(p);
          bf[j][1] = lds32(p + 16);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
      }
    }
    __syncthreads();
  }

  // epilogue: f32(acc) * x_scale[m] * w_scale[n], cast, + bias
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + i * 16 + g + h * 8;
      if (row >= M) continue;
      const float sx = x_scale[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + t * 2;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), sx), w_scale[col]);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), sx), w_scale[col + 1]);
        store_pair<T>(out + static_cast<size_t>(row) * N + col, v0, v1, bias, col);
      }
    }
  }
}

template <typename T>
cudaError_t launch_gemm(const void* qx, const void* qw, const float* xs, const float* ws, const void* bias,
                        void* out, int M, int N, int K, int skip_k_tile, cudaStream_t stream) {
  const dim3 grid(N / kBlockN, (M + kBlockM - 1) / kBlockM);
  w8a8_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qx), static_cast<const int8_t*>(qw), xs, ws, static_cast<const T*>(bias),
      static_cast<T*>(out), M, N, K, skip_k_tile);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* qx, float* xs, int M, int K, cudaStream_t stream) {
  quantize_rows_kernel<T><<<M, kQuantThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(qx), xs, K);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. dtype: 0 = bfloat16, 1 = float16, 2 = float32
// (of x, and of the output and bias). Every pointer is 16-byte aligned and
// every matrix row-major and contiguous. Each returns the launch's
// cudaError_t (0 on success); the caller raises on anything else.

// x [M, K] -> qx [M, K] int8, x_scale [M] f32. K % 128 == 0.
extern "C" int w8a8_quantize_rows(const void* x, void* qx, float* x_scale, int M, int K, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || K % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_quantize<__nv_bfloat16>(x, qx, x_scale, M, K, s));
    case 1: return static_cast<int>(launch_quantize<__half>(x, qx, x_scale, M, K, s));
    case 2: return static_cast<int>(launch_quantize<float>(x, qx, x_scale, M, K, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// qx [M, K] int8, qw [N, K] int8, x_scale [M] f32, w_scale [N] f32, bias [N] or
// null -> out [M, N]. K % 128 == 0, N % 128 == 0. skip_k_tile: -1, or the index
// of one 64-wide K tile to leave out (a deliberately wrong result, for controls).
extern "C" int w8a8_matmul(const void* qx, const void* qw, const float* x_scale, const float* w_scale,
                           const void* bias, void* out, int M, int N, int K, int dtype, int skip_k_tile,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 128 != 0 || N % 128 != 0 || (M + kBlockM - 1) / kBlockM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_gemm<__nv_bfloat16>(qx, qw, x_scale, w_scale, bias, out, M, N, K, skip_k_tile, s));
    case 1: return static_cast<int>(launch_gemm<__half>(qx, qw, x_scale, w_scale, bias, out, M, N, K, skip_k_tile, s));
    case 2: return static_cast<int>(launch_gemm<float>(qx, qw, x_scale, w_scale, bias, out, M, N, K, skip_k_tile, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
