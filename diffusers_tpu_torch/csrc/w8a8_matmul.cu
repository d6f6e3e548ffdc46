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
// What the design does about the GEMM:
//  * Both operands are K-major, the only layout int8 `wgmma` takes: qx is
//    [M, K] and the weight stays in torch's [N, K].
//  * A persistent grid (one block per SM) walks over the 128 x BN output
//    tiles: warpgroup 0 is the producer, whose one thread issues TMA loads
//    of 128-byte-deep K tiles of qx and qw (128-byte swizzle) into a ring of
//    4 stages signalled by `mbarrier`s, running on into the next output tile
//    while the consumers finish this one's epilogue; two consumer warpgroups
//    (64 rows each, 232 registers each by `setmaxnreg`) run `wgmma`
//    m64nBNk32 s8 -> s32 on the tiles that have arrived, with one group of
//    wgmmas in flight while the next stage is waited for. A loop over K
//    replaces the sequential Pallas grid axis.
//  * BN comes from (M, N) (`pick_tile` in ops/cuda/w8a8_matmul.py): 256 or
//    128, whichever leaves the least work on the busiest SM; M <= 64 takes
//    128, which puts the most SMs on streaming the weight.
//  * Rows past M arrive as zeros from TMA and are not stored, so M = 1 (the
//    AdaLN and embedder linears, bound by the weight's bytes) runs through the
//    same kernel without JAX's pad to 32 rows.
//  * The int32 accumulators never leave registers: the f32 epilogue (scales,
//    cast, bias) runs in the kernel and writes the output once.
//
// The row quantization is one block per row: the row is read twice (absmax,
// then quantize and store int8), the second time from L1/L2.

#include "hopper.cuh"

namespace {

using namespace hopper;

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

constexpr int kBlockM = 128;  // rows of an output tile: two consumer warpgroups of 64
constexpr int kBlockK = 128;  // bytes of K per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kGemmThreads = 384;  // producer warpgroup + two consumer warpgroups

struct GemmParams {
  CUtensorMap a_map;  // qx [M, K]: (K, M), box (128, 128)
  CUtensorMap b_map;  // qw [N, K]: (K, N), box (128, BN)
  const float* x_scale;
  const float* w_scale;
  const void* bias;
  void* out;
  int M, N, K, skip_k_tile;
  int tiles_m, tiles;  // output tiles along M, and in all
};

template <int BN>
struct GemmLayout {
  static constexpr int kABytes = kBlockM * kBlockK;
  static constexpr int kStageBytes = (kBlockM + BN) * kBlockK;
  static constexpr int kBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + alignment slack
};

template <int BN>
__device__ __forceinline__ void mma_k32(int (&acc)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 128) {
    wgmma_ss_m64n128k32_s8(acc, desc_a, desc_b);
  } else {
    wgmma_ss_m64n256k32_s8(acc, desc_a, desc_b);
  }
}

// A persistent grid walks over the 128 x BN output tiles, M fastest
// (neighbouring blocks share a weight slice in L2): warpgroup 0 is the
// producer (one thread issues the TMA loads; its ring of stages runs on
// across tiles, so the next tile's loads overlap this one's epilogue),
// warpgroups 1 and 2 the consumers, 64 rows each. qx [M, K] and qw [N, K]
// row-major int8, K % 128 == 0, N % BN == 0; out [M, N] row-major.
template <typename T, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1) w8a8_gemm_kernel(const __grid_constant__ GemmParams p) {
  using L = GemmLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;
  const int k_tiles = p.K / kBlockK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGemmThreads - 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // k tiles loaded so far
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile % p.tiles_m) * kBlockM;
        const int n0 = (tile / p.tiles_m) * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int stage = it % kStages;
          if (it >= kStages) mbar_wait(&empty[stage], ((it / kStages) - 1) & 1);
          uint8_t* a_tile = smem + stage * L::kStageBytes;
          mbar_expect_tx(&full[stage], L::kStageBytes);
          tma_load_2d(a_tile, &p.a_map, &full[stage], kt * kBlockK, m0);
          tma_load_2d(a_tile + L::kABytes, &p.b_map, &full[stage], kt * kBlockK, n0);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1;  // rows 64 c .. 64 c + 63 of the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    T* out = static_cast<T*>(p.out);
    const T* bias = static_cast<const T*>(p.bias);
    int it = 0;  // k tiles consumed so far
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile % p.tiles_m) * kBlockM;
      const int n0 = (tile / p.tiles_m) * BN;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int stage = it % kStages;
        mbar_wait(&full[stage], (it / kStages) & 1);
        const uint32_t a_addr = smem_addr(smem + stage * L::kStageBytes) + c * 64 * kBlockK;
        const uint32_t b_addr = smem_addr(smem + stage * L::kStageBytes + L::kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 32; ++kk) {  // 32-byte k steps inside the swizzle row
          if (2 * kt + kk / 2 != p.skip_k_tile) {     // >= 0 only in the control run of chip_smoke.py
            mma_k32<BN>(acc, smem_desc(a_addr + 32 * kk, 16, 1024), smem_desc(b_addr + 32 * kk, 16, 1024));
          }
        }
        wgmma_commit();
        // one group in flight: the previous k tile's wgmmas are done, so its stage is free
        wgmma_wait<1>();
        if (kt > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % kStages]);

      // epilogue: f32(acc) * x_scale[m] * w_scale[n], cast, + bias.
      // acc[4 j + 2 h + e]: row 16 warp + g + 8 h, column 8 j + 2 t + e. The
      // scales and bias of 8 column groups are loaded before any of their
      // stores, so their latencies overlap.
      const int row0 = m0 + c * 64 + warp * 16 + g;
      const float sx0 = row0 < p.M ? p.x_scale[row0] : 0.f;
      const float sx1 = row0 + 8 < p.M ? p.x_scale[row0 + 8] : 0.f;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 8) {
        float ws[16], bs[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + 8 * (j0 + j) + 2 * t;
          ws[2 * j] = p.w_scale[col];
          ws[2 * j + 1] = p.w_scale[col + 1];
          bs[2 * j] = bias != nullptr ? to_float(bias[col]) : 0.f;
          bs[2 * j + 1] = bias != nullptr ? to_float(bias[col + 1]) : 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= p.M) continue;
          const float sx = h ? sx1 : sx0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = n0 + 8 * (j0 + j) + 2 * t;
            const int a = 4 * (j0 + j) + 2 * h;
            T y0 = from_float<T>(__fmul_rn(__fmul_rn(__int2float_rn(acc[a]), sx), ws[2 * j]));
            T y1 = from_float<T>(__fmul_rn(__fmul_rn(__int2float_rn(acc[a + 1]), sx), ws[2 * j + 1]));
            if (bias != nullptr) {  // the bias is added in the output type, after the cast
              y0 = from_float<T>(__fadd_rn(to_float(y0), bs[2 * j]));
              y1 = from_float<T>(__fadd_rn(to_float(y1), bs[2 * j + 1]));
            }
            T* dst = out + static_cast<size_t>(row) * p.N + col;
            dst[0] = y0;
            dst[1] = y1;
          }
        }
      }
    }
  }
}

template <typename T, int BN>
cudaError_t launch_gemm(const GemmParams& p, cudaStream_t stream) {
  auto kernel = w8a8_gemm_kernel<T, BN>;
  static uint64_t configured = 0;  // devices on which the shared-memory limit is raised
  cudaError_t err = raise_smem_limit(kernel, GemmLayout<BN>::kBytes, &configured);
  if (err != cudaSuccess) return err;
  kernel<<<min(p.tiles, sm_count()), kGemmThreads, GemmLayout<BN>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// the tile widths `pick_tile` (ops/cuda/w8a8_matmul.py) chooses from
template <typename T>
cudaError_t launch_tile(const GemmParams& p, int block_n, cudaStream_t stream) {
  if (block_n == 256) return launch_gemm<T, 256>(p, stream);
  if (block_n == 128) return launch_gemm<T, 128>(p, stream);
  return cudaErrorInvalidValue;
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
// null -> out [M, N]. K % 128 == 0, N % block_n == 0; output tiles of 128 x
// block_n, block_n 256 or 128. skip_k_tile: -1, or the index of one 64-wide K
// slice to leave out (a deliberately wrong result, for controls).
extern "C" int w8a8_matmul(const void* qx, const void* qw, const float* x_scale, const float* w_scale,
                           const void* bias, void* out, int M, int N, int K, int dtype, int block_n,
                           int skip_k_tile, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBlockK != 0 || block_n <= 0 || N % block_n != 0 ||
      (long long)((M + kBlockM - 1) / kBlockM) * (N / block_n) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GemmParams p;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M}, b_dims[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t stride[1] = {(uint64_t)K};
  const uint32_t a_box[2] = {kBlockK, kBlockM}, b_box[2] = {kBlockK, (uint32_t)block_n};
  if (!encode_tensor_map(&p.a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qx, a_dims, stride, a_box) ||
      !encode_tensor_map(&p.b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qw, b_dims, stride, b_box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x_scale = x_scale; p.w_scale = w_scale; p.bias = bias; p.out = out;
  p.M = M; p.N = N; p.K = K; p.skip_k_tile = skip_k_tile;
  p.tiles_m = (M + kBlockM - 1) / kBlockM;
  p.tiles = p.tiles_m * (N / block_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_tile<__nv_bfloat16>(p, block_n, s));
    case 1: return static_cast<int>(launch_tile<__half>(p, block_n, s));
    case 2: return static_cast<int>(launch_tile<float>(p, block_n, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of a launch with tiles of 128 x block_n (bytes), or -1.
extern "C" int w8a8_matmul_smem_bytes(int block_n) {
  if (block_n == 256) return GemmLayout<256>::kBytes;
  if (block_n == 128) return GemmLayout<128>::kBytes;
  return -1;
}
