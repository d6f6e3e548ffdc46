// Flash-attention forward for NVIDIA Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_flash_fwd_bhsd`
// (diffusers_tpu/ops/pallas/flash_attention_bwd.py:46,141; public entry
// `flash_attention_full`). Same function: out = softmax(scale * q k^T + mask,
// causal top-left aligned) v, online softmax in f32, optional per-row
// natural-log log-sum-exp (the LSE that K2/K3 read back).
//
// What bounds it on an H100: tensor-core operations. At the main paths'
// shapes (SDXL: head_dim 64 over 1,024 or 4,096 tokens; Flux: head_dim 128
// over 4,608) the two products (4 * Sq * Sk * D FLOP per head) reuse every
// q/k/v byte across a whole kv sweep, far above the card's ~295 FLOP/byte
// bf16 ridge; the softmax's exp2 (Sq * Sk per head, on the MUFU units) is the
// second cost.
//
// What the design does about it (FlashAttention-3's shape):
//  * A persistent grid, one block per SM, walks over work items (128-row q
//    tile, head, batch); a loop over kv tiles of 128 keys inside the block
//    replaces the sequential Pallas grid axis. A block has three
//    warpgroups: a producer that keeps only 24 registers (`setmaxnreg`) and
//    two consumers of 64 query rows each that take 240 (one block fills an
//    SM's registers, hence the persistent grid).
//  * The producer's one thread issues TMA loads: each item's q tile, then K
//    and V tiles into a ring of stages (3 at head_dim 64, 2 at 128: 112 and
//    160 KB of shared memory) signalled by `mbarrier`s, so copies overlap the
//    consumers' maths; the ring runs on across items, so the next item's
//    loads overlap this one's epilogue (what makes the 77-key cross
//    attentions, one kv tile an item, fast). The tensor maps are 4-D over
//    BSHD (D, S, H, B), encoded on the host for each call (they hold the
//    base pointers); rows past Sq or Sk arrive as zeros.
//  * S = q k^T is `wgmma` m64n128k16 with both operands K-major in shared
//    memory in 128-byte swizzle, the layout TMA writes.
//  * The softmax runs on the S accumulators in registers, in f32, in log2
//    units: scale * log2(e) is folded into the logits and p = exp2(x - m).
//  * O += P v is `wgmma` with A from registers: the S accumulators, rounded
//    to the input type in place, are the A fragments (no trip through shared
//    memory); V is the MN-major B operand (the transpose bit of 16-bit
//    wgmma). O, the running max and the running sum stay in registers; O/l
//    is written once, and the LSE as m * ln(2) + ln(l).
//  * Templated on (type, head_dim, mask, causal): the main paths' instances
//    carry no per-element mask test. Keys at or past Sk (the zero-filled
//    rows of the last kv tile, which would give logits of 0) get -inf only
//    on that tile, and causal skips the kv tiles past the block's last row.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int kBlockN = 128;       // keys per kv tile
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr float kNegInf = -1e30f;  // the JAX kernel's masked logit: finite, so no inf - inf
constexpr float kInf = __builtin_huge_valf();
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  CUtensorMap q_map, k_map, v_map;  // (D, S, H, B), box (64, 128, 1, 1), 128-byte swizzle
  const float* mask;                // additive f32 bias indexed through mask strides, or null
  void* out;
  float* lse;                       // [B, H, Sq] f32, or null
  int seq_q, seq_k, heads;
  int q_tiles, items;               // 128-row q tiles per head; (q tile, head, batch) work items
  long long o_sb, o_ss, o_sh;
  long long m_sb, m_sh, m_sq, m_sk;
  float scale;
};

// shared memory: the q tile, then the ring of (K, V) stages, then the
// mbarriers; every tile is a stack of D / 64 chunks of 128-byte rows
template <int D>
struct Layout {
  static constexpr int kChunks = D / 64;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  static constexpr int kBytes = kBarOffset + (2 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T, int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 2], const uint32_t* a, uint64_t desc_v) {
  if constexpr (D == 64) {
    wgmma_rs_m64n64k16_tb<T>(o, a, desc_v);
  } else {
    wgmma_rs_m64n128k16_tb<T>(o, a, desc_v);
  }
}

template <typename T, int D, bool kMask, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const __grid_constant__ Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kv = smem + L::kQBytes;  // stage s: K at kv + 2 s tile, V right after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + L::kStages;

  // work item -> (first query row, head, batch, kv tiles); consecutive items
  // are neighbouring q tiles of one head, which share its K and V in L2
  auto coords = [&](int item, int& q0, int& head, int& batch) {
    q0 = (item % p.q_tiles) * kBlockM;
    head = (item / p.q_tiles) % p.heads;
    batch = item / (p.q_tiles * p.heads);
    int n_tiles = (p.seq_k + kBlockN - 1) / kBlockN;
    if constexpr (kCausal) {  // keys past the tile's last row are masked for every row
      n_tiles = min(n_tiles, (min(q0 + kBlockM, p.seq_q) - 1) / kBlockN + 1);
    }
    return n_tiles;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerThreads);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;  // kv tiles loaded so far: the ring runs on across work items
      for (int item = blockIdx.x, n = 0; item < p.items; item += gridDim.x, ++n) {
        int q0, head, batch;
        const int n_tiles = coords(item, q0, head, batch);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);  // the last item's q tile is read
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(smem + c * kBlockM * 128, &p.q_map, q_full, 64 * c, q0, head, batch);
        }
        for (int tile = 0; tile < n_tiles; ++tile, ++it) {
          const int stage = it % L::kStages;
          if (it >= L::kStages) mbar_wait(&empty[stage], ((it / L::kStages) - 1) & 1);
          uint8_t* k_tile = kv + stage * 2 * L::kTileBytes;
          uint8_t* v_tile = k_tile + L::kTileBytes;
          mbar_expect_tx(&full[stage], 2 * L::kTileBytes);
#pragma unroll
          for (int c = 0; c < L::kChunks; ++c) {
            tma_load_4d(k_tile + c * kBlockN * 128, &p.k_map, &full[stage], 64 * c, tile * kBlockN, head, batch);
          }
#pragma unroll
          for (int c = 0; c < L::kChunks; ++c) {
            tma_load_4d(v_tile + c * kBlockN * 128, &p.v_map, &full[stage], 64 * c, tile * kBlockN, head, batch);
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of the q tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group, thread in group
    const float scale_log2 = p.scale * kLog2e;
    const uint32_t q_addr = smem_addr(smem) + cw * 64 * 128;
    int it = 0;  // kv tiles consumed so far
    for (int item = blockIdx.x, n = 0; item < p.items; item += gridDim.x, ++n) {
      int q0, head, batch;
      const int n_tiles = coords(item, q0, head, batch);
      const int row_a = q0 + cw * 64 + warp * 16 + g;  // this thread's two query rows
      const int row_b = row_a + 8;

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      // running max per row, log2 units. It starts at the JAX kernel's finite
      // masked logit, so a row whose first kv tiles an additive mask of -inf
      // (or finfo.min, which overflows to -inf in log2 units) hides entirely
      // takes corr = exp2(0) and p = 0 there, never exp2(-inf - -inf)
      float m_a = kNegInf * kLog2e, m_b = kNegInf * kLog2e;
      float l_a = 0.f, l_b = 0.f;      // running sum per row (this thread's columns)

      mbar_wait(q_full, n & 1);
      for (int tile = 0; tile < n_tiles; ++tile, ++it) {
        const int stage = it % L::kStages;
        mbar_wait(&full[stage], (it / L::kStages) & 1);
        const uint32_t k_addr = smem_addr(kv + stage * 2 * L::kTileBytes);
        const uint32_t v_addr = k_addr + L::kTileBytes;

        // S = q k^T: 16-deep k steps, 32 bytes apart inside a 128-byte chunk
        float s[kBlockN / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const uint32_t step = (k % 4) * 32;  // inside chunk k / 4
          wgmma_ss_m64n128k16<T>(s, smem_desc(q_addr + (k / 4) * kBlockM * 128 + step, 16, 1024),
                                 smem_desc(k_addr + (k / 4) * kBlockN * 128 + step, 16, 1024), k > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (tile == n_tiles - 1) mbar_arrive(q_empty);  // the producer may load the next q tile

        // logits in log2 units; s[4 j + e]: row (e < 2 ? a : b), key kv0 + 8 j + 2 t + (e & 1)
        const int kv0 = tile * kBlockN;
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          if constexpr (kMask || kCausal) {
            const int row = (i & 2) ? row_b : row_a;
            const int col = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
            float x = s[i] * p.scale;
            if constexpr (kMask) {
              if (row < p.seq_q && col < p.seq_k) {
                x += p.mask[batch * p.m_sb + head * p.m_sh + (long long)row * p.m_sq + (long long)col * p.m_sk];
              }
            }
            if constexpr (kCausal) {
              if (col > row) x = kNegInf;
            }
            s[i] = x * kLog2e;
          } else {
            s[i] *= scale_log2;
          }
        }
        if (kv0 + kBlockN > p.seq_k) {  // the last kv tile: its zero-filled keys take no weight
#pragma unroll
          for (int i = 0; i < kBlockN / 2; ++i) {
            if (kv0 + (i / 4) * 8 + 2 * t + (i & 1) >= p.seq_k) s[i] = -kInf;
          }
        }
        float mx_a = -kInf, mx_b = -kInf;
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          if (i & 2) mx_b = fmaxf(mx_b, s[i]); else mx_a = fmaxf(mx_a, s[i]);
        }
        // the four threads of a group share a row
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a);  // finite: m_a starts finite
        const float mn_b = fmaxf(m_b, mx_b);
        const float corr_a = ex2(m_a - mn_a);
        const float corr_b = ex2(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          if (i & 2) {
            s[i] = ex2(s[i] - mn_b);
            sum_b += s[i];
          } else {
            s[i] = ex2(s[i] - mn_a);
            sum_a += s[i];
          }
        }
        l_a = l_a * corr_a + sum_a;
        l_b = l_b * corr_b + sum_b;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;

        // P in the input type: n-tile i's (row a, row b) pairs; key chunk j's
        // A fragment is p[4 j .. 4 j + 3]
        uint32_t pf[kBlockN / 4];
#pragma unroll
        for (int i = 0; i < kBlockN / 8; ++i) {
          pf[2 * i] = pack<T>(s[4 * i], s[4 * i + 1]);
          pf[2 * i + 1] = pack<T>(s[4 * i + 2], s[4 * i + 3]);
        }

        // O += P v: 16 keys (two 1,024-byte row groups of V) per step
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBlockN / 16; ++j) {
          pv_wgmma<T, D>(o, &pf[4 * j], smem_desc(v_addr + j * 16 * 128, kBlockN * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&empty[stage]);
      }

      // finish the row sums across the group, normalize, store
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float inv_a = 1.f / l_a;
      const float inv_b = 1.f / l_b;
      T* o_base = static_cast<T*>(p.out) + batch * p.o_sb + head * p.o_sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (row_a < p.seq_q) {
          *reinterpret_cast<uint32_t*>(o_base + (long long)row_a * p.o_ss + col) =
              pack<T>(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        }
        if (row_b < p.seq_q) {
          *reinterpret_cast<uint32_t*>(o_base + (long long)row_b * p.o_ss + col) =
              pack<T>(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
        }
      }
      if (p.lse != nullptr && t == 0) {
        float* lse = p.lse + ((long long)batch * p.heads + head) * p.seq_q;
        if (row_a < p.seq_q) lse[row_a] = m_a * kLn2 + logf(l_a);
        if (row_b < p.seq_q) lse[row_b] = m_b * kLn2 + logf(l_b);
      }
    }
  }
}

template <typename T, int D, bool kMask, bool kCausal>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D, kMask, kCausal>;
  static uint64_t configured = 0;  // devices on which the shared-memory limit is raised
  cudaError_t err = raise_smem_limit(kernel, Layout<D>::kBytes, &configured);
  if (err != cudaSuccess) return err;
  kernel<<<min(p.items, sm_count()), kThreads, Layout<D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_variant(const Params& p, bool causal, cudaStream_t stream) {
  if (p.mask != nullptr) {
    return causal ? launch<T, D, true, true>(p, stream) : launch<T, D, true, false>(p, stream);
  }
  return causal ? launch<T, D, false, true>(p, stream) : launch<T, D, false, false>(p, stream);
}

template <typename T>
cudaError_t launch_dtype(const Params& p, int head_dim, bool causal, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_variant<T, 64>(p, causal, stream);
    case 128: return launch_variant<T, 128>(p, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

// (D, S, H, B) map of a BSHD operand with element strides (sb, ss, sh) and a
// unit head_dim stride; boxes of 64 x 128 rows
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dtype, int head_dim, int seq, int heads,
              int batch, long long sb, long long ss, long long sh) {
  const uint64_t dims[4] = {(uint64_t)head_dim, (uint64_t)seq, (uint64_t)heads, (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {64, kBlockN, 1, 1};
  return encode_tensor_map(map, dtype, 4, ptr, dims, strides, box);
}

}  // namespace

// C interface, bound with ctypes. dtype: 0 = bfloat16, 1 = float16. Strides are
// in elements; the head-dim stride of q/k/v/out is 1 and every other stride of
// q/k/v a non-zero multiple of 16 bytes (TMA). Returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue if a tensor map is
// refused); the caller raises on anything else.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
    int batch, int heads, int seq_q, int seq_k, int head_dim, int dtype,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long m_sb, long long m_sh, long long m_sq, long long m_sk,
    float scale, int causal, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType tdt = dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  Params p;
  if (!make_map(&p.q_map, q, tdt, head_dim, seq_q, heads, batch, q_sb, q_ss, q_sh) ||
      !make_map(&p.k_map, k, tdt, head_dim, seq_k, heads, batch, k_sb, k_ss, k_sh) ||
      !make_map(&p.v_map, v, tdt, head_dim, seq_k, heads, batch, v_sb, v_ss, v_sh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mask = mask; p.out = out; p.lse = lse;
  p.seq_q = seq_q; p.seq_k = seq_k; p.heads = heads;
  p.q_tiles = (seq_q + kBlockM - 1) / kBlockM;
  p.items = p.q_tiles * heads * batch;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.m_sb = m_sb; p.m_sh = m_sh; p.m_sq = m_sq; p.m_sk = m_sk;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_dtype<__nv_bfloat16>(p, head_dim, causal != 0, s)
                                     : launch_dtype<__half>(p, head_dim, causal != 0, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of a launch at `head_dim` (bytes), or -1.
extern "C" int flash_attention_fwd_smem_bytes(int head_dim) {
  return head_dim == 64 ? Layout<64>::kBytes : head_dim == 128 ? Layout<128>::kBytes : -1;
}
