// Flash-attention backward for NVIDIA Hopper (sm_90a): kernels K2 (dK, dV)
// and K3 (dQ) of the port.
//
// Replaces the Pallas TPU kernels `_bwd_dkdv_kernel` and `_bwd_dq_kernel`
// (diffusers_tpu/ops/pallas/flash_attention_bwd.py:163,203; both launched by
// `_flash_bwd_bhsd` at :257 and :285, the backward half of the custom VJP
// `flash_attention_vjp`). Same function, the FlashAttention-2 backward:
//
//   p  = exp(scale * q k^T + mask - lse)        (causal: top-left, row >= col)
//   dv = p^T dO,   dp = dO v^T,   ds = p * (dp - delta) * scale
//   dk = ds^T q,   dq = ds k,     delta = rowsum(dO * O) (computed by the caller)
//
// What bounds it on an H100: tensor-core operations. K2 does four products
// per (query, key) pair (k q^T, P^T dO, v dO^T, dS^T q: 8 * Sq * Sk * D FLOP
// per head), K3 three (q k^T, dO v^T, dS k: 6 * Sq * Sk * D); at the main
// paths' self attention (SDXL: head_dim 64 over 1,024 or 4,096 tokens; Flux:
// head_dim 128 over 4,608) every q/k/v/dO byte is reused across a whole
// sweep, far above the card's ~295 FLOP/byte bf16 ridge. The exp of P (Sq *
// Sk per head, recomputed in both kernels) is the second cost. SDXL's
// 77-token cross attention has one kv tile per head: too few work items to
// fill the card unless the query sweep is split.
//
// What the design does about it (K1's skeleton, csrc/flash_attention_fwd.cu):
//  * Two kernels, no atomics, as in the JAX package. Each is a persistent
//    grid of min(items, SMs) blocks of three warpgroups: a producer that
//    keeps 24 registers (`setmaxnreg`; K2's 32) and two consumers of 64
//    rows each that take 240 (K2's 232). The producer's one thread issues
//    TMA loads from 4-D tensor maps over BSHD (D, S, H, B), encoded once per
//    call for both kernels; rows past Sq or Sk arrive as zeros. Its ring of
//    shared-memory stages, signalled by `mbarrier`s, runs on across work
//    items.
//  * K3 (dQ): work items (128-row q tile, head, batch). The producer loads
//    the item's q and dO tiles, then streams 128-key K and V tiles through
//    the ring. Each consumer computes S = q k^T and dP = dO v^T (`wgmma`
//    m64n128k16, both operands K-major in shared memory), P = exp2(S scale
//    log2(e) - lse log2(e)) and dS = P (dP - delta) scale in f32 registers,
//    rounds dS in place to the A fragments and accumulates dQ += dS k with A
//    from registers and k as the MN-major B operand (K1's O += P v). dQ is
//    written once.
//  * K2 (dK, dV): work items (128-key kv tile, head, batch, query split).
//    The producer loads the item's K and V tiles once, then streams q and dO
//    tiles of kBlockQ queries (128 at head_dim 64, 64 at 128) through the
//    ring; one warp of it copies their LSE (times log2(e)) and delta beside
//    them. Each consumer owns 64 keys: S^T = k q^T and dP^T = v dO^T are
//    K-major x K-major products, P^T and dS^T stay in registers and become
//    the A fragments of dV += P^T dO and dK += dS^T q, with dO and q as
//    MN-major B operands. Registers at head_dim 128: dK 64 + dV 64 + S^T 32
//    + dP^T 32, which is why its q step is 64.
//  * The split query sweep (K2): where kv tiles x heads x batch would leave
//    SMs idle (the 77-key cross attention: 10 or 20 items on 132 SMs), the
//    wrapper's `pick_split` cuts each item's sweep into `splits` ranges of
//    128-query blocks. Each range writes its f32 partial dK and dV to a
//    workspace; a second small kernel of this file sums the partials in
//    split order and rounds once to the output type, so the grads are
//    bit-identical from run to run.
//  * Templated on (type, head_dim, mask, causal): the main paths' instances
//    carry no per-element test. Zero-filled keys past Sk get P = 0 only on
//    K3's last, ragged kv tile (in K2 they are rows of P^T that feed only
//    their own rows of dK and dV, which are not stored); zero-filled queries
//    past Sq (q = dO = 0, lse = delta = 0) contribute nothing. Causal: K2 starts at the first q block
//    that reaches the item's keys, K3 stops at the last kv tile its rows
//    reach. The masked instances read the f32 mask through its four strides.
//    They subtract the LSE in natural-log units before the conversion to
//    log2 units, p = exp2((s scale + mask - lse) log2(e)), as the plain
//    version's exp(s - lse): a row that an additive finfo.min hides entirely
//    has lse = -inf and finite logits, so its p is +inf there as in the
//    plain version and JAX's kernels (in log2 units the logit would overflow
//    to -inf first and give -inf - -inf = NaN).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;  // K3: query rows per work item, two consumer warpgroups of 64
constexpr int kBlockN = 128;  // keys per kv tile: K3's ring tiles, K2's work items
constexpr int kBox = 64;      // rows per TMA box
constexpr int kSplitBlock = 128;  // K2's query splits are ranges of 128-query blocks
constexpr int kThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr float kNegInf = -1e30f;  // the JAX kernel's masked logit
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap q_map, k_map, v_map, do_map;  // (D, S, H, B), box (64, 64, 1, 1), 128-byte swizzle
  const float* mask;                        // additive f32 bias indexed through mask strides, or null
  const float* lse;                         // [B, H, Sq] f32, natural log
  const float* delta;                       // [B, H, Sq] f32 through d_sb, d_sh, d_sq: rowsum(dO * O)
  void* dq;                                 // contiguous BSHD outputs
  void* dk;
  void* dv;
  float* ws;                                // K2's split partials [2, splits, B, Sk, H, D] f32, or null
  int batch, heads, seq_q, seq_k;
  int splits;                               // K2's query splits (1: no workspace)
  long long d_sb, d_sh, d_sq;
  long long m_sb, m_sh, m_sq, m_sk;
  float scale;
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

// D[64 x N] (+)= A[64 x 16] . B[16 x N], both K-major in shared memory
template <typename T, int N>
__device__ __forceinline__ void ss_wgmma(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_m64n64k16<T>(d, desc_a, desc_b, accumulate);
  } else {
    wgmma_ss_m64n128k16<T>(d, desc_a, desc_b, accumulate);
  }
}

// D[64 x N] += A[64 x 16] (registers) . B[16 x N] (MN-major in shared memory)
template <typename T, int N>
__device__ __forceinline__ void rs_wgmma(float (&d)[N / 2], const uint32_t* a, uint64_t desc_b) {
  if constexpr (N == 64) {
    wgmma_rs_m64n64k16_tb<T>(d, a, desc_b);
  } else {
    wgmma_rs_m64n128k16_tb<T>(d, a, desc_b);
  }
}

// the f32 accumulators of a 64 x N product, rounded to T, as the A fragments
// of its 16-column k chunks: chunk j's fragment is f[4 j .. 4 j + 3]
template <typename T, int N>
__device__ __forceinline__ void to_frags(uint32_t (&f)[N / 4], const float (&s)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    f[2 * i] = pack<T>(s[4 * i], s[4 * i + 1]);
    f[2 * i + 1] = pack<T>(s[4 * i + 2], s[4 * i + 3]);
  }
}

// TMA loads of `rows` rows (a multiple of 64) from row `row0` of a BSHD
// operand into a tile of D / 64 chunks of 128-byte rows
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* tile, const CUtensorMap* map, uint64_t* bar, int rows, int row0,
                                          int head, int batch) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    for (int r = 0; r < rows; r += kBox) {
      tma_load_4d(tile + (c * rows + r) * 128, map, bar, 64 * c, row0 + r, head, batch);
    }
  }
}

// ------------------------------------------------------------------ K3 (dQ)

// shared memory: the q and dO tiles, then the ring of (K, V) stages, then the
// mbarriers; every tile is a stack of D / 64 chunks of 128-byte rows
template <int D>
struct DqLayout {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kBlockM * D * 2;     // one q or dO tile
  static constexpr int kTileBytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int kRing = 2 * kQBytes;
  static constexpr int kBarOffset = kRing + kStages * 2 * kTileBytes;
  static constexpr int kBytes = kBarOffset + (2 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

template <typename T, int D, bool kMask, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem + L::kRing;  // stage s: K at ring + 2 s tile, V right after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + L::kStages;

  const int q_tiles = (p.seq_q + kBlockM - 1) / kBlockM;
  const int items = q_tiles * p.heads * p.batch;
  // work item -> (first query row, head, batch, kv tiles); consecutive items
  // are neighbouring q tiles of one head, which share its K and V in L2
  auto coords = [&](int item, int& q0, int& head, int& batch) {
    q0 = (item % q_tiles) * kBlockM;
    head = (item / q_tiles) % p.heads;
    batch = item / (q_tiles * p.heads);
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
      for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
        int q0, head, batch;
        const int n_tiles = coords(item, q0, head, batch);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);  // the last item's q and dO tiles are read
        mbar_expect_tx(q_full, 2 * L::kQBytes);
        load_rows<D>(smem, &p.q_map, q_full, kBlockM, q0, head, batch);
        load_rows<D>(smem + L::kQBytes, &p.do_map, q_full, kBlockM, q0, head, batch);
        for (int tile = 0; tile < n_tiles; ++tile, ++it) {
          const int stage = it % L::kStages;
          if (it >= L::kStages) mbar_wait(&empty[stage], ((it / L::kStages) - 1) & 1);
          uint8_t* k_tile = ring + stage * 2 * L::kTileBytes;
          mbar_expect_tx(&full[stage], 2 * L::kTileBytes);
          load_rows<D>(k_tile, &p.k_map, &full[stage], kBlockN, tile * kBlockN, head, batch);
          load_rows<D>(k_tile + L::kTileBytes, &p.v_map, &full[stage], kBlockN, tile * kBlockN, head, batch);
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
    const uint32_t do_addr = q_addr + L::kQBytes;
    int it = 0;  // kv tiles consumed so far
    for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
      int q0, head, batch;
      const int n_tiles = coords(item, q0, head, batch);
      const int row_a = q0 + cw * 64 + warp * 16 + g;  // this thread's two query rows
      const int row_b = row_a + 8;
      const long long bh = (long long)batch * p.heads + head;
      // zero-filled rows past Sq: lse = delta = 0 keeps their (unstored) dQ finite
      // (natural log in the masked instances, else times log2(e))
      constexpr float kLseUnit = kMask ? 1.f : kLog2e;
      const float lse_a = row_a < p.seq_q ? p.lse[bh * p.seq_q + row_a] * kLseUnit : 0.f;
      const float lse_b = row_b < p.seq_q ? p.lse[bh * p.seq_q + row_b] * kLseUnit : 0.f;
      const float* delta = p.delta + batch * p.d_sb + head * p.d_sh;
      const float delta_a = row_a < p.seq_q ? delta[row_a * p.d_sq] : 0.f;
      const float delta_b = row_b < p.seq_q ? delta[row_b * p.d_sq] : 0.f;

      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

      mbar_wait(q_full, n & 1);
      for (int tile = 0; tile < n_tiles; ++tile, ++it) {
        const int stage = it % L::kStages;
        mbar_wait(&full[stage], (it / L::kStages) & 1);
        const uint32_t k_addr = smem_addr(ring + stage * 2 * L::kTileBytes);
        const uint32_t v_addr = k_addr + L::kTileBytes;

        // S = q k^T and dP = dO v^T: 16-deep k steps, 32 bytes apart inside a 128-byte chunk
        float s[kBlockN / 2], dp[kBlockN / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const uint32_t step = (k / 4) * kBlockM * 128 + (k % 4) * 32;
          const uint32_t kstep = (k / 4) * kBlockN * 128 + (k % 4) * 32;
          wgmma_ss_m64n128k16<T>(s, smem_desc(q_addr + step, 16, 1024), smem_desc(k_addr + kstep, 16, 1024), k > 0);
        }
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const uint32_t step = (k / 4) * kBlockM * 128 + (k % 4) * 32;
          const uint32_t kstep = (k / 4) * kBlockN * 128 + (k % 4) * 32;
          wgmma_ss_m64n128k16<T>(dp, smem_desc(do_addr + step, 16, 1024), smem_desc(v_addr + kstep, 16, 1024),
                                 k > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (tile == n_tiles - 1) mbar_arrive(q_empty);  // the producer may load the next q and dO tiles

        // P and dS = P (dP - delta) scale in place of S; s[4 j + e]: row (e < 2 ? a : b),
        // key kv0 + 8 j + 2 t + (e & 1)
        const int kv0 = tile * kBlockN;
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const float lse_r = (i & 2) ? lse_b : lse_a;
          float x;
          if constexpr (kMask || kCausal) {
            const int row = (i & 2) ? row_b : row_a;
            const int col = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
            x = s[i] * p.scale;
            if constexpr (kMask) {
              if (row < p.seq_q && col < p.seq_k) {
                x += p.mask[batch * p.m_sb + head * p.m_sh + (long long)row * p.m_sq + (long long)col * p.m_sk];
              }
            }
            if constexpr (kCausal) {
              if (col > row) x = kNegInf;
            }
            x = kMask ? (x - lse_r) * kLog2e : x * kLog2e - lse_r;
          } else {
            x = fmaf(s[i], scale_log2, -lse_r);
          }
          s[i] = ex2(x);
        }
        if (kv0 + kBlockN > p.seq_k) {  // the last kv tile: its zero-filled keys take no weight
#pragma unroll
          for (int i = 0; i < kBlockN / 2; ++i) {
            if (kv0 + (i / 4) * 8 + 2 * t + (i & 1) >= p.seq_k) s[i] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) s[i] = s[i] * (dp[i] - ((i & 2) ? delta_b : delta_a)) * p.scale;
        uint32_t dsf[kBlockN / 4];
        to_frags<T, kBlockN>(dsf, s);

        // dQ += dS k: 16 keys (two 1,024-byte row groups of K) per step, K MN-major
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBlockN / 16; ++j) {
          rs_wgmma<T, D>(dq, &dsf[4 * j], smem_desc(k_addr + j * 16 * 128, kBlockN * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        mbar_arrive(&empty[stage]);
      }

      T* dq_base = static_cast<T*>(p.dq) + ((long long)batch * p.seq_q * p.heads + head) * D;
      const long long row_stride = (long long)p.heads * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (row_a < p.seq_q) {
          *reinterpret_cast<uint32_t*>(dq_base + row_a * row_stride + col) = pack<T>(dq[4 * j], dq[4 * j + 1]);
        }
        if (row_b < p.seq_q) {
          *reinterpret_cast<uint32_t*>(dq_base + row_b * row_stride + col) = pack<T>(dq[4 * j + 2], dq[4 * j + 3]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- K2 (dK, dV)

// shared memory: the item's K and V tiles, then the ring of stages (q tile,
// dO tile, the steps' LSE * log2(e) and delta), then the mbarriers
template <int D>
struct DkdvLayout {
  static constexpr int kBlockQ = D == 64 ? 128 : 64;  // queries per step
  static constexpr int kStages = 4;
  static constexpr int kKVBytes = kBlockN * D * 2;    // one K or V tile
  static constexpr int kQBytes = kBlockQ * D * 2;     // one q or dO tile
  static constexpr int kStatOffset = 2 * kQBytes;     // inside a stage: kBlockQ LSE, then kBlockQ delta
  static constexpr int kStageBytes = (kStatOffset + 8 * kBlockQ + 1023) / 1024 * 1024;
  static constexpr int kRing = 2 * kKVBytes;
  static constexpr int kBarOffset = kRing + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + (2 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

template <typename T, int D, bool kMask, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(const __grid_constant__ Params p) {
  using L = DkdvLayout<D>;
  constexpr int kBlockQ = L::kBlockQ;
  constexpr int kPerBlock = kSplitBlock / kBlockQ;  // steps per 128-query block
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem + L::kRing;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_full + 2;
  uint64_t* empty = full + L::kStages;

  const int kv_tiles = (p.seq_k + kBlockN - 1) / kBlockN;
  const int items = kv_tiles * p.heads * p.batch * p.splits;
  const int n_steps = (p.seq_q + kBlockQ - 1) / kBlockQ;
  const int q_blocks = (p.seq_q + kSplitBlock - 1) / kSplitBlock;
  // work item -> (first key, head, batch, split) and its q steps [lo, hi);
  // consecutive items are the splits, then neighbouring kv tiles, of one head
  auto coords = [&](int item, int& k0, int& head, int& batch, int& split, int& lo, int& hi) {
    split = item % p.splits;
    const int rest = item / p.splits;
    k0 = (rest % kv_tiles) * kBlockN;
    head = (rest / kv_tiles) % p.heads;
    batch = rest / (kv_tiles * p.heads);
    // causal: q blocks whose last row precedes k0 see none of these keys
    const int first = kCausal ? min(k0 / kSplitBlock, q_blocks) : 0;
    const int per = (q_blocks - first + p.splits - 1) / p.splits;
    const int lo_block = min(first + split * per, q_blocks);
    lo = lo_block * kPerBlock;
    hi = min(min(lo_block + per, q_blocks) * kPerBlock, n_steps);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerThreads);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread, and the 32 lanes that copy LSE and delta
      mbar_init(&empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<32>();  // 8 more than K3's: the LSE/delta warp's loop would spill at 24
    if (threadIdx.x == 0) {
      int it = 0, n_kv = 0;  // steps and K/V tiles loaded so far
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int k0, head, batch, split, lo, hi;
        coords(item, k0, head, batch, split, lo, hi);
        if (lo >= hi) continue;  // nothing to load: the consumers write zeros
        if (n_kv > 0) mbar_wait(kv_empty, (n_kv - 1) & 1);  // the last item's K and V are read
        mbar_expect_tx(kv_full, 2 * L::kKVBytes);
        load_rows<D>(smem, &p.k_map, kv_full, kBlockN, k0, head, batch);
        load_rows<D>(smem + L::kKVBytes, &p.v_map, kv_full, kBlockN, k0, head, batch);
        ++n_kv;
        for (int step = lo; step < hi; ++step, ++it) {
          const int stage = it % L::kStages;
          if (it >= L::kStages) mbar_wait(&empty[stage], ((it / L::kStages) - 1) & 1);
          uint8_t* q_tile = ring + stage * L::kStageBytes;
          mbar_expect_tx(&full[stage], 2 * L::kQBytes);
          load_rows<D>(q_tile, &p.q_map, &full[stage], kBlockQ, step * kBlockQ, head, batch);
          load_rows<D>(q_tile + L::kQBytes, &p.do_map, &full[stage], kBlockQ, step * kBlockQ, head, batch);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      // warp 1: each step's LSE (times log2(e); natural log in the masked
      // instances) and delta beside its q tile;
      // 0 past Sq, where q = dO = 0 makes the step's contribution 0
      const int lane = threadIdx.x % 32;
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int k0, head, batch, split, lo, hi;
        coords(item, k0, head, batch, split, lo, hi);
        const float* lse = p.lse + ((long long)batch * p.heads + head) * p.seq_q;
        const float* delta = p.delta + batch * p.d_sb + head * p.d_sh;
        for (int step = lo; step < hi; ++step, ++it) {
          const int stage = it % L::kStages;
          if (it >= L::kStages) mbar_wait(&empty[stage], ((it / L::kStages) - 1) & 1);
          float* stat = reinterpret_cast<float*>(ring + stage * L::kStageBytes + L::kStatOffset);
          for (int i = lane; i < kBlockQ; i += 32) {
            const int q = step * kBlockQ + i;
            stat[i] = q < p.seq_q ? (kMask ? lse[q] : lse[q] * kLog2e) : 0.f;
            stat[kBlockQ + i] = q < p.seq_q ? delta[q * p.d_sq] : 0.f;
          }
          mbar_arrive(&full[stage]);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<232>();  // 128 x (32 + 2 x 232) of the SM's 65,536 registers
    const int cw = wg - 1;  // keys 64 cw .. 64 cw + 63 of the kv tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group, thread in group
    const float scale_log2 = p.scale * kLog2e;
    const uint32_t k_addr = smem_addr(smem) + cw * 64 * 128;
    const uint32_t v_addr = k_addr + L::kKVBytes;
    int it = 0, n_kv = 0;  // steps and K/V tiles consumed so far
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int k0, head, batch, split, lo, hi;
      coords(item, k0, head, batch, split, lo, hi);
      const int key_a = k0 + cw * 64 + warp * 16 + g;  // this thread's two keys
      const int key_b = key_a + 8;

      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

      if (lo < hi) {
        mbar_wait(kv_full, n_kv & 1);
        ++n_kv;
      }
      for (int step = lo; step < hi; ++step, ++it) {
        const int stage = it % L::kStages;
        mbar_wait(&full[stage], (it / L::kStages) & 1);
        uint8_t* stage_ptr = ring + stage * L::kStageBytes;
        const uint32_t q_addr = smem_addr(stage_ptr);
        const uint32_t do_addr = q_addr + L::kQBytes;
        const float* lse_s = reinterpret_cast<const float*>(stage_ptr + L::kStatOffset);
        const float* delta_s = lse_s + kBlockQ;

        // S^T = k q^T and dP^T = v dO^T: rows are this warpgroup's keys, columns the step's queries
        float st[kBlockQ / 2], dpt[kBlockQ / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const uint32_t kstep = (k / 4) * kBlockN * 128 + (k % 4) * 32;
          const uint32_t qstep = (k / 4) * kBlockQ * 128 + (k % 4) * 32;
          ss_wgmma<T, kBlockQ>(st, smem_desc(k_addr + kstep, 16, 1024), smem_desc(q_addr + qstep, 16, 1024), k > 0);
        }
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const uint32_t kstep = (k / 4) * kBlockN * 128 + (k % 4) * 32;
          const uint32_t qstep = (k / 4) * kBlockQ * 128 + (k % 4) * 32;
          ss_wgmma<T, kBlockQ>(dpt, smem_desc(v_addr + kstep, 16, 1024), smem_desc(do_addr + qstep, 16, 1024),
                               k > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if (step == hi - 1) mbar_arrive(kv_empty);  // the producer may load the next item's K and V

        // P^T and dS^T = P^T (dP^T - delta) scale, rounded to T as the A fragments pf and dsf, one
        // n-tile (8 queries) at a time; st[4 j + e]: key (e < 2 ? a : b), query q0 + 8 j + 2 t + (e & 1).
        // Keys past Sk (zero-filled rows of the last kv tile) need no mask here: each row of dK and dV
        // reads only its own row of P^T and dS^T, and those rows are not stored.
        const int q0 = step * kBlockQ;
        uint32_t pf[kBlockQ / 4], dsf[kBlockQ / 4];
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j) {
          float pt[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const int c = j * 8 + 2 * t + (e & 1);
            float x;
            if constexpr (kMask || kCausal) {
              const int key = (e & 2) ? key_b : key_a;
              const int query = q0 + c;
              x = st[i] * p.scale;
              if constexpr (kMask) {
                if (query < p.seq_q && key < p.seq_k) {
                  x += p.mask[batch * p.m_sb + head * p.m_sh + (long long)query * p.m_sq + (long long)key * p.m_sk];
                }
              }
              if constexpr (kCausal) {
                if (key > query) x = kNegInf;
              }
              x = kMask ? (x - lse_s[c]) * kLog2e : x * kLog2e - lse_s[c];
            } else {
              x = fmaf(st[i], scale_log2, -lse_s[c]);
            }
            pt[e] = ex2(x);
            st[i] = pt[e] * (dpt[i] - delta_s[c]) * p.scale;
          }
          pf[2 * j] = pack<T>(pt[0], pt[1]);
          pf[2 * j + 1] = pack<T>(pt[2], pt[3]);
          dsf[2 * j] = pack<T>(st[4 * j], st[4 * j + 1]);
          dsf[2 * j + 1] = pack<T>(st[4 * j + 2], st[4 * j + 3]);
        }

        // dV += P^T dO and dK += dS^T q: 16 queries (two 1,024-byte row groups) per step, dO and q MN-major
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBlockQ / 16; ++j) {
          rs_wgmma<T, D>(dv, &pf[4 * j], smem_desc(do_addr + j * 16 * 128, kBlockQ * 128, 1024));
        }
#pragma unroll
        for (int j = 0; j < kBlockQ / 16; ++j) {
          rs_wgmma<T, D>(dk, &dsf[4 * j], smem_desc(q_addr + j * 16 * 128, kBlockQ * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        mbar_arrive(&empty[stage]);
      }

      // dK and dV rounded once, or this split's f32 partials
      const long long row_stride = (long long)p.heads * D;
      const long long offset = ((long long)batch * p.seq_k * p.heads + head) * D;
      if (p.splits == 1) {
        T* dk_base = static_cast<T*>(p.dk) + offset;
        T* dv_base = static_cast<T*>(p.dv) + offset;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = j * 8 + 2 * t;
          if (key_a < p.seq_k) {
            *reinterpret_cast<uint32_t*>(dk_base + key_a * row_stride + col) = pack<T>(dk[4 * j], dk[4 * j + 1]);
            *reinterpret_cast<uint32_t*>(dv_base + key_a * row_stride + col) = pack<T>(dv[4 * j], dv[4 * j + 1]);
          }
          if (key_b < p.seq_k) {
            *reinterpret_cast<uint32_t*>(dk_base + key_b * row_stride + col) = pack<T>(dk[4 * j + 2], dk[4 * j + 3]);
            *reinterpret_cast<uint32_t*>(dv_base + key_b * row_stride + col) = pack<T>(dv[4 * j + 2], dv[4 * j + 3]);
          }
        }
      } else {
        const long long n = (long long)p.batch * p.seq_k * p.heads * D;  // elements of one partial
        float* dk_base = p.ws + split * n + offset;
        float* dv_base = p.ws + (p.splits + split) * n + offset;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = j * 8 + 2 * t;
          if (key_a < p.seq_k) {
            *reinterpret_cast<float2*>(dk_base + key_a * row_stride + col) = make_float2(dk[4 * j], dk[4 * j + 1]);
            *reinterpret_cast<float2*>(dv_base + key_a * row_stride + col) = make_float2(dv[4 * j], dv[4 * j + 1]);
          }
          if (key_b < p.seq_k) {
            *reinterpret_cast<float2*>(dk_base + key_b * row_stride + col) =
                make_float2(dk[4 * j + 2], dk[4 * j + 3]);
            *reinterpret_cast<float2*>(dv_base + key_b * row_stride + col) =
                make_float2(dv[4 * j + 2], dv[4 * j + 3]);
          }
        }
      }
    }
  }
}

// K2's second pass when the query sweep is split: dK and dV = the sum of the
// f32 partials [2, splits, n] in split order, rounded once to T (n elements
// of each output, a multiple of 4: head_dim is)
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dkdv_reduce_kernel(const float* ws, T* dk, T* dv, long long n,
                                                                    int splits) {
  const long long n4 = n / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * blockDim.x) {
    const bool is_v = i >= n4;
    const long long j = is_v ? i - n4 : i;
    const float4* src = reinterpret_cast<const float4*>(ws + (is_v ? splits : 0) * n) + j;
    float4 acc = src[0];
    for (int s = 1; s < splits; ++s) {
      const float4 x = src[s * n4];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<uint2*>((is_v ? dv : dk) + 4 * j) = make_uint2(pack<T>(acc.x, acc.y), pack<T>(acc.z, acc.w));
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int D, bool kMask, bool kCausal>
cudaError_t launch_dkdv(const Params& p, cudaStream_t stream) {
  auto kernel = flash_bwd_dkdv_kernel<T, D, kMask, kCausal>;
  static uint64_t configured = 0;  // devices on which the shared-memory limit is raised
  cudaError_t err = raise_smem_limit(kernel, DkdvLayout<D>::kBytes, &configured);
  if (err != cudaSuccess) return err;
  const int items = (p.seq_k + kBlockN - 1) / kBlockN * p.heads * p.batch * p.splits;
  kernel<<<min(items, sm_count()), kThreads, DkdvLayout<D>::kBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long n = (long long)p.batch * p.seq_k * p.heads * D;
  const long long needed = (2 * (n / 4) + 255) / 256, cap = 16ll * sm_count();
  flash_bwd_dkdv_reduce_kernel<T><<<(int)(needed < cap ? needed : cap), 256, 0, stream>>>(p.ws, static_cast<T*>(p.dk),
                                                                   static_cast<T*>(p.dv), n, p.splits);
  return cudaGetLastError();
}

template <typename T, int D, bool kMask, bool kCausal>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D, kMask, kCausal>;
  static uint64_t configured = 0;
  cudaError_t err = raise_smem_limit(kernel, DqLayout<D>::kBytes, &configured);
  if (err != cudaSuccess) return err;
  const int items = (p.seq_q + kBlockM - 1) / kBlockM * p.heads * p.batch;
  kernel<<<min(items, sm_count()), kThreads, DqLayout<D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// which: bit 0 launches K2 (and its reduction when split), bit 1 K3
template <typename T, int D, bool kMask, bool kCausal>
cudaError_t launch(const Params& p, int which, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (which & 1) err = launch_dkdv<T, D, kMask, kCausal>(p, stream);
  if (err == cudaSuccess && (which & 2)) err = launch_dq<T, D, kMask, kCausal>(p, stream);
  return err;
}

template <typename T, int D>
cudaError_t launch_variant(const Params& p, bool causal, int which, cudaStream_t stream) {
  if (p.mask != nullptr) {
    return causal ? launch<T, D, true, true>(p, which, stream) : launch<T, D, true, false>(p, which, stream);
  }
  return causal ? launch<T, D, false, true>(p, which, stream) : launch<T, D, false, false>(p, which, stream);
}

template <typename T>
cudaError_t launch_dtype(const Params& p, int head_dim, bool causal, int which, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_variant<T, 64>(p, causal, which, stream);
    case 128: return launch_variant<T, 128>(p, causal, which, stream);
    default: return cudaErrorInvalidValue;
  }
}

// (D, S, H, B) map of a BSHD operand with element strides (sb, ss, sh) and a
// unit head_dim stride; boxes of 64 x 64 rows
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dtype, int head_dim, int seq, int heads,
              int batch, long long sb, long long ss, long long sh) {
  const uint64_t dims[4] = {(uint64_t)head_dim, (uint64_t)seq, (uint64_t)heads, (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {64, kBox, 1, 1};
  return encode_tensor_map(map, dtype, 4, ptr, dims, strides, box);
}

}  // namespace

// C interface, bound with ctypes. dtype: 0 = bfloat16, 1 = float16. Strides
// are in elements: (batch, seq, head) for q/k/v/dO (head-dim stride 1, every
// other stride a non-zero multiple of 16 bytes: TMA) and (batch, head, q, k)
// for the mask and (batch, head, q) for delta, an f32 [B, H, Sq]; lse is a
// contiguous [B, H, Sq] f32 and dq/dk/dv contiguous BSHD. `which`: bit 0 launches K2 (dk, dv; with `splits` > 1 its
// f32 workspace [2, splits, B, Sk, H, D] and the reduction), bit 1 K3 (dq);
// the four tensor maps are encoded once for both. Returns the launches'
// cudaError_t (0 on success; cudaErrorInvalidValue if a tensor map or an
// argument is refused); the caller raises on anything else.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const float* mask,
    const float* lse, const float* delta, void* dq, void* dk, void* dv, float* workspace,
    int batch, int heads, int seq_q, int seq_k, int head_dim, int dtype,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long d_sb, long long d_sh, long long d_sq,
    long long m_sb, long long m_sh, long long m_sq, long long m_sk,
    float scale, int causal, int splits, int which, void* stream) {
  if ((dtype != 0 && dtype != 1) || splits < 1 || ((which & 1) && splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CUtensorMapDataType tdt = dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  Params p;
  if (!make_map(&p.q_map, q, tdt, head_dim, seq_q, heads, batch, q_sb, q_ss, q_sh) ||
      !make_map(&p.k_map, k, tdt, head_dim, seq_k, heads, batch, k_sb, k_ss, k_sh) ||
      !make_map(&p.v_map, v, tdt, head_dim, seq_k, heads, batch, v_sb, v_ss, v_sh) ||
      !make_map(&p.do_map, dout, tdt, head_dim, seq_q, heads, batch, do_sb, do_ss, do_sh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mask = mask; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv; p.ws = splits > 1 ? workspace : nullptr;
  p.batch = batch; p.heads = heads; p.seq_q = seq_q; p.seq_k = seq_k;
  p.splits = splits;
  p.d_sb = d_sb; p.d_sh = d_sh; p.d_sq = d_sq;
  p.m_sb = m_sb; p.m_sh = m_sh; p.m_sq = m_sq; p.m_sk = m_sk;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_dtype<__nv_bfloat16>(p, head_dim, causal != 0, which, s)
                                     : launch_dtype<__half>(p, head_dim, causal != 0, which, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of a launch at `head_dim` (bytes) of K2 (kernel 0)
// or K3 (kernel 1), or -1.
extern "C" int flash_attention_bwd_smem_bytes(int head_dim, int kernel) {
  if (head_dim != 64 && head_dim != 128) return -1;
  if (kernel == 0) return head_dim == 64 ? DkdvLayout<64>::kBytes : DkdvLayout<128>::kBytes;
  if (kernel == 1) return head_dim == 64 ? DqLayout<64>::kBytes : DqLayout<128>::kBytes;
  return -1;
}
