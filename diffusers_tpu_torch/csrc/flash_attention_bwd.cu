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
// per (query, key) pair (q k^T, P^T dO, v dO^T, dS^T q: 8 * Sq * Sk * D FLOP
// per head), K3 three (q k^T, dO v^T, dS k: 6 * Sq * Sk * D); at SDXL's self
// attention (head_dim 64, 1024 or 4096 tokens) each q/k/v/dO byte is reused
// across a whole sweep, far above the card's ~295 FLOP/byte bf16 ridge. The
// 77-token cross attention is bound by bytes. The exp of P (Sq * Sk per head,
// recomputed in both kernels) is the second cost.
//
// What the design does about it:
//  * Two kernels, no atomics, as in the JAX package. K2 takes one block per
//    (kv tile of 64 keys, head, batch) and loops over q tiles; K3 one block
//    per (q tile of 64 rows, head, batch) and loops over kv tiles. The loops
//    replace the Pallas kernels' sequential fori_loops; no state crosses
//    blocks. Four warps, 16 keys (K2) or 16 query rows (K3) each.
//  * Every product runs on the tensor cores through `mma.sync.m16n8k16` (bf16
//    or fp16 in, f32 accumulate), as in K1. K2 computes S^T = k q^T, so the
//    accumulators of P^T and dS^T are already the A operands of P^T dO and
//    dS^T q (FlashAttention-2's register trick; K1 uses its mirror image,
//    which K3 reuses for dS k). P and dS never touch memory.
//  * dK and dV (K2) and dQ (K3) accumulate in f32 registers and are written
//    once. At head_dim 128 the q tile is walked in two halves of 32 queries
//    (K2) or keys (K3), which keeps the live score tiles to 16 registers.
//  * q/k/v/dO are read in BSHD through strides; dq/dk/dv are written in BSHD.
//    The ragged edges of Sq and Sk are masked here (zero-filled tiles, P = 0
//    outside), so SDXL's 77-token cross attention runs on the kernels. The
//    additive f32 mask is read through its four strides.
// wgmma, TMA and a multi-stage copy pipeline are later PRs' work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;    // query rows or keys per tile
constexpr int kWarps = 4;     // 16 rows of the block's own tile per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // smem row padding (elements): conflict-free fragment reads

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* mask;   // additive f32 bias indexed through mask strides, or null
  const float* lse;    // [B, H, Sq] f32
  const float* delta;  // [B, H, Sq] f32: rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  int heads, seq_q, seq_k;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  long long m_sb, m_sh, m_sq, m_sk;
  float scale;
  int causal;
};

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Copy rows [row0, row0 + 64) of a [*, D] strided matrix into smem, zero-filling
// rows at or past `rows`. 16-byte vectors; the wrapper guarantees alignment.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* smem, const T* base, long long row_stride, int row0, int rows) {
  constexpr int kVecPerRow = D / 8;
  constexpr int kLds = D + kPad;
  for (int i = threadIdx.x; i < kBlock * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(smem + r * kLds + c) = val;
  }
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4), from a smem tile
// with row stride L. `m` points at the fragment's first row and column.
//   A (16 x 16, row-major):  A[r][c] = m[r][c]
template <typename T, int L>
__device__ __forceinline__ void frag_a(uint32_t* a, const T* m, int g, int t) {
  a[0] = ld32(m + g * L + 2 * t);
  a[1] = ld32(m + (g + 8) * L + 2 * t);
  a[2] = ld32(m + g * L + 2 * t + 8);
  a[3] = ld32(m + (g + 8) * L + 2 * t + 8);
}

//   B (16 x 8) of a matrix stored n-major:  B[k][n] = m[n][k]
template <typename T, int L>
__device__ __forceinline__ void frag_b_nk(uint32_t& b0, uint32_t& b1, const T* m, int g, int t) {
  b0 = ld32(m + g * L + 2 * t);
  b1 = ld32(m + g * L + 2 * t + 8);
}

//   B (16 x 8) of a matrix stored k-major:  B[k][n] = m[k][n] (two 16-bit gathers)
template <typename T, int L>
__device__ __forceinline__ void frag_b_kn(uint32_t& b0, uint32_t& b1, const T* m, int g, int t) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(m);
  b0 = (uint32_t)s[(2 * t) * L + g] | ((uint32_t)s[(2 * t + 1) * L + g] << 16);
  b1 = (uint32_t)s[(2 * t + 8) * L + g] | ((uint32_t)s[(2 * t + 9) * L + g] << 16);
}

// The accumulators of n-tiles (2kk, 2kk + 1) as the A fragment of k-chunk kk.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = Mma<T>::pack(c0[0], c0[1]);
  a[1] = Mma<T>::pack(c0[2], c0[3]);
  a[2] = Mma<T>::pack(c1[0], c1[1]);
  a[3] = Mma<T>::pack(c1[2], c1[3]);
}

// Store a [16 x D] f32 accumulator tile (rows row_a, row_a + 8) in T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long row_stride, int row_a, int rows, int t,
                                           const float (*acc)[4]) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_a < rows) {
      *reinterpret_cast<uint32_t*>(base + (long long)row_a * row_stride + col) = Mma<T>::pack(acc[j][0], acc[j][1]);
    }
    if (row_b < rows) {
      *reinterpret_cast<uint32_t*>(base + (long long)row_b * row_stride + col) = Mma<T>::pack(acc[j][2], acc[j][3]);
    }
  }
}

template <typename T, int D>
constexpr int smem_bytes() {
  return 4 * kBlock * (D + kPad) * (int)sizeof(T) + 2 * kBlock * (int)sizeof(float);
}

// K2: dK and dV for the 64 keys of one block, looping over q tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Params p) {
  constexpr int L = D + kPad;
  constexpr int kDChunks = D / 16;
  constexpr int kNTilesD = D / 8;
  constexpr int kSub = D == 128 ? 32 : 64;  // queries per inner step
  constexpr int kNT = kSub / 8;  // query n-tiles of one inner step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + kBlock * L;
  T* sq = sv + kBlock * L;
  T* sdo = sq + kBlock * L;
  float* slse = reinterpret_cast<float*>(sdo + kBlock * L);
  float* sdelta = slse + kBlock;

  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kBlock;

  const T* q_base = static_cast<const T*>(p.q) + batch * p.q_sb + head * p.q_sh;
  const T* k_base = static_cast<const T*>(p.k) + batch * p.k_sb + head * p.k_sh;
  const T* v_base = static_cast<const T*>(p.v) + batch * p.v_sb + head * p.v_sh;
  const T* do_base = static_cast<const T*>(p.dout) + batch * p.do_sb + head * p.do_sh;
  const float* lse = p.lse + ((long long)batch * p.heads + head) * p.seq_q;
  const float* delta = p.delta + ((long long)batch * p.heads + head) * p.seq_q;
  const float* mask = p.mask == nullptr ? nullptr : p.mask + batch * p.m_sb + head * p.m_sh;

  load_tile<T, D>(sk, k_base, p.k_ss, k0, p.seq_k);
  load_tile<T, D>(sv, v_base, p.v_ss, k0, p.seq_k);

  const int key_a = k0 + warp * 16 + g;  // this thread's two keys
  const int key_b = key_a + 8;
  const T* kw = sk + warp * 16 * L;
  const T* vw = sv + warp * 16 * L;

  float dk[kNTilesD][4], dv[kNTilesD][4];
#pragma unroll
  for (int j = 0; j < kNTilesD; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  const int n_q_tiles = (p.seq_q + kBlock - 1) / kBlock;
  // causal: q tiles whose last row precedes k0 see none of these keys
  const int first = p.causal ? k0 / kBlock : 0;

  for (int qt = first; qt < n_q_tiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // the previous q tile is fully read
    load_tile<T, D>(sq, q_base, p.q_ss, q0, p.seq_q);
    load_tile<T, D>(sdo, do_base, p.do_ss, q0, p.seq_q);
    if (threadIdx.x < kBlock) {
      const int r = q0 + threadIdx.x;
      slse[threadIdx.x] = r < p.seq_q ? lse[r] : 0.f;
      sdelta[threadIdx.x] = r < p.seq_q ? delta[r] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int sub = 0; sub < kBlock / kSub; ++sub) {
      const int qs = sub * kSub;
      // S^T = k q^T: rows are this warp's keys, columns the queries
      float st[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kDChunks; ++kc) {
        uint32_t a[4];
        frag_a<T, L>(a, kw + kc * 16, g, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b0, b1;
          frag_b_nk<T, L>(b0, b1, sq + (qs + j * 8) * L + kc * 16, g, t);
          Mma<T>::mma(st[j], a, b0, b1);
        }
      }
      // P^T = exp(scale S^T + mask - lse); 0 outside Sq x Sk and above the causal diagonal
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key_a : key_b;
          const int qi = qs + j * 8 + 2 * t + (e & 1);
          const int query = q0 + qi;
          const bool live = query < p.seq_q && key < p.seq_k && !(p.causal && key > query);
          float x = st[j][e] * p.scale;
          if (mask != nullptr && live) x += mask[(long long)query * p.m_sq + (long long)key * p.m_sk];
          st[j][e] = live ? __expf(x - slse[qi]) : 0.f;
        }
      }
      // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t a[4];
        acc_to_a<T>(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
        for (int jd = 0; jd < kNTilesD; ++jd) {
          uint32_t b0, b1;
          frag_b_kn<T, L>(b0, b1, sdo + (qs + kk * 16) * L + jd * 8, g, t);
          Mma<T>::mma(dv[jd], a, b0, b1);
        }
      }
      // dP^T = v dO^T
      float dpt[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kDChunks; ++kc) {
        uint32_t a[4];
        frag_a<T, L>(a, vw + kc * 16, g, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b0, b1;
          frag_b_nk<T, L>(b0, b1, sdo + (qs + j * 8) * L + kc * 16, g, t);
          Mma<T>::mma(dpt[j], a, b0, b1);
        }
      }
      // dS^T = P^T (dP^T - delta) scale, in place of P^T
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qs + j * 8 + 2 * t + (e & 1);
          st[j][e] = st[j][e] * (dpt[j][e] - sdelta[qi]) * p.scale;
        }
      }
      // dK += dS^T q
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t a[4];
        acc_to_a<T>(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
        for (int jd = 0; jd < kNTilesD; ++jd) {
          uint32_t b0, b1;
          frag_b_kn<T, L>(b0, b1, sq + (qs + kk * 16) * L + jd * 8, g, t);
          Mma<T>::mma(dk[jd], a, b0, b1);
        }
      }
    }
  }

  T* dk_base = static_cast<T*>(p.dk) + batch * p.dk_sb + head * p.dk_sh;
  T* dv_base = static_cast<T*>(p.dv) + batch * p.dv_sb + head * p.dv_sh;
  store_rows<T, D>(dk_base, p.dk_ss, key_a, p.seq_k, t, dk);
  store_rows<T, D>(dv_base, p.dv_ss, key_a, p.seq_k, t, dv);
}

// K3: dQ for the 64 query rows of one block, looping over kv tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int L = D + kPad;
  constexpr int kDChunks = D / 16;
  constexpr int kNTilesD = D / 8;
  constexpr int kSub = D == 128 ? 32 : 64;  // keys per inner step
  constexpr int kNT = kSub / 8;  // key n-tiles of one inner step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + kBlock * L;
  T* sk = sdo + kBlock * L;
  T* sv = sk + kBlock * L;

  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlock;

  const T* q_base = static_cast<const T*>(p.q) + batch * p.q_sb + head * p.q_sh;
  const T* k_base = static_cast<const T*>(p.k) + batch * p.k_sb + head * p.k_sh;
  const T* v_base = static_cast<const T*>(p.v) + batch * p.v_sb + head * p.v_sh;
  const T* do_base = static_cast<const T*>(p.dout) + batch * p.do_sb + head * p.do_sh;
  const float* lse = p.lse + ((long long)batch * p.heads + head) * p.seq_q;
  const float* delta = p.delta + ((long long)batch * p.heads + head) * p.seq_q;
  const float* mask = p.mask == nullptr ? nullptr : p.mask + batch * p.m_sb + head * p.m_sh;

  load_tile<T, D>(sq, q_base, p.q_ss, q0, p.seq_q);
  load_tile<T, D>(sdo, do_base, p.do_ss, q0, p.seq_q);

  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const float lse_a = row_a < p.seq_q ? lse[row_a] : 0.f;
  const float lse_b = row_b < p.seq_q ? lse[row_b] : 0.f;
  const float delta_a = row_a < p.seq_q ? delta[row_a] : 0.f;
  const float delta_b = row_b < p.seq_q ? delta[row_b] : 0.f;
  const T* qw = sq + warp * 16 * L;
  const T* dow = sdo + warp * 16 * L;

  float dq[kNTilesD][4];
#pragma unroll
  for (int j = 0; j < kNTilesD; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  int n_tiles = (p.seq_k + kBlock - 1) / kBlock;
  if (p.causal) {
    const int last = min(q0 + kBlock, p.seq_q) - 1;  // keys past the last row are all masked
    n_tiles = min(n_tiles, last / kBlock + 1);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBlock;
    __syncthreads();  // the previous kv tile (or nothing) is fully read
    load_tile<T, D>(sk, k_base, p.k_ss, kv0, p.seq_k);
    load_tile<T, D>(sv, v_base, p.v_ss, kv0, p.seq_k);
    __syncthreads();

#pragma unroll
    for (int sub = 0; sub < kBlock / kSub; ++sub) {
      const int ks = sub * kSub;
      // S = q k^T
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kDChunks; ++kc) {
        uint32_t a[4];
        frag_a<T, L>(a, qw + kc * 16, g, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b0, b1;
          frag_b_nk<T, L>(b0, b1, sk + (ks + j * 8) * L + kc * 16, g, t);
          Mma<T>::mma(s[j], a, b0, b1);
        }
      }
      // P = exp(scale S + mask - lse)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row_a : row_b;
          const int col = kv0 + ks + j * 8 + 2 * t + (e & 1);
          const bool live = row < p.seq_q && col < p.seq_k && !(p.causal && col > row);
          float x = s[j][e] * p.scale;
          if (mask != nullptr && live) x += mask[(long long)row * p.m_sq + (long long)col * p.m_sk];
          s[j][e] = live ? __expf(x - (e < 2 ? lse_a : lse_b)) : 0.f;
        }
      }
      // dP = dO v^T
      float dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kDChunks; ++kc) {
        uint32_t a[4];
        frag_a<T, L>(a, dow + kc * 16, g, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b0, b1;
          frag_b_nk<T, L>(b0, b1, sv + (ks + j * 8) * L + kc * 16, g, t);
          Mma<T>::mma(dp[j], a, b0, b1);
        }
      }
      // dS = P (dP - delta) scale, in place of P
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[j][0] = s[j][0] * (dp[j][0] - delta_a) * p.scale;
        s[j][1] = s[j][1] * (dp[j][1] - delta_a) * p.scale;
        s[j][2] = s[j][2] * (dp[j][2] - delta_b) * p.scale;
        s[j][3] = s[j][3] * (dp[j][3] - delta_b) * p.scale;
      }
      // dQ += dS k
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t a[4];
        acc_to_a<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int jd = 0; jd < kNTilesD; ++jd) {
          uint32_t b0, b1;
          frag_b_kn<T, L>(b0, b1, sk + (ks + kk * 16) * L + jd * 8, g, t);
          Mma<T>::mma(dq[jd], a, b0, b1);
        }
      }
    }
  }

  T* dq_base = static_cast<T*>(p.dq) + batch * p.dq_sb + head * p.dq_sh;
  store_rows<T, D>(dq_base, p.dq_ss, row_a, p.seq_q, t, dq);
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, bool dkdv, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, D>();
  if (dkdv) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.seq_k + kBlock - 1) / kBlock, p.heads, batch);
    flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.seq_q + kBlock - 1) / kBlock, p.heads, batch);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Params& p, int batch, int head_dim, bool dkdv, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, 64>(p, batch, dkdv, stream);
    case 128: return launch<T, 128>(p, batch, dkdv, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Params& p, int batch, int head_dim, int dtype, bool dkdv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dtype<__nv_bfloat16>(p, batch, head_dim, dkdv, s);
  } else if (dtype == 1) {
    err = launch_dtype<__half>(p, batch, head_dim, dkdv, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout, const float* mask,
                   const float* lse, const float* delta, int heads, int seq_q, int seq_k,
                   const long long* q_s, const long long* k_s, const long long* v_s, const long long* do_s,
                   const long long* m_s, float scale, int causal) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.mask = mask; p.lse = lse; p.delta = delta;
  p.heads = heads; p.seq_q = seq_q; p.seq_k = seq_k;
  p.q_sb = q_s[0]; p.q_ss = q_s[1]; p.q_sh = q_s[2];
  p.k_sb = k_s[0]; p.k_ss = k_s[1]; p.k_sh = k_s[2];
  p.v_sb = v_s[0]; p.v_ss = v_s[1]; p.v_sh = v_s[2];
  p.do_sb = do_s[0]; p.do_ss = do_s[1]; p.do_sh = do_s[2];
  p.m_sb = m_s[0]; p.m_sh = m_s[1]; p.m_sq = m_s[2]; p.m_sk = m_s[3];
  p.scale = scale; p.causal = causal;
  return p;
}

}  // namespace

// C interface, bound with ctypes. dtype: 0 = bfloat16, 1 = float16. Strides are
// in elements, (batch, seq, head) for q/k/v/dO/dq/dk/dv (head-dim stride 1) and
// (batch, head, q, k) for the mask; lse and delta are contiguous [B, H, Sq] f32.
// Each returns the launch's cudaError_t (0 on success); the caller raises on
// anything else.
extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const float* mask,
    const float* lse, const float* delta, void* dk, void* dv,
    int batch, int heads, int seq_q, int seq_k, int head_dim, int dtype,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    long long m_sb, long long m_sh, long long m_sq, long long m_sk,
    float scale, int causal, void* stream) {
  const long long q_s[3] = {q_sb, q_ss, q_sh}, k_s[3] = {k_sb, k_ss, k_sh}, v_s[3] = {v_sb, v_ss, v_sh};
  const long long do_s[3] = {do_sb, do_ss, do_sh}, m_s[4] = {m_sb, m_sh, m_sq, m_sk};
  Params p = make_params(q, k, v, dout, mask, lse, delta, heads, seq_q, seq_k, q_s, k_s, v_s, do_s, m_s,
                         scale, causal);
  p.dk = dk; p.dv = dv;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  return run(p, batch, head_dim, dtype, true, stream);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* mask,
    const float* lse, const float* delta, void* dq,
    int batch, int heads, int seq_q, int seq_k, int head_dim, int dtype,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long m_sb, long long m_sh, long long m_sq, long long m_sk,
    float scale, int causal, void* stream) {
  const long long q_s[3] = {q_sb, q_ss, q_sh}, k_s[3] = {k_sb, k_ss, k_sh}, v_s[3] = {v_sb, v_ss, v_sh};
  const long long do_s[3] = {do_sb, do_ss, do_sh}, m_s[4] = {m_sb, m_sh, m_sq, m_sk};
  Params p = make_params(q, k, v, dout, mask, lse, delta, heads, seq_q, seq_k, q_s, k_s, v_s, do_s, m_s,
                         scale, causal);
  p.dq = dq;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  return run(p, batch, head_dim, dtype, false, stream);
}
