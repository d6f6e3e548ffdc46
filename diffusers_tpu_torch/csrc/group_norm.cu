// GroupNorm (+SiLU) for NVIDIA Hopper (sm_90a): kernel K4 of the port.
//
// Replaces the Pallas TPU kernel `_gn_kernel` / `group_norm_silu`
// (diffusers_tpu/ops/pallas/group_norm.py:30,150). Same function: per
// (batch, group), the f32 mean and variance over the group's channels and
// every spatial position; then (x - mean) * rstd * w[c] + b[c], SiLU if
// asked, written once in x's type. x is contiguous NCHW (any number of
// spatial dimensions), so a (batch, group) is one contiguous span of
// C/G * H*W elements.
//
// What bounds it on an H100: bytes. It does about ten operations an element
// against the card's ~295 FLOP/byte bf16 ridge, so the floor is one read and
// one write of x: 2 x bytes(x) / 3.35 TB/s.
//
// What the design does about it: two regimes, chosen per shape on the host
// (`plan_group_norm`, ops/cuda/group_norm.py), both on CTAs that stage a
// chunk of a span in shared memory with 1-D bulk copies (`cp.async.bulk`),
// 16 KB each on an mbarrier of its own, so that the first pass over the
// chunk starts while the rest of it is in flight.
//  * Cluster (a span of at most 8 x 30 KB: the SDXL UNet's GroupNorms at
//    32 x 32 and at 64 x 64 up to 960 channels, 33 of its 46). One
//    thread-block cluster of up to 8 CTAs per span, so 512 CTAs fill the
//    132 SMs where one program per span ran 64. Each CTA sums its chunk in
//    f32 in a fixed order; the CTAs exchange their partial sums through
//    distributed shared memory, and each adds them in rank order. A second
//    pass over shared memory, not HBM, sums the centred squares, exchanged
//    the same way: the plain version's two-pass statistics. The CTA then
//    normalises from shared memory and stores 16 bytes a thread. HBM sees
//    one read and one write of x, the bound.
//  * Split (larger spans: the UNet's maps at 128 x 128 and its 1,280 and
//    1,920 channels at 64 x 64, and the VAE). A statistics kernel stages
//    each 32 KB chunk of a span the same way and writes the chunk's (mean,
//    M2) to a workspace; a normalise kernel merges the span's partials in a
//    fixed order (Chan's formula: each lane of a warp merges a fixed stride
//    of them, then a fixed butterfly) and reads its chunk again. It walks
//    the chunks in reverse, so its first CTAs find in the 50 MB L2 the bytes
//    that the statistics kernel read last. HBM traffic is about 3 x
//    bytes(x), but small chunks keep several CTAs on an SM in different
//    phases, where a cluster's CTAs run their loads, sums and stores in
//    lockstep: on an H100 the two regimes tie up to 240 KB a span and the
//    split regime is the faster one above it (`tools/tune_group_norm.py`).
//  * Ragged and unaligned spans: a bulk copy moves only whole, aligned
//    16-byte words, so the head and tail of a chunk that do not fill one
//    ((2, 96, 7, 9): 189 elements a span) are read with ordinary loads,
//    and the first and last words of a chunk are stored element by element.
//  * Deterministic: no atomics, and every sum runs in a fixed order, so two
//    launches are bit-identical.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;      // CTAs an SM the registers must allow (64 a thread)
constexpr int kHeader = 256;       // bytes of shared memory before the chunk
constexpr int kPiece = 16384;      // bytes a bulk copy, each on an mbarrier of its own
constexpr int kMaxPieces = 16;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use on sm_90

enum Mode { kCluster = 0, kStats = 1, kNormalize = 2 };

struct Params {
  const void* x;
  void* y;
  const void* w;
  const void* b;
  float* partials;   // split regime: [spans, parts, 2] f32 (mean, M2 of each chunk)
  unsigned long long hw_magic;  // n / hw = (n * hw_magic) >> hw_shift for 0 <= n < 2^31
  int hw_shift;
  int span;          // elements a (batch, group), < 2^31
  int hw;            // elements a channel
  int chunk;         // elements a CTA, a multiple of 16 bytes
  int cpg;           // channels a group
  int groups;        // groups a batch element
  int parts;         // CTAs a span (the cluster size in the cluster regime)
  int items;         // spans * parts
  float eps;
  int silu;
  int drop;          // a control: the partial (cluster rank or chunk) left out of the merge, or -1
};

struct Header {  // the start of dynamic shared memory
  uint64_t bar[kMaxPieces];  // one a bulk copy
  float warp[kWarps];        // the warps' partials of a block reduction
  float slot[2];             // this CTA's partial sum and centred M2, read by its cluster
  float mean, rstd;          // broadcast to the block
};
static_assert(sizeof(Header) <= kHeader, "the header outgrew its bytes");

// A CTA's chunk: span-local elements [lo, lo + n). Shared memory holds the
// chunk's first element at `off`, after the elements of its first 16-byte
// word that precede it; word v (A elements) of shared memory holds global
// elements s0 + v A .. s0 + v A + A - 1. Words [vf, vl) are whole.
struct Chunk {
  long long s0;
  int lo, n, off;
  int nv, vf, vl;
  int bulk0;   // shared byte offset of the first bulk copy
  int pieces;  // bulk copies
};

template <typename T>
__device__ __forceinline__ Chunk make_chunk(long long span_start, int lo, int hi) {
  constexpr int A = 16 / sizeof(T);
  const long long start = span_start + lo, end = span_start + hi;
  Chunk c;
  c.s0 = start & ~static_cast<long long>(A - 1);
  c.lo = lo;
  c.n = hi - lo;
  c.off = static_cast<int>(start - c.s0);
  c.nv = c.n > 0 ? (c.off + c.n + A - 1) / A : 0;
  c.vf = c.off > 0 ? 1 : 0;
  c.vl = max((c.off + c.n) / A, c.vf);
  // aligned words [a0, a1) by bulk copy; the head [start, a0) and tail [a1, end) by ordinary loads
  const long long a0 = min((start + A - 1) & ~static_cast<long long>(A - 1), end);
  const long long a1 = max(end & ~static_cast<long long>(A - 1), a0);
  c.bulk0 = static_cast<int>(a0 - c.s0) * static_cast<int>(sizeof(T));
  c.pieces = static_cast<int>(((a1 - a0) * static_cast<long long>(sizeof(T)) + kPiece - 1) / kPiece);
  return c;
}

// Thread 0 issues the chunk's bulk copies, one mbarrier each (initialised
// with a count of 1); the block reads the head and tail with ordinary loads.
// The caller then syncs the block; readers wait on a word's piece
// (`wait_word`) before they read it.
template <typename T>
__device__ __forceinline__ void load_chunk(T* buf, const T* x, const Chunk& c, Header* h) {
  constexpr int A = 16 / sizeof(T);
  const int bulk_bytes = c.n > 0 ? (c.vl - c.vf) * 16 : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < c.pieces; ++i) {
      const int bytes = min(kPiece, bulk_bytes - i * kPiece);
      mbar_expect_tx(&h->bar[i], static_cast<uint32_t>(bytes));
      bulk_load(reinterpret_cast<char*>(buf) + c.bulk0 + i * kPiece,
                reinterpret_cast<const char*>(x + c.s0) + c.bulk0 + i * kPiece, static_cast<uint32_t>(bytes),
                &h->bar[i]);
    }
  }
  // the chunk's elements outside its whole words
  const int head = c.vf * A - c.off;  // elements of word 0 in the chunk, when word 0 is not whole
  const int head_n = c.vf ? min(head, c.n) : 0;
  const int tail_n = c.nv > c.vl ? c.off + c.n - c.vl * A : 0;
  const int t = threadIdx.x;
  if (t < head_n) {
    buf[c.off + t] = x[c.s0 + c.off + t];
  } else if (t < head_n + tail_n) {
    const int i = c.vl * A + (t - head_n);
    buf[i] = x[c.s0 + i];
  }
}

// Waits for the bulk copy that holds shared word v (words outside the bulk
// copies were loaded before the block's barrier). `waited`: the last piece
// this thread waited for.
__device__ __forceinline__ void wait_word(const Chunk& c, Header* h, int v, int& waited) {
  const int pb = v * 16 - c.bulk0;
  if (pb < 0 || c.pieces == 0) return;
  const int piece = min(pb / kPiece, c.pieces - 1);
  if (piece > waited) {
    mbar_wait(&h->bar[piece], 0);
    waited = piece;
  }
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(p[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else if constexpr (std::is_same<T, __half>::value) {
    const __half2* p = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __half22float2(p[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[16 / sizeof(T)]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&v);
    }
  } else if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __half2 v = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&v);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(f[i]);
  }
  return u;
}

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(v);
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(v);
  } else {
    return v;
  }
}

// (x - mean) * rstd * w + b rounded after each operation, as the plain
// version computes it; then SiLU
__device__ __forceinline__ float affine(float x, float mean, float rstd, float w, float b, bool silu) {
  const float v = __fadd_rn(__fmul_rn(__fmul_rn(x - mean, rstd), w), b);
  return silu ? __fdividef(v, 1.f + __expf(-v)) : v;
}

__device__ __forceinline__ int channel_of(const Params& p, int n) {
  return static_cast<int>((static_cast<unsigned long long>(n) * p.hw_magic) >> p.hw_shift);
}

struct Identity {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};
struct Centred {  // the square of the distance to `mean`
  float mean;
  __device__ __forceinline__ float operator()(float v) const {
    const float d = v - mean;
    return d * d;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The f32 sum of f(x) over the chunk, returned to every thread, in a fixed
// order: each thread its words tid, tid + kThreads, ... (a word's elements
// as a pairwise tree), the warps' butterflies, then the warps in order.
template <typename T, typename F>
__device__ __forceinline__ float chunk_reduce(const T* buf, const Chunk& c, Header* h, F f) {
  constexpr int A = 16 / sizeof(T);
  float acc = 0.f;
  int waited = -1;
  for (int v = threadIdx.x; v < c.nv; v += kThreads) {
    wait_word(c, h, v, waited);
    float e[A];
    unpack<T>(reinterpret_cast<const uint4*>(buf)[v], e);
    const bool whole = v >= c.vf && v < c.vl;
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const int o = v * A + j - c.off;
      e[j] = whole || (o >= 0 && o < c.n) ? f(e[j]) : 0.f;
    }
#pragma unroll
    for (int s = 1; s < A; s *= 2) {
#pragma unroll
      for (int j = 0; j < A; j += 2 * s) e[j] += e[j + s];
    }
    acc += e[0];
  }
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) h->warp[threadIdx.x / 32] = acc;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += h->warp[i];
  __syncthreads();  // h->warp is free again
  return total;
}

// Normalises the chunk from shared memory and stores it: a whole word of one
// channel as one 16-byte store; the chunk's ragged first and last words and
// words that cross a channel element by element.
template <typename T, typename W>
__device__ __forceinline__ void normalize_store(const Params& p, const T* buf, const Chunk& c, Header* h,
                                                int channel0, float mean, float rstd) {
  constexpr int A = 16 / sizeof(T);
  T* y = static_cast<T*>(p.y) + c.s0;
  const W* w = static_cast<const W*>(p.w) + channel0;
  const W* b = static_cast<const W*>(p.b) + channel0;
  const bool silu = p.silu != 0;
  int waited = -1;
  for (int v = threadIdx.x; v < c.nv; v += kThreads) {
    wait_word(c, h, v, waited);
    float e[A];
    unpack<T>(reinterpret_cast<const uint4*>(buf)[v], e);
    const int first = c.lo + v * A - c.off;  // span-local index of the word's element 0
    if (v >= c.vf && v < c.vl) {
      const int ch = channel_of(p, first);
      if (first - ch * p.hw + A <= p.hw) {
        const float wc = to_f(w[ch]), bc = to_f(b[ch]);
#pragma unroll
        for (int j = 0; j < A; ++j) e[j] = affine(e[j], mean, rstd, wc, bc, silu);
        *reinterpret_cast<uint4*>(y + v * A) = pack<T>(e);
        continue;
      }
    }
    for (int j = 0; j < A; ++j) {
      const int o = v * A + j - c.off;
      if (o < 0 || o >= c.n) continue;
      const int ch = channel_of(p, first + j);
      y[v * A + j] = from_f<T>(affine(e[j], mean, rstd, to_f(w[ch]), to_f(b[ch]), silu));
    }
  }
}

// Chan's merge of (nb, mb, m2b) into (n, mean, m2); an empty side is the identity.
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const float nt = n + nb, d = mb - mean;
  mean = mean + d * (nb / nt);
  m2 = m2 + m2b + d * d * (n * nb / nt);
  n = nt;
}

// Split regime, warp 0: merges the span's chunk partials in a fixed order
// (lane l merges chunks l, l + 32, ... in turn; then a butterfly in which
// both lanes of a pair merge the lower lane's set with the upper's) and
// leaves the mean and rstd in the header.
__device__ __forceinline__ void merge_partials(const Params& p, int span_id, Header* h) {
  const int lane = threadIdx.x;
  const float* part = p.partials + static_cast<long long>(span_id) * p.parts * 2;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int i = lane; i < p.parts; i += 32) {
    if (i == p.drop) continue;
    chan(n, mean, m2, static_cast<float>(min(p.chunk, p.span - i * p.chunk)), part[2 * i], part[2 * i + 1]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float on = __shfl_xor_sync(0xffffffffu, n, off);
    const float om = __shfl_xor_sync(0xffffffffu, mean, off);
    const float o2 = __shfl_xor_sync(0xffffffffu, m2, off);
    if (lane & off) {  // the other lane's set is the lower one
      float tn = on, tm = om, t2 = o2;
      chan(tn, tm, t2, n, mean, m2);
      n = tn;
      mean = tm;
      m2 = t2;
    } else {
      chan(n, mean, m2, on, om, o2);
    }
  }
  if (lane == 0) {
    h->mean = mean;
    h->rstd = 1.f / sqrtf(m2 / static_cast<float>(p.span) + p.eps);
  }
}

template <typename T, typename W, int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks) group_norm_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  Header* h = reinterpret_cast<Header*>(smem);
  T* buf = reinterpret_cast<T*>(smem + kHeader);
  const int item = kMode == kNormalize ? p.items - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x);
  const int span_id = item / p.parts, part = item % p.parts;
  const int lo = min(part * p.chunk, p.span), hi = min(lo + p.chunk, p.span);
  const Chunk c = make_chunk<T>(static_cast<long long>(span_id) * p.span, lo, hi);

  if (threadIdx.x == 0) {
    for (int i = 0; i < c.pieces; ++i) mbar_init(&h->bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  load_chunk(buf, static_cast<const T*>(p.x), c, h);
  if constexpr (kMode == kNormalize) {
    if (threadIdx.x < 32) merge_partials(p, span_id, h);
  }
  __syncthreads();

  if constexpr (kMode == kStats) {
    const float mean = chunk_reduce(buf, c, h, Identity{}) / static_cast<float>(c.n);
    const float m2 = chunk_reduce(buf, c, h, Centred{mean});
    if (threadIdx.x == 0) {
      p.partials[2 * static_cast<long long>(item)] = mean;
      p.partials[2 * static_cast<long long>(item) + 1] = m2;
    }
    return;
  }
  if constexpr (kMode == kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    const float sum = chunk_reduce(buf, c, h, Identity{});
    if (threadIdx.x == 0) h->slot[0] = sum;
    cluster.sync();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int r = 0; r < p.parts; ++r) {
        if (r != p.drop) total += *cluster.map_shared_rank(&h->slot[0], r);
      }
      h->mean = total / static_cast<float>(p.span);
    }
    __syncthreads();
    const float m2 = chunk_reduce(buf, c, h, Centred{h->mean});
    if (threadIdx.x == 0) h->slot[1] = m2;
    cluster.sync();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int r = 0; r < p.parts; ++r) {
        if (r != p.drop) total += *cluster.map_shared_rank(&h->slot[1], r);
      }
      h->rstd = 1.f / sqrtf(total / static_cast<float>(p.span) + p.eps);
    }
    __syncthreads();
  }
  normalize_store<T, W>(p, buf, c, h, (span_id % p.groups) * p.cpg, h->mean, h->rstd);
  if constexpr (kMode == kCluster) {
    cg::this_cluster().sync();  // no CTA leaves while another may still read its slots
  }
}

template <typename T>
constexpr int smem_bytes(int chunk) {
  return kHeader + static_cast<int>(((chunk + 2 * (16 / sizeof(T))) * sizeof(T) + 15) / 16 * 16);
}

template <typename T, typename W, int kMode>
cudaError_t launch(const Params& p, int smem, int cluster, cudaStream_t stream) {
  auto kernel = group_norm_kernel<T, W, kMode>;
  static uint64_t configured = 0;  // devices on which the shared-memory limit is raised
  cudaError_t err = raise_smem_limit(kernel, kMaxSmem, &configured);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.items, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_regime(const Params& p, bool split, cudaStream_t stream) {
  const int smem = smem_bytes<T>(p.chunk);
  if (smem > kMaxSmem || static_cast<long long>(p.chunk) * sizeof(T) > static_cast<long long>(kMaxPieces) * kPiece) {
    return cudaErrorInvalidValue;
  }
  if (!split) return launch<T, W, kCluster>(p, smem, p.parts, stream);
  const cudaError_t err = launch<T, W, kStats>(p, smem, 1, stream);
  return err != cudaSuccess ? err : launch<T, W, kNormalize>(p, smem, 1, stream);
}

template <typename T>
cudaError_t launch_dtype(const Params& p, bool param_f32, bool split, cudaStream_t stream) {
  return param_f32 ? launch_regime<T, float>(p, split, stream) : launch_regime<T, T>(p, split, stream);
}

}  // namespace

// C interface, bound with ctypes. x and y: contiguous [spans * cpg * hw] of
// dtype 0 = bfloat16, 1 = float16, 2 = float32, both 16-byte aligned; a span
// (cpg * hw elements) below 2^31. w and b: [groups * cpg] of x's type, or f32
// where param_f32. hw_magic and hw_shift: n / hw = (n * hw_magic) >> hw_shift
// for 0 <= n < 2^31. Cluster regime (split = 0): clusters of `parts` CTAs,
// parts a power of two <= 8. Split regime (split = 1): `parts` chunks a span
// and an f32 workspace `partials` of spans * parts * 2. `chunk`: elements a
// CTA, a multiple of 16 bytes. `drop` >= 0 leaves that partial out of the
// merge (a deliberately wrong result for the controls). Returns the launches'
// cudaError_t (cudaErrorInvalidValue for arguments it refuses).
extern "C" int group_norm_fwd(const void* x, const void* w, const void* b, void* y, float* partials,
                              long long spans, int groups, int cpg, int hw, unsigned long long hw_magic,
                              int hw_shift, int dtype, int param_f32, int split, int parts, int chunk, float eps,
                              int silu, int drop, void* stream) {
  const long long span = static_cast<long long>(cpg) * hw;
  const long long items = spans * parts;
  const int elem = dtype == 2 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || span <= 0 || span > 0x7fffffffLL || items <= 0 || items > 0x7fffffffLL ||
      parts <= 0 || chunk <= 0 || (static_cast<long long>(chunk) * elem) % 16 != 0 ||
      static_cast<long long>(parts) * chunk < span || (!split && (parts > 8 || (parts & (parts - 1)))) ||
      (split && partials == nullptr) || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x; p.y = y; p.w = w; p.b = b; p.partials = partials;
  p.hw_magic = hw_magic; p.hw_shift = hw_shift;
  p.span = static_cast<int>(span); p.hw = hw; p.chunk = chunk; p.cpg = cpg; p.groups = groups; p.parts = parts;
  p.items = static_cast<int>(items);
  p.eps = eps; p.silu = silu; p.drop = drop;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dtype<__nv_bfloat16>(p, param_f32 != 0, split != 0, s); break;
    case 1: err = launch_dtype<__half>(p, param_f32 != 0, split != 0, s); break;
    default: err = launch_regime<float, float>(p, split != 0, s); break;
  }
  return static_cast<int>(err);
}
