// Flash-attention forward for Hopper (sm_90a): o = softmax(scale * q k^T + mask) v
// and the per-row logsumexp of the scaled, masked scores.
//
// Replaces the two Pallas TPU forward kernels of edl_tpu/ops/attention.py,
// `_flash_kernel` (whole K/V row in VMEM, launched by `_flash_forward`) and
// `_flash2_kernel` (K/V walk as the innermost grid dimension, launched by
// `_flash2_forward`). On the TPU they are one function split in two by VMEM
// size and by the TPU compiler; here one kernel streams K/V tiles through
// shared memory at any sequence length and serves both.
//
// Contract (the dense reference `attention_reference_with_lse` is the spec):
//   - q [B, H, Tq, D], k/v [B, Hkv, Tk, D] with any element strides on the
//     first three axes and unit stride on D; GQA reads kv head h / (H / Hkv),
//     with no repeat in memory. For bf16 (TMA) the bases are 16-byte aligned
//     and the strides 16-byte multiples (the wrapper copies an operand that
//     is not). o [B, H, Tq, D] in the input type, written with the strides
//     given; lse [B*H, Tq] fp32.
//   - element type bf16 or fp32, head_dim 32, 64 or 128 (templated).
//   - Tq and Tk arbitrary: ragged query rows and keys are masked here, so no
//     shape needs a fallback. Keys past Tk get -inf (p = 0 exactly).
//   - causal mask end-aligned (query row i sees keys j <= i + Tk - Tq) with
//     the finite mask value -1e30, as the reference uses. KV tiles past a
//     query tile's last visible key are skipped; masked entries inside a
//     live tile give p = 0 because the row max comes from real scores.
//   - causal with Tq > Tk: rows with i + Tk - Tq < 0 see no key, and the
//     reference then gives a uniform softmax over ALL Tk keys (the mean of v,
//     lse = -1e30). A query tile holding such a row walks every KV tile, so
//     the online softmax reproduces exactly that (every score is the mask
//     value).
//   - scores, the running max m and sum l, the accumulator and lse in fp32;
//     l clamped at 1e-30; p rounded to the input type before p.v, as the
//     reference casts probabilities to v.dtype.
//   - no atomics: results repeat bit for bit.
//
// Bound at the flagship shape (per launch, causal, B=8, H=16, T=2048, D=64,
// bf16): 4*D*B*H*T(T+1)/2 = 68.7 GFLOP, about 70 us at 989 TFLOP/s (bf16
// tensor cores), against 135 MB of q/k/v/o/lse traffic, about 40 us at
// 3.35 TB/s: compute-bound. The exp is the second limit: one ex2 per score
// on the special-function unit (16 a cycle per SM) takes as long as the two
// products of a score on the tensor cores, so it has to run beside them.
//
// Design of the bf16 body: one warpgroup of 64 query rows per CTA and a
// ring of 64-key K/V slots, 4 of them at head_dim 32 and 64 (at most 168
// registers a thread and 73 KB of shared memory, so that three CTAs share
// an SM) and 2 at 128 (81 KB, two CTAs). Measured fastest on the H100
// against 128-key tiles and two warpgroups a CTA (PERF.md).
//   - Tensor cores through wgmma.mma_async (bf16 in, fp32 accumulate):
//     S = Q K^T as m64nBKk16 with Q and K from swizzled shared tiles, and
//     O += P V with P from registers (the S accumulator, exponentiated and
//     rounded to bf16, is the A operand as it lies) and V as the MN-major B
//     operand of the same tile layout, so nothing is transposed.
//   - Q is loaded once by TMA; K and V tiles stream through a ring of
//     STAGES slots filled by TMA (cp.async.bulk.tensor) and paced by
//     full/empty mbarriers. Thread 0 issues the loads as slots free up: a
//     producer warp would cap every thread's registers (flash_bwd.cu's
//     notes). The tensor maps are encoded on the host per call and passed
//     as __grid_constant__ parameters.
//   - Softmax in the exp2 domain: scores scaled by c = scale * log2(e) in
//     the one FMA that also subtracts the row max, then ex2.approx; lse is
//     written back in the natural log.
//   - Tiles wholly visible to every row of the warpgroup run a body with no
//     per-element test, and take the row max of the raw scores (one scale
//     per row); only tiles that cross the causal diagonal or the ragged Tk
//     edge, or hold rows that see no key, run the masked body.
//   - Overlap inside the warpgroup (FlashAttention-3's intra-warpgroup
//     pipelining): tile t's S and tile t-1's P V are issued together, and
//     the exp of tile t runs while the tensor cores finish P V.
//   - Query tiles are issued longest first under the causal mask.
// What it leaves on the table: each warpgroup still waits for its own S
// before the exp, and only the other CTAs of the SM fill that time; at the
// flagship shape the kernel runs at about a quarter of the tensor-core
// peak, while its products and its exps each need well under a third of
// the time it takes, so latency and not a pipe bounds it (PERF.md). Three
// warpgroups an SM is what 64-key tiles allow (128-key tiles need about
// 196 registers, so two CTAs, and lose on the causal walks); there is no
// producer warpgroup with setmaxnreg and no ping-pong between warpgroups.
// At the served shapes (few CTAs) the longest causal walk of one CTA sets
// the time: the KV walk is not split across CTAs.
//
// fp32 (the small config): fp32 FMAs on the CUDA cores, which is the only
// way to keep full fp32 products (tf32 would round q and k). Each thread
// owns a 4-query x 8-key block of the score tile.

#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using hopper::exp2_approx;
using hopper::Tile;
using hopper::Wgmma;

constexpr float MASK_VALUE = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, group, Tq, Tk, causal, q_offset;
  float scale, c;  // c = scale * log2(e)
  Strides sq, sk, sv, so;
};

// Number of KV tiles of `bk` keys that the `rows` query rows from q0 walk:
// under the causal mask, up to the last visible key of the last row, unless
// one of the rows sees no key.
__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int rows,
                                        int bk) {
  const int nk = (p.Tk + bk - 1) / bk;
  if (p.causal && q0 + p.q_offset >= 0) {
    const int q_last = min(q0 + rows, p.Tq) - 1;
    return min(nk, (q_last + p.q_offset) / bk + 1);
  }
  return nk;
}

// The score of (query row qi, key kk) after the scale and both masks.
__device__ __forceinline__ float masked(const Params& p, float s, int qi,
                                        int kk) {
  if (kk >= p.Tk) return -CUDART_INF_F;
  if (p.causal && kk > qi + p.q_offset) return MASK_VALUE;
  return s * p.scale;
}

// ---------------------------------------------------------------- bf16 ----

// The bf16 body: one warpgroup of 64 query rows per CTA; K/V ring slots of
// BK (64) keys, STAGES of them by head_dim (measured fastest, PERF.md).
constexpr int FWD_THREADS = 128;

template <int D>
struct FwdSmem {
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr uint32_t Q = Tile<D>::bytes(64);
  static constexpr uint32_t STAGE = 2 * Tile<D>::bytes(BK);  // K, V
  // 1024 bytes of alignment slack, Q, the ring, then the barriers: Q's,
  // full[STAGES] and empty[STAGES]
  static constexpr size_t BYTES = 1024 + Q + STAGES * STAGE +
                                  8 * (1 + 2 * STAGES);
};

struct FwdArgs {
  CUtensorMap tq, tk, tv;  // boxes of 64 query rows, BK key rows
  Params p;
};

// The row extreme (max, or min for a negative scale) of this thread's raw
// scores of its two rows, over the quad that shares each row.
template <bool MAX, int N>
__device__ __forceinline__ void row_extreme(const float (&s)[N],
                                            float (&x)[2]) {
  x[0] = s[0];
  x[1] = s[2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    x[r] = MAX ? fmaxf(x[r], s[i]) : fminf(x[r], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int lane = 1; lane < 4; lane <<= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[r], lane);
      x[r] = MAX ? fmaxf(x[r], y) : fminf(x[r], y);
    }
  }
}

// The online softmax of one S tile (keys k0 ..): s becomes p = 2^(x - m)
// with x the scaled, masked score in the log2 domain and m the new running
// row max; l takes the rescaled running sum plus this tile's p, and corr
// the factor the accumulator needs, 2^(m_old - m). Register i of s is row
// rows[(i >> 1) & 1], key k0 + 8 (i >> 2) + 2 tg + (i & 1).
template <int N>
__device__ __forceinline__ void online_softmax(const Params& p, float (&s)[N],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2], bool interior,
                                               const int (&rows)[2], int k0,
                                               int tg) {
  float mx[2];
  if (interior) {
    // every score is visible: the extreme of the raw scores, scaled once
    if (p.c >= 0.f) {
      row_extreme<true>(s, mx);
    } else {
      row_extreme<false>(s, mx);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(m[r], mx[r] * p.c);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = exp2_approx(fmaf(s[i], p.c, -mx[(i >> 1) & 1]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int kk = k0 + 8 * (i >> 2) + 2 * tg + (i & 1);
      s[i] = kk >= p.Tk ? -CUDART_INF_F
             : p.causal && kk > rows[(i >> 1) & 1] + p.q_offset
                 ? MASK_VALUE
                 : s[i] * p.c;
    }
    row_extreme<true>(s, mx);
    // key k0 < Tk scores finite (real or the mask value), so the new max
    // is finite and 2^(-inf - m) = 0 for keys past Tk
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(m[r], mx[r]);
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = exp2_approx(s[i] - mx[(i >> 1) & 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    corr[r] = exp2_approx(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) l[(i >> 1) & 1] += s[i];
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 2)
    flash_fwd_bf16_kernel(const __grid_constant__ FwdArgs args) {
  using S = FwdSmem<D>;
  constexpr int STAGES = S::STAGES;
  const Params& p = args.p;
  unsigned char* sQ = hopper::smem_base();
  unsigned char* ring = sQ + S::Q;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * S::STAGE);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  // under the causal mask the last query tiles walk the most keys: issue
  // them first so they do not trail the launch
  const int q0 = (p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * 64;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.group;
  const int n = kv_tiles(p, q0, 64, BK);  // at least 1: key 0 or no key

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars[0], 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], FWD_THREADS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // thread 0 loads: Q once, then the K, V tile of each step
  const bool leader = threadIdx.x == 0;
  auto load_kv = [&](int kt) HOPPER_INLINE {
    const int st = kt % STAGES;
    hopper::mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
    unsigned char* sK = ring + st * S::STAGE;
    hopper::mbar_expect_tx(&full[st], S::STAGE);
    hopper::tma_tile<D>(sK, &args.tk, &full[st], BK, kt * BK, hk, b);
    hopper::tma_tile<D>(sK + Tile<D>::bytes(BK), &args.tv, &full[st], BK,
                        kt * BK, hk, b);
  };
  if (leader) {
    hopper::mbar_expect_tx(bars, S::Q);
    hopper::tma_tile<D>(sQ, &args.tq, bars, 64, q0, h, b);
    for (int kt = 0; kt < min(STAGES, n); ++kt) load_kv(kt);
  }
  __syncwarp();
  auto ring_k = [&](int kt) HOPPER_INLINE {
    return hopper::smem_u32(ring + kt % STAGES * S::STAGE);
  };
  // every thread of the CTA is done with tile kt: its slot takes tile
  // kt + STAGES
  auto release = [&](int kt) HOPPER_INLINE {
    hopper::mbar_arrive(&empty[kt % STAGES]);
    __syncwarp();
    if (leader && kt + STAGES < n) load_kv(kt + STAGES);
    __syncwarp();
  };

  const int t = threadIdx.x;
  const int tg = t % 4;
  const int rows[2] = {q0 + 16 * (t / 32) + t % 32 / 4,
                       q0 + 16 * (t / 32) + t % 32 / 4 + 8};
  const uint32_t aQ = hopper::smem_u32(sQ);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l[2] = {0.f, 0.f};  // this thread's share of the running sums
  float corr[2];
  float s[BK / 2];
  uint32_t pa[BK / 16][4];  // p (bf16) as the A operand of o += p v
  // no zero fill: the first p v overwrites o (a fill made ptxas serialise
  // the wgmmas of the backward)
  float o[D / 2];

  // S = Q K^T of tile kt into s (one commit group)
  auto issue_s = [&](int kt) HOPPER_INLINE {
    const uint32_t aK = ring_k(kt);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<BK>::ss(s, hopper::desc_k<D>(aQ, 64, kk),
                    hopper::desc_k<D>(aK, BK, kk), kk > 0);
    }
    hopper::wgmma_commit();
  };
  // o (+)= p V of tile kt (one commit group)
  auto issue_pv = [&](int kt) HOPPER_INLINE {
    const uint32_t aV = ring_k(kt) + Tile<D>::bytes(BK);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      Wgmma<D>::rs_t(o, pa[kk], hopper::desc_mn<D>(aV, BK, kk),
                     kt > 0 || kk > 0);
    }
    hopper::wgmma_commit();
  };
  auto wait_full = [&](int kt) HOPPER_INLINE {
    hopper::mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
  };
  auto softmax = [&](int kt) HOPPER_INLINE {
    const int k0 = kt * BK;
    const bool interior =
        k0 + BK <= p.Tk && (!p.causal || q0 + p.q_offset >= k0 + BK - 1);
    online_softmax(p, s, m, l, corr, interior, rows, k0, tg);
  };
  auto pack_p = [&]() HOPPER_INLINE {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hopper::pack_a(pa[kk], s, kk);
  };

  hopper::mbar_wait(bars, 0);
  wait_full(0);
  hopper::wgmma_fence();
  issue_s(0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  softmax(0);
  pack_p();
  for (int kt = 1; kt < n; ++kt) {
    // tile kt's S and tile kt - 1's p V go in together; the exp of tile kt
    // runs while the tensor cores finish p V
    wait_full(kt);
    hopper::wgmma_fence();
    issue_s(kt);
    issue_pv(kt - 1);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    softmax(kt);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    release(kt - 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    pack_p();
  }
  hopper::wgmma_fence();
  issue_pv(n - 1);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
  hopper::fence_regs(pa);
  release(n - 1);

  using bf = __nv_bfloat16;
  bf* out = static_cast<bf*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= p.Tq) continue;
    const float li = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / li;
    bf* orow = out + rows[r] * p.so.t + 2 * tg;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (tg == 0) {
      // a row that sees no key has m = the mask value itself, as the
      // reference's lse (not scaled into the log2 domain)
      const bool no_key = p.causal && rows[r] + p.q_offset < 0;
      p.lse[static_cast<long long>(bh) * p.Tq + rows[r]] =
          (no_key ? MASK_VALUE : m[r] * LN2) + logf(li);
    }
  }
}

// ---------------------------------------------------------------- fp32 ----

constexpr int LDQ = BQ + 4;  // row stride (floats) of sQt [D][LDQ]
constexpr int LDK = BK + 4;  // row stride of sKt [D][LDK]
constexpr int LDP = BQ + 4;  // row stride of sPt [BK][LDP]

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (D * LDQ + D * LDK + BK * D + BK * LDP);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQt = reinterpret_cast<float*>(smem_raw);  // [D][LDQ] q, transposed
  float* sKt = sQt + D * LDQ;     // [D][LDK]  k tile, transposed
  float* sV = sKt + D * LDK;      // [BK][D]   v tile
  float* sPt = sV + BK * D;       // [BK][LDP] p tile, transposed

  constexpr int DC = D / 8;       // output columns per thread
  const int tid = threadIdx.x;
  const int r = tid >> 3;         // rows 4r .. 4r+3 of the tile (16 groups)
  const int c = tid & 7;          // keys 8c .. 8c+7, columns c*DC ..
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.group;

  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;
  float* o = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;

  load_tile_f32_t<D>(sQt, q, p.sq.t, q0, p.Tq, LDQ);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = kv_tiles(p, q0, BQ, BK);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sV / sPt reads are done
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int key = idx / D;
      const int d = idx % D;
      const int kk = k0 + key;
      const bool in = kk < p.Tk;
      sKt[d * LDK + key] = in ? k[kk * p.sk.t + d] : 0.f;
      sV[key * D + d] = in ? v[kk * p.sv.t + d] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;

#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQt[d * LDQ + 4 * r]);
      const float4 ka = *reinterpret_cast<const float4*>(&sKt[d * LDK + 8 * c]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&sKt[d * LDK + 8 * c + 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * r + i;
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = masked(p, s[i][j], qi, k0 + 8 * c + j);
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      const float corr = __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = __expf(s[i][j] - m_new);
        rs += e;
        s[i][j] = e;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(&sPt[(8 * c + j) * LDP + 4 * r]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float4 pa = *reinterpret_cast<const float4*>(&sPt[key * LDP + 4 * r]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j4 = 0; j4 < DC; j4 += 4) {
        const float4 va =
            *reinterpret_cast<const float4*>(&sV[key * D + c * DC + j4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j4 + 0] = fmaf(pv[i], va.x, acc[i][j4 + 0]);
          acc[i][j4 + 1] = fmaf(pv[i], va.y, acc[i][j4 + 1]);
          acc[i][j4 + 2] = fmaf(pv[i], va.z, acc[i][j4 + 2]);
          acc[i][j4 + 3] = fmaf(pv[i], va.w, acc[i][j4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * r + i;
    if (qi < p.Tq) {
      const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        o[qi * p.so.t + c * DC + j] = acc[i][j] / li;
      }
      if (c == 0) {
        p.lse[static_cast<long long>(bh) * p.Tq + qi] = m[i] + logf(li);
      }
    }
  }
}

// ------------------------------------------------------------- launch ----

template <int D>
cudaError_t allow_smem_dtypes() {
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem_bytes_f32<D>());
  if (err != cudaSuccess) return err;
  return allow_smem(flash_fwd_bf16_kernel<D>, FwdSmem<D>::BYTES);
}

template <int D>
cudaError_t launch(int dtype, FwdArgs& a, int B, int Hkv,
                   cudaStream_t stream) {
  const Params& p = a.p;
  if (dtype == 0) {
    const dim3 grid((p.Tq + BQ - 1) / BQ, B * p.H);
    flash_fwd_f32_kernel<D><<<grid, NTHREADS, smem_bytes_f32<D>(), stream>>>(p);
  } else if (dtype == 1) {
    if (!hopper::encode_rows_map(&a.tq, p.q, D, p.Tq, p.H, B, p.sq.t, p.sq.h,
                                 p.sq.b, 64) ||
        !hopper::encode_rows_map(&a.tk, p.k, D, p.Tk, Hkv, B, p.sk.t, p.sk.h,
                                 p.sk.b, BK) ||
        !hopper::encode_rows_map(&a.tv, p.v, D, p.Tk, Hkv, B, p.sv.t, p.sv.h,
                                 p.sv.b, BK)) {
      return cudaErrorInvalidValue;
    }
    const dim3 grid((p.Tq + 63) / 64, B * p.H);
    flash_fwd_bf16_kernel<D><<<grid, FWD_THREADS, FwdSmem<D>::BYTES, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Once per device, before the first launch there: lets every instance of the
// kernel take its dynamic shared memory (the attribute is per device, so it
// stays off the launch path) and finds the driver's tensor-map encoder.
// Returns 0 on success.
extern "C" int edl_flash_fwd_prepare() {
  if (hopper::encode_tiled() == nullptr) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  cudaError_t err = allow_smem_dtypes<32>();
  if (err == cudaSuccess) err = allow_smem_dtypes<64>();
  if (err == cudaSuccess) err = allow_smem_dtypes<128>();
  return static_cast<int>(err);
}

// dtype: 0 = fp32, 1 = bf16. Strides are in elements, for the b, h and t
// axes of each [B, heads, T, D] tensor; for bf16 the q/k/v bases are
// 16-byte aligned and their strides 16-byte multiples. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for bad arguments, or bf16 operands TMA
// cannot map).
extern "C" int edl_flash_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* o, void* lse, int B, int H, int Hkv, int Tq, int Tk,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs a;
  Params& p = a.p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.group = H / Hkv;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.q_offset = Tk - Tq;
  p.scale = scale;
  p.c = scale * 1.4426950408889634f;
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.so = {o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(launch<32>(dtype, a, B, Hkv, s));
    case 64: return static_cast<int>(launch<64>(dtype, a, B, Hkv, s));
    case 128: return static_cast<int>(launch<128>(dtype, a, B, Hkv, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
