// Flash-attention backward for Hopper (sm_90a): dq (kernel K2) and dk/dv
// (kernel K3) of o = softmax(scale * q k^T + mask) v, given dO, the
// forward's per-row logsumexp `lse` and the row correction
// delta = rowsum(dO * o), both fp32:
//   p = exp(scale * s - lse),  dp = dO v^T,  ds = p * (dp - delta),
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO.
//
// Replaces the four Pallas TPU backward kernels of edl_tpu/ops/attention.py:
// `_flash_bwd_dq_kernel` and `_flash2_bwd_dq_kernel` (K2, launched by
// `_flash_backward_kernels` / `_flash2_backward_kernels`) and
// `_flash_bwd_dkv_kernel` and `_flash2_bwd_dkv_kernel` (K3). On the TPU each
// pair is one function split in two by VMEM size and the TPU compiler; here
// one kernel per gradient streams tiles through shared memory at any length.
//
// Contract (the plain version `_block_grads_reference` is the spec):
//   - q, dO [B, H, Tq, D], k/v [B, Hkv, Tk, D] with any element strides on
//     the first three axes and unit stride on D; for bf16 (TMA) the bases
//     are 16-byte aligned and the strides 16-byte multiples (the wrapper
//     copies an operand that is not). dq [B, H, Tq, D], dk/dv
//     [B, Hkv, Tk, D] are written with the strides given.
//   - `lse` and `delta` are [B*H, t_pad] fp32 rows, t_pad a multiple of 128
//     and at least Tq, zero past Tq; lse comes multiplied by log2(e), so
//     p = exp2(s c - lse) with c = scale log2(e).
//   - element type bf16 or fp32, head_dim 32, 64 or 128 (templated).
//   - causal mask end-aligned (row i sees keys j <= i + Tk - Tq). A masked
//     entry has p = 0 and ds = 0 (the reference's masked_fill passes no
//     gradient); keys past Tk and rows past Tq have p = 0 exactly. A causal
//     row that sees no key (Tq > Tk, i + Tk - Tq < 0) had a uniform softmax
//     over all Tk keys: p = 1/Tk and ds = 0, so it adds dO/Tk to EVERY key's
//     dv and nothing to dq or dk. This is decided from the positions, not
//     from lse (lse = -1e30 there, and exp(s - lse) would give 1, not 1/Tk).
//   - GQA: K3 walks the g query heads of its kv head inside one CTA, so
//     dk/dv come out at the grouped width with no atomics and no full-width
//     buffer (equal to the full-width result summed over each group).
//   - no atomics anywhere: results repeat bit for bit from run to run.
//
// Bound at the flagship shape (per launch, causal, B=8, H=16, T=2048, D=64,
// bf16): K2 does 3 products of 2*D flops per visible pair (S, dP, dq):
// 6*D*B*H*T(T+1)/2 = 103 GFLOP, about 0.10 ms at 989 TFLOP/s; K3 does 4
// (S, dP, dv, dk): 137 GFLOP, 0.14 ms. Each reads q, k, v, dO (bf16) and
// lse, delta (fp32) and writes one or two [.., T, D] bf16 tensors, about
// 135 MB (40 us): compute-bound, so the design is about feeding the tensor
// cores.
//
// Design of the bf16 bodies: one warpgroup per CTA owning 64 rows (K2:
// query rows, K3: keys), two CTAs per SM.
//   - Tensor cores through wgmma.mma_async (m64nNk16, bf16 in, fp32
//     accumulate). Q, dO, K and V tiles sit in shared memory in the swizzle
//     TMA writes and wgmma reads through descriptors (hopper.cuh); one tile
//     serves as a K-major operand (S = Q K^T) and as an MN-major one
//     (dQ += dS K), so nothing is transposed or reloaded. P, dS and their
//     transposes never leave registers: the accumulator rounded to bf16 is
//     the register A operand of the next product.
//   - A ring of STAGES tiles filled by TMA (cp.async.bulk.tensor), issued
//     by thread 0 as soon as a slot is free; full/empty mbarriers pace it.
//     The tensor maps are encoded on the host for each call
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so no
//     -lcuda) and passed as __grid_constant__ parameters. K2's ring holds K
//     and V per key tile; K3's holds Q, dO and, by 1-D bulk copies, lse and
//     delta per query tile.
//   - A software pipeline (`pipeline` below): a tile's accumulation runs
//     on while the warpgroup waits for the next tile's S and dP, issued
//     behind it; the two CTAs of an SM fill each other's exp time.
//   - The resident operand is loaded once: K2's Q and dO rows (their lse
//     and delta in registers), K3's K and V rows. K3's dK and dV
//     accumulators stay in registers across the whole walk, GQA group
//     included.
//   - Tiles wholly visible run a body with no per-element test; only tiles
//     that cross the causal diagonal, the ragged Tq / Tk edge, or hold rows
//     that see no key run the masked body.
//   - Longest walks first: K2 issues query tiles last to first under the
//     causal mask, K3 key tiles first to last. Each CTA writes its rows of
//     dq, or of dk/dv, once, from registers into the strided outputs.
// What it leaves on the table: each warpgroup runs a serial chain per tile
// (S and dP, wait, exp, accumulation), and the accumulation products cost
// several times their tensor-core time in it (dropping them, for timing
// only, more than halves either kernel); S and dP are computed in both
// kernels (a fused backward needs atomics or a second pass for dq).
//
// fp32 (the small config): the same walks with fp32 FMAs on the CUDA cores
// (tf32 would round q and k); each thread owns a 4-row x 8-column block of
// the score tile.

#include <math_constants.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using hopper::exp2_approx;
using hopper::smem_base;
using hopper::Tile;
using hopper::Wgmma;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, t_pad]: lse * log2(e)
  const float* delta;  // [B*H, t_pad]
  void* out0;          // dq (K2) or dk (K3)
  void* out1;          // dv (K3)
  int H, Hkv, group, Tq, Tk, causal, q_offset, t_pad;
  float scale, c;  // c = scale * log2(e)
  Strides sq, sk, sv, sdo, s0, s1;
};

// p and ds of (query row qi, key kk) from the raw score s and dp, with the
// masks; lse2 is the row's lse * log2(e).
__device__ __forceinline__ void grad_entry(const Params& p, float s, float dp,
                                           int qi, int kk, float lse2,
                                           float delta, float& pe, float& ds) {
  pe = 0.f;
  ds = 0.f;
  if (kk >= p.Tk || qi >= p.Tq) return;
  if (p.causal) {
    const int last = qi + p.q_offset;  // the row's last visible key
    if (last < 0) {                    // sees no key: uniform softmax
      pe = 1.f / p.Tk;
      return;
    }
    if (kk > last) return;
  }
  pe = exp2_approx(fmaf(s, p.c, -lse2));
  ds = pe * (dp - delta);
}

// Key tiles (of bk) query tile [q0, q0 + bq) walks for dq: up to the last
// visible key of its last row (none if that row sees no key).
__device__ __forceinline__ int dq_kv_tiles(const Params& p, int q0, int bq,
                                           int bk) {
  const int nk = (p.Tk + bk - 1) / bk;
  if (!p.causal) return nk;
  const int last = min(q0 + bq, p.Tq) - 1 + p.q_offset;
  return last < 0 ? 0 : min(nk, last / bk + 1);
}

// Query tiles (of bq) key tile k0 skips for dk/dv: [nokey, lower) see none
// of its keys. Tiles below `nokey` hold rows that see no key at all (they
// add to every key's dv); tiles from `lower` on hold rows that see key k0.
__device__ __forceinline__ void dkv_q_range(const Params& p, int k0, int bq,
                                            int& nokey, int& lower) {
  nokey = 0;
  lower = 0;
  if (!p.causal) return;
  if (p.q_offset < 0) nokey = (-p.q_offset + bq - 1) / bq;
  lower = max(0, (k0 - p.q_offset) / bq);
}

// ---------------------------------------------------------------- bf16 ----

// One warpgroup per CTA: 64 rows (K2: query rows, K3: keys). There is no
// producer warp: ptxas sizes every thread's registers to the launch bound,
// and on each SM sub-partition (a quarter of the register file) a fifth
// warp beside a warpgroup costs as much as a whole producer warpgroup does,
// capping the threads at 168 registers; setmaxnreg did not lift that cap
// (ptxas allocated to the launch bound either way). So thread 0 issues the
// loads, and the warpgroup keeps up to 255 registers a thread with two
// CTAs on an SM.
constexpr int THREADS = 128;
constexpr int CTAS = 2;    // CTAs per SM the registers are sized for
constexpr int STAGES = 3;  // tile t computes while tiles t + 1, t + 2 load
// Ring tile rows (K2: keys, K3: queries) at every head_dim: 32 and 128
// measured slower at D 64 and D 128 on the H100, and N 64 keeps the S and
// dP accumulators at 32 registers each.
constexpr int BN = 64;

struct BwdArgs {
  CUtensorMap tq, tk, tv, tdo;  // tile maps (box rows per kernel)
  Params p;
};

constexpr uint32_t round_1k(uint32_t n) { return (n + 1023) / 1024 * 1024; }

template <int D>
struct DqSmem {
  static constexpr uint32_t RES = 2 * Tile<D>::bytes(64);    // Q, dO
  static constexpr uint32_t STAGE = 2 * Tile<D>::bytes(BN);  // K, V
  static constexpr size_t BYTES = 1024 + RES + STAGES * STAGE + 64;
};

template <int D>
struct DkvSmem {
  static constexpr uint32_t RES = 2 * Tile<D>::bytes(64);    // K, V
  static constexpr uint32_t TILES = 2 * Tile<D>::bytes(BN);  // Q, dO
  static constexpr uint32_t STAGE = round_1k(TILES + 2 * 4 * BN);  // + rows
  static constexpr size_t BYTES = 1024 + RES + STAGES * STAGE + 64;
};

// Barriers after the tiles: the resident tiles', then full[STAGES] (the
// loads, one arrival with their bytes) and empty[STAGES] (every thread).
__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars[0], 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&bars[1 + s], 1);
      hopper::mbar_init(&bars[1 + STAGES + s], THREADS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// C = A B^T over head_dim for two products at once (S and dP), A the
// resident 64-row tile and B a ring tile, both K-major: one commit group.
template <int D>
__device__ __forceinline__ void issue_pair(float (&c0)[BN / 2],
                                           float (&c1)[BN / 2], uint32_t a0,
                                           uint32_t b0, uint32_t a1,
                                           uint32_t b1) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    Wgmma<BN>::ss(c0, hopper::desc_k<D>(a0, 64, kk),
                  hopper::desc_k<D>(b0, BN, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    Wgmma<BN>::ss(c1, hopper::desc_k<D>(a1, 64, kk),
                  hopper::desc_k<D>(b1, BN, kk), kk > 0);
  }
  hopper::wgmma_commit();
}

// The software pipeline both kernels run over their n ring tiles.
// `issue(t, s, dp)` issues tile t's S and dP products, `body(t, s, dp)`
// takes p and ds of tile t (exp and masks, on the CUDA cores) and issues
// its accumulation (K2: dq += ds k; K3: dv += p^T dO, dk += ds^T q), and
// `release(t)` frees tile t's slot (which loads tile t + STAGES into it).
// A tile's accumulation is not waited for until the next tile's S and dP
// are issued behind it, so the tensor cores run the two back to back.
// Finer schedules measured slower on the H100: S and dP of tile t + 1 in a
// second register set under the exp of tile t (ptxas serialised the wgmmas
// of K2; K3 ran out of registers at D 64 and lost time at 32-row tiles);
// S and dP, or dv and dk, as separate commit groups so that the exp or ds
// overlaps the other product (each extra wait cost more than it hid); two
// warpgroups per CTA taking turns through named barriers.
template <int N, typename Issue, typename Release, typename Body>
__device__ __forceinline__ void pipeline(int n, Issue&& issue,
                                         Release&& release, Body&& body) {
  float s[N], dp[N];
  for (int t = 0; t < n; ++t) {
    issue(t, s, dp);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    if (t > 0) release(t - 1);
    body(t, s, dp);
  }
  hopper::wgmma_wait<0>();
  release(n - 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, CTAS)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ BwdArgs args) {
  using S = DqSmem<D>;
  const Params& p = args.p;
  unsigned char* sQ = smem_base();
  unsigned char* sDO = sQ + Tile<D>::bytes(64);
  unsigned char* ring = sQ + S::RES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * S::STAGE);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  // under the causal mask the last query tiles walk the most keys
  const int q0 = (p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * 64;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.group;
  const int n_tiles = dq_kv_tiles(p, q0, 64, BN);
  init_barriers(bars);

  // thread 0 loads: Q and dO once, then the K, V tile of each step
  const bool leader = threadIdx.x == 0;
  auto load_kv = [&](int kt) HOPPER_INLINE {
    const int st = kt % STAGES;
    hopper::mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
    unsigned char* sK = ring + st * S::STAGE;
    hopper::mbar_expect_tx(&full[st], S::STAGE);
    hopper::tma_tile<D>(sK, &args.tk, &full[st], BN, kt * BN, hk, b);
    hopper::tma_tile<D>(sK + Tile<D>::bytes(BN), &args.tv, &full[st], BN,
                        kt * BN, hk, b);
  };
  if (leader && n_tiles > 0) {
    hopper::mbar_expect_tx(bars, S::RES);
    hopper::tma_tile<D>(sQ, &args.tq, bars, 64, q0, h, b);
    hopper::tma_tile<D>(sDO, &args.tdo, bars, 64, q0, h, b);
    for (int kt = 0; kt < min(STAGES, n_tiles); ++kt) load_kv(kt);
  }
  __syncwarp();

  using bf = __nv_bfloat16;
  const int warp = threadIdx.x / 32;
  const int tg = threadIdx.x % 4;
  const int rows[2] = {q0 + 16 * warp + threadIdx.x % 32 / 4,
                       q0 + 16 * warp + threadIdx.x % 32 / 4 + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = static_cast<long long>(bh) * p.t_pad + rows[r];
    lse2[r] = p.lse[at];
    dl[r] = p.delta[at];
  }
  // no zero fill: the first tile overwrites acc (a fill made ptxas
  // serialise the wgmmas); a CTA that walks no tile writes zeros
  float acc[D / 2];
  const uint32_t aQ = hopper::smem_u32(sQ), aDO = hopper::smem_u32(sDO);
  auto ring_k = [&](int kt) HOPPER_INLINE {
    return hopper::smem_u32(ring + kt % STAGES * S::STAGE);
  };

  if (n_tiles > 0) {
    hopper::mbar_wait(bars, 0);
    // S = Q K^T and dP = dO V^T of key tile kt
    auto issue = [&](int kt, float (&s)[BN / 2],
                       float (&dp)[BN / 2]) HOPPER_INLINE {
      hopper::mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
      const uint32_t aK = ring_k(kt);
      issue_pair<D>(s, dp, aQ, aK, aDO, aK + Tile<D>::bytes(BN));
    };
    uint32_t da[BN / 16][4];  // ds as the A operand of dq += ds k
    // called once tile kt's products are done: their register operands
    // may be reused from here on
    auto release = [&](int kt) HOPPER_INLINE {
      hopper::fence_regs(da);
      hopper::mbar_arrive(&empty[kt % STAGES]);
      __syncwarp();
      if (leader && kt + STAGES < n_tiles) load_kv(kt + STAGES);
      __syncwarp();
    };
    auto body = [&](int kt, float (&s)[BN / 2],
                      float (&dp)[BN / 2]) HOPPER_INLINE {
      const int k0 = kt * BN;
      // register i: row rows[(i >> 1) & 1], key k0 + 8 (i >> 2) + 2 tg + (i & 1)
      if (k0 + BN <= p.Tk && (!p.causal || q0 + p.q_offset >= k0 + BN - 1)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i >> 1) & 1;
          dp[i] = exp2_approx(fmaf(s[i], p.c, -lse2[r])) * (dp[i] - dl[r]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i >> 1) & 1;
          float pe;
          grad_entry(p, s[i], dp[i], rows[r],
                     k0 + 8 * (i >> 2) + 2 * tg + (i & 1), lse2[r], dl[r], pe,
                     dp[i]);
        }
      }
      // dq += ds k: ds (bf16) from registers, k MN-major from the ring
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) hopper::pack_a(da[kk], dp, kk);
      hopper::wgmma_fence();
      const uint32_t aK = ring_k(kt);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        Wgmma<D>::rs_t(acc, da[kk], hopper::desc_mn<D>(aK, BN, kk),
                       kt > 0 || kk > 0);
      }
      hopper::wgmma_commit();
    };
    pipeline<BN / 2>(n_tiles, issue, release, body);
    hopper::fence_regs(acc);
  }

  bf* dq = static_cast<bf*>(p.out0) + b * p.s0.b + h * p.s0.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Tq) continue;
    bf* row = dq + rows[r] * p.s0.t + 2 * tg;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          n_tiles > 0 ? __floats2bfloat162_rn(acc[4 * j + 2 * r] * p.scale,
                                              acc[4 * j + 2 * r + 1] * p.scale)
                      : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, CTAS)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ BwdArgs args) {
  using S = DkvSmem<D>;
  const Params& p = args.p;
  unsigned char* sK = smem_base();
  unsigned char* sV = sK + Tile<D>::bytes(64);
  unsigned char* ring = sK + S::RES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * S::STAGE);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int k0 = blockIdx.x * 64;  // causal: the first key tiles walk most
  const int b = blockIdx.y / p.Hkv;
  const int hk = blockIdx.y % p.Hkv;
  const int nq = (p.Tq + BN - 1) / BN;
  int nokey, lower;
  dkv_q_range(p, k0, BN, nokey, lower);
  lower = max(lower, nokey);
  // the walk, for each query head of the group: tiles [0, nokey), then
  // [lower, nq); step `it` is tile tile_of(it) of head it / per_head
  const int per_head = nokey + nq - lower;
  const int n_steps = p.group * per_head;
  auto tile_of = [&](int it) HOPPER_INLINE {
    const int n = it % per_head;
    return n < nokey ? n : lower + n - nokey;
  };
  init_barriers(bars);

  // thread 0 loads: K and V once, then each step's Q, dO, lse and delta
  const bool leader = threadIdx.x == 0;
  auto load_q = [&](int it) HOPPER_INLINE {
    const int h = hk * p.group + it / per_head;
    const int q0 = tile_of(it) * BN;
    const long long row = (static_cast<long long>(b) * p.H + h) * p.t_pad + q0;
    const int st = it % STAGES;
    hopper::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
    unsigned char* sQ = ring + st * S::STAGE;
    float* sL = reinterpret_cast<float*>(sQ + S::TILES);
    hopper::mbar_expect_tx(&full[st], S::TILES + 2 * 4 * BN);
    hopper::tma_tile<D>(sQ, &args.tq, &full[st], BN, q0, h, b);
    hopper::tma_tile<D>(sQ + Tile<D>::bytes(BN), &args.tdo, &full[st], BN,
                        q0, h, b);
    hopper::bulk_load(sL, p.lse + row, 4 * BN, &full[st]);
    hopper::bulk_load(sL + BN, p.delta + row, 4 * BN, &full[st]);
  };
  if (leader) {
    hopper::mbar_expect_tx(bars, S::RES);
    hopper::tma_tile<D>(sK, &args.tk, bars, 64, k0, hk, b);
    hopper::tma_tile<D>(sV, &args.tv, bars, 64, k0, hk, b);
    for (int it = 0; it < min(STAGES, n_steps); ++it) load_q(it);
  }
  __syncwarp();

  using bf = __nv_bfloat16;
  const int warp = threadIdx.x / 32;
  const int tg = threadIdx.x % 4;
  const int keys[2] = {k0 + 16 * warp + threadIdx.x % 32 / 4,
                       k0 + 16 * warp + threadIdx.x % 32 / 4 + 8};
  // no zero fill: the first step overwrites them (a fill here made ptxas
  // serialise every wgmma of the kernel)
  float dk[D / 2], dv[D / 2];
  const uint32_t aK = hopper::smem_u32(sK), aV = hopper::smem_u32(sV);
  auto ring_q = [&](int it) HOPPER_INLINE {
    return hopper::smem_u32(ring + it % STAGES * S::STAGE);
  };

  hopper::mbar_wait(bars, 0);
  // S^T = K Q^T and dP^T = V dO^T of step it (rows: keys, columns: queries)
  auto issue = [&](int it, float (&s)[BN / 2],
                     float (&dp)[BN / 2]) HOPPER_INLINE {
    hopper::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    const uint32_t aQ = ring_q(it);
    issue_pair<D>(s, dp, aK, aQ, aV, aQ + Tile<D>::bytes(BN));
  };
  // p^T and ds^T as the A operands of dv += p^T dO and dk += ds^T q
  uint32_t pa[BN / 16][4], da[BN / 16][4];
  // called once step it's products are done: their register operands may
  // be reused from here on
  auto release = [&](int it) HOPPER_INLINE {
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    hopper::mbar_arrive(&empty[it % STAGES]);
    __syncwarp();
    if (leader && it + STAGES < n_steps) load_q(it + STAGES);
    __syncwarp();
  };
  auto body = [&](int it, float (&s)[BN / 2],
                    float (&dp)[BN / 2]) HOPPER_INLINE {
    const int q0 = tile_of(it) * BN;
    const uint32_t aQ = ring_q(it);
    const float* sL = reinterpret_cast<const float*>(
        ring + it % STAGES * S::STAGE + S::TILES);
    const float* sD = sL + BN;
    // register 4 c + e: key keys[(e >> 1) & 1], query q0 + 8 c + 2 tg +
    // (e & 1). p^T and ds^T go straight into the A operands (bf16) of
    // dv += p^T dO and dk += ds^T q: registers 4 c .. 4 c + 3 are
    // a[2 (c & 1)], a[2 (c & 1) + 1] of k-step c / 2 (hopper::pack_a).
    if (q0 + BN <= p.Tq && k0 + 64 <= p.Tk &&
        (!p.causal || q0 + p.q_offset >= k0 + 63)) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * c + 2 * tg);
        const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * c + 2 * tg);
        float pe[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pe[e] = exp2_approx(fmaf(s[4 * c + e], p.c, -((e & 1) ? l2.y : l2.x)));
          ds[e] = pe[e] * (dp[4 * c + e] - ((e & 1) ? d2.y : d2.x));
        }
        pa[c / 2][2 * (c & 1)] = hopper::pack_bf16(pe[0], pe[1]);
        pa[c / 2][2 * (c & 1) + 1] = hopper::pack_bf16(pe[2], pe[3]);
        da[c / 2][2 * (c & 1)] = hopper::pack_bf16(ds[0], ds[1]);
        da[c / 2][2 * (c & 1) + 1] = hopper::pack_bf16(ds[2], ds[3]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * c + 2 * tg);
        const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * c + 2 * tg);
        float pe[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          grad_entry(p, s[4 * c + e], dp[4 * c + e],
                     q0 + 8 * c + 2 * tg + (e & 1), keys[(e >> 1) & 1],
                     (e & 1) ? l2.y : l2.x, (e & 1) ? d2.y : d2.x, pe[e],
                     ds[e]);
        }
        pa[c / 2][2 * (c & 1)] = hopper::pack_bf16(pe[0], pe[1]);
        pa[c / 2][2 * (c & 1) + 1] = hopper::pack_bf16(pe[2], pe[3]);
        da[c / 2][2 * (c & 1)] = hopper::pack_bf16(ds[0], ds[1]);
        da[c / 2][2 * (c & 1) + 1] = hopper::pack_bf16(ds[2], ds[3]);
      }
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      Wgmma<D>::rs_t(dv, pa[kk],
                     hopper::desc_mn<D>(aQ + Tile<D>::bytes(BN), BN, kk),
                     it > 0 || kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      Wgmma<D>::rs_t(dk, da[kk], hopper::desc_mn<D>(aQ, BN, kk),
                     it > 0 || kk > 0);
    }
    hopper::wgmma_commit();
  };
  pipeline<BN / 2>(n_steps, issue, release, body);
  hopper::fence_regs(dv);
  hopper::fence_regs(dk);

  bf* dk_out = static_cast<bf*>(p.out0) + b * p.s0.b + hk * p.s0.h;
  bf* dv_out = static_cast<bf*>(p.out1) + b * p.s1.b + hk * p.s1.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.Tk) continue;
    bf* krow = dk_out + keys[r] * p.s0.t + 2 * tg;
    bf* vrow = dv_out + keys[r] * p.s1.t + 2 * tg;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) = __floats2bfloat162_rn(
          dk[4 * j + 2 * r] * p.scale, dk[4 * j + 2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- fp32 ----
//
// Thread (r, c) = (tid >> 3, tid & 7) owns rows 4r..4r+3 and columns
// 8c..8c+7 of the 64 x 64 score tile, and output columns c + 8 j of its
// four rows (interleaved, so that column reads of a transposed tile hit
// distinct banks).

constexpr int LDT = 64 + 4;  // row stride (floats) of a transposed tile [D][LDT]
constexpr int LDP = 64 + 4;  // row stride of a score tile [64][LDP]

template <int D>
constexpr size_t smem_bytes_dq_f32() {
  return sizeof(float) * (4 * D * LDT + BK * LDP);
}

template <int D>
constexpr size_t smem_bytes_dkv_f32() {
  return sizeof(float) * (4 * D * LDT + 2 * BQ * LDP + 2 * BQ);
}

// s[i][j] = sum_d a[d][4r + i] * b[d][8c + j] over two transposed tiles.
template <int D>
__device__ __forceinline__ void tile_product_f32(float (&s)[4][8],
                                                 const float* a,
                                                 const float* b, int r,
                                                 int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(&a[d * LDT + 4 * r]);
    const float4 y0 = *reinterpret_cast<const float4*>(&b[d * LDT + 8 * c]);
    const float4 y1 = *reinterpret_cast<const float4*>(&b[d * LDT + 8 * c + 4]);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_f32_kernel(Params p) {
  constexpr int DC = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQt = reinterpret_cast<float*>(smem_raw);  // [D][LDT]
  float* sDOt = sQt + D * LDT;
  float* sKt = sDOt + D * LDT;
  float* sVt = sKt + D * LDT;
  float* sDS = sVt + D * LDT;  // [key][LDP]: ds transposed

  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.group;

  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;
  float* dq = static_cast<float*>(p.out0) + b * p.s0.b + h * p.s0.h;

  load_tile_f32_t<D>(sQt, q, p.sq.t, q0, p.Tq, LDT);
  load_tile_f32_t<D>(sDOt, dout, p.sdo.t, q0, p.Tq, LDT);
  float lse[4], delta[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * r + i;
    const long long row = static_cast<long long>(bh) * p.t_pad + qi;
    lse[i] = qi < p.Tq ? p.lse[row] : 0.f;
    delta[i] = qi < p.Tq ? p.delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = dq_kv_tiles(p, q0, BQ, BK);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sKt / sDS reads are done
    load_tile_f32_t<D>(sKt, k, p.sk.t, k0, p.Tk, LDT);
    load_tile_f32_t<D>(sVt, v, p.sv.t, k0, p.Tk, LDT);
    __syncthreads();

    float s[4][8], dp[4][8];
    tile_product_f32<D>(s, sQt, sKt, r, c);
    tile_product_f32<D>(dp, sDOt, sVt, r, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pe;
        grad_entry(p, s[i][j], dp[i][j], q0 + 4 * r + i, k0 + 8 * c + j,
                   lse[i], delta[i], pe, ds[i]);
      }
      *reinterpret_cast<float4*>(&sDS[(8 * c + j) * LDP + 4 * r]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dq[row][c + 8 j] += sum_key ds[row][key] * k[key][c + 8 j]
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float4 da = *reinterpret_cast<const float4*>(&sDS[key * LDP + 4 * r]);
      const float dv4[4] = {da.x, da.y, da.z, da.w};
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kv = sKt[(c + 8 * j) * LDT + key];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dv4[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * r + i;
    if (qi >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) dq[qi * p.s0.t + c + 8 * j] = acc[i][j] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_f32_kernel(Params p) {
  constexpr int DC = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sKt = reinterpret_cast<float*>(smem_raw);  // [D][LDT]
  float* sVt = sKt + D * LDT;
  float* sQt = sVt + D * LDT;
  float* sDOt = sQt + D * LDT;
  float* sP = sDOt + D * LDT;  // [query][LDP]: p^T, keys contiguous
  float* sDS = sP + BQ * LDP;  // [query][LDP]: ds^T
  float* sLse = sDS + BQ * LDP;
  float* sDelta = sLse + BQ;

  const int tid = threadIdx.x;
  const int r = tid >> 3;  // keys 4r .. 4r+3
  const int c = tid & 7;   // queries 8c .. 8c+7; columns c + 8 j
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / p.Hkv;
  const int hk = blockIdx.y % p.Hkv;

  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;
  float* dk_out = static_cast<float*>(p.out0) + b * p.s0.b + hk * p.s0.h;
  float* dv_out = static_cast<float*>(p.out1) + b * p.s1.b + hk * p.s1.h;

  load_tile_f32_t<D>(sKt, k, p.sk.t, k0, p.Tk, LDT);
  load_tile_f32_t<D>(sVt, v, p.sv.t, k0, p.Tk, LDT);
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (p.Tq + BQ - 1) / BQ;
  int nokey, lower;
  dkv_q_range(p, k0, BQ, nokey, lower);
  for (int jh = 0; jh < p.group; ++jh) {
    const int h = hk * p.group + jh;
    const long long bh = static_cast<long long>(b) * p.H + h;
    const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
    const float* dout =
        static_cast<const float*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
    for (int t = 0; t < nq; ++t) {
      if (t >= nokey && t < lower) t = lower;
      if (t >= nq) break;
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's reads are done
      load_tile_f32_t<D>(sQt, q, p.sq.t, q0, p.Tq, LDT);
      load_tile_f32_t<D>(sDOt, dout, p.sdo.t, q0, p.Tq, LDT);
      if (tid < BQ) {
        const int qi = q0 + tid;
        sLse[tid] = qi < p.Tq ? p.lse[bh * p.t_pad + qi] : 0.f;
        sDelta[tid] = qi < p.Tq ? p.delta[bh * p.t_pad + qi] : 0.f;
      }
      __syncthreads();

      float s[4][8], dp[4][8];  // [key 4r + i][query 8c + j]
      tile_product_f32<D>(s, sKt, sQt, r, c);
      tile_product_f32<D>(dp, sVt, sDOt, r, c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qq = 8 * c + j;
        float pe[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          grad_entry(p, s[i][j], dp[i][j], q0 + qq, k0 + 4 * r + i,
                     sLse[qq], sDelta[qq], pe[i], ds[i]);
        }
        *reinterpret_cast<float4*>(&sP[qq * LDP + 4 * r]) =
            make_float4(pe[0], pe[1], pe[2], pe[3]);
        *reinterpret_cast<float4*>(&sDS[qq * LDP + 4 * r]) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

      // dv[key][c + 8 j] += p^T dO, dk[key][c + 8 j] += ds^T q
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        const float4 pa = *reinterpret_cast<const float4*>(&sP[qq * LDP + 4 * r]);
        const float4 da = *reinterpret_cast<const float4*>(&sDS[qq * LDP + 4 * r]);
        const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
        const float dsv[4] = {da.x, da.y, da.z, da.w};
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float dov = sDOt[(c + 8 * j) * LDT + qq];
          const float qv = sQt[(c + 8 * j) * LDT + qq];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(pv[i], dov, dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + 4 * r + i;
    if (kk >= p.Tk) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk_out[kk * p.s0.t + c + 8 * j] = dk[i][j] * p.scale;
      dv_out[kk * p.s1.t + c + 8 * j] = dv[i][j];
    }
  }
}

// ------------------------------------------------------------- launch ----

template <int D>
cudaError_t allow_smem_all() {
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, DqSmem<D>::BYTES);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, DkvSmem<D>::BYTES);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_f32_kernel<D>, smem_bytes_dq_f32<D>());
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dkv_f32_kernel<D>, smem_bytes_dkv_f32<D>());
  return err;
}

// The four tile maps of a bf16 launch: q and dO with boxes of `q_rows`
// rows, k and v of `k_rows`.
bool encode_maps(BwdArgs& a, int D, int B, int q_rows, int k_rows) {
  const Params& p = a.p;
  return hopper::encode_rows_map(&a.tq, p.q, D, p.Tq, p.H, B, p.sq.t, p.sq.h,
                                 p.sq.b, q_rows) &&
         hopper::encode_rows_map(&a.tdo, p.dout, D, p.Tq, p.H, B, p.sdo.t,
                                 p.sdo.h, p.sdo.b, q_rows) &&
         hopper::encode_rows_map(&a.tk, p.k, D, p.Tk, p.Hkv, B, p.sk.t,
                                 p.sk.h, p.sk.b, k_rows) &&
         hopper::encode_rows_map(&a.tv, p.v, D, p.Tk, p.Hkv, B, p.sv.t,
                                 p.sv.h, p.sv.b, k_rows);
}

template <int D>
cudaError_t launch(int which, int dtype, BwdArgs& a, int B,
                   cudaStream_t stream) {
  const Params& p = a.p;
  if (dtype == 0) {
    if (which == 0) {
      const dim3 grid((p.Tq + BQ - 1) / BQ, B * p.H);
      flash_bwd_dq_f32_kernel<D><<<grid, NTHREADS, smem_bytes_dq_f32<D>(), stream>>>(p);
    } else {
      const dim3 grid((p.Tk + BK - 1) / BK, B * p.Hkv);
      flash_bwd_dkv_f32_kernel<D><<<grid, NTHREADS, smem_bytes_dkv_f32<D>(), stream>>>(p);
    }
  } else if (dtype == 1) {
    if (which == 0) {
      using S = DqSmem<D>;
      if (!encode_maps(a, D, B, 64, BN)) return cudaErrorInvalidValue;
      const dim3 grid((p.Tq + 63) / 64, B * p.H);
      flash_bwd_dq_bf16_kernel<D><<<grid, THREADS, S::BYTES, stream>>>(a);
    } else {
      using S = DkvSmem<D>;
      if (!encode_maps(a, D, B, BN, 64)) return cudaErrorInvalidValue;
      const dim3 grid((p.Tk + 63) / 64, B * p.Hkv);
      flash_bwd_dkv_bf16_kernel<D><<<grid, THREADS, S::BYTES, stream>>>(a);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int run(int which, int dtype, int head_dim, const void* q, const void* k,
        const void* v, const void* dout, const void* lse, const void* delta,
        void* out0, void* out1, int B, int H, int Hkv, int Tq, int Tk,
        const long long* st, int causal, float scale, int t_pad,
        void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0 ||
      t_pad < Tq || t_pad % 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a;
  Params& p = a.p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
  p.H = H;
  p.Hkv = Hkv;
  p.group = H / Hkv;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.q_offset = Tk - Tq;
  p.t_pad = t_pad;
  p.scale = scale;
  p.c = scale * 1.4426950408889634f;
  p.sq = {st[0], st[1], st[2]};
  p.sk = {st[3], st[4], st[5]};
  p.sv = {st[6], st[7], st[8]};
  p.sdo = {st[9], st[10], st[11]};
  p.s0 = {st[12], st[13], st[14]};
  p.s1 = {st[15], st[16], st[17]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(launch<32>(which, dtype, a, B, s));
    case 64: return static_cast<int>(launch<64>(which, dtype, a, B, s));
    case 128: return static_cast<int>(launch<128>(which, dtype, a, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Once per device, before the first launch there: lets every instance of
// both kernels take its dynamic shared memory, and finds the driver's
// tensor-map encoder. Returns 0 on success.
extern "C" int edl_flash_bwd_prepare() {
  if (hopper::encode_tiled() == nullptr) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  cudaError_t err = allow_smem_all<32>();
  if (err == cudaSuccess) err = allow_smem_all<64>();
  if (err == cudaSuccess) err = allow_smem_all<128>();
  return static_cast<int>(err);
}

// dtype: 0 = fp32, 1 = bf16. `st` holds 18 element strides: the b, h and t
// axes of q, k, v, dO and the outputs (dq; or dk then dv). lse and delta
// are [B*H, t_pad] fp32 rows (lse times log2(e), zero pad; t_pad a
// multiple of 128, at least Tq). Both launch on `stream`, do not
// synchronise, and return cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for bad arguments, or bf16 operands TMA cannot map).
extern "C" int edl_flash_bwd_dq(int dtype, int head_dim, const void* q,
                                const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* unused,
                                int B, int H, int Hkv, int Tq, int Tk,
                                const long long* st, int causal, float scale,
                                int t_pad, void* stream) {
  return run(0, dtype, head_dim, q, k, v, dout, lse, delta, dq, unused, B, H,
             Hkv, Tq, Tk, st, causal, scale, t_pad, stream);
}

extern "C" int edl_flash_bwd_dkv(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int B, int H, int Hkv, int Tq, int Tk,
                                 const long long* st, int causal, float scale,
                                 int t_pad, void* stream) {
  return run(1, dtype, head_dim, q, k, v, dout, lse, delta, dk, dv, B, H,
             Hkv, Tq, Tk, st, causal, scale, t_pad, stream);
}
