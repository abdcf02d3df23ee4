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
//     the first three axes and unit stride on D; lse, delta [B*H, Tq] fp32;
//     dq [B, H, Tq, D], dk/dv [B, Hkv, Tk, D] written with the strides given.
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
// Design (simple, right first). 128 threads (4 warps), 64-row tiles:
//   - K2 `flash_bwd_dq`: one CTA per (B*H row, 64-query tile). q and dO
//     stay in registers as mma A fragments; K/V tiles of 64 keys are staged
//     in shared memory, in two 32-key halves: S = q k^T and dP = dO v^T land
//     in the accumulator layout, ds is rounded to bf16 and repacked in
//     registers as the A operand of dq += ds k (k's B operand from
//     ldmatrix.trans). The walk stops at the causal bound of the tile's last
//     row; tiles are issued longest first.
//   - K3 `flash_bwd_dkv`: one CTA per (batch, kv head, 64-key tile). K and V
//     stay resident in shared memory; each warp owns 16 keys and keeps its dk
//     and dv accumulators in registers. For each query head of the group, q
//     and dO tiles (with lse, delta) stream through shared memory from the
//     causal lower bound (plus the tiles holding rows that see no key); in
//     two 32-query halves S^T = k q^T and dP^T = v dO^T are formed, p^T and
//     ds^T repacked to bf16 as A operands of dv += p^T dO and dk += ds^T q.
//   - fp32 (the small config): the same walks with fp32 FMAs on the CUDA
//     cores (tf32 mma would round q and k); each thread owns a 4-row x
//     8-column block of the score tile.
//
// Bound at the flagship shape (per launch, causal, B=8, H=16, T=2048, D=64,
// bf16): K2 does 3 products of 2*D flops per visible pair (S, dP, dq):
// 6*D*B*H*T(T+1)/2 = 103 GFLOP, about 0.10 ms at 989 TFLOP/s; K3 does 4
// (S, dP, dv, dk): 137 GFLOP, 0.14 ms. A fused backward needs 10*D per pair
// (S and dP once): 172 GFLOP. Each reads q, k, v, dO (bf16) and lse, delta
// (fp32) and writes one or two [.., T, D] bf16 tensors, about 135 MB
// (40 us): compute-bound.
//
// What this design leaves on the table: mma.sync instead of wgmma (a part
// of the tensor-core rate); synchronous tile loads with no cp.async / TMA
// ring, so only other resident CTAs hide them; S and dP computed twice, once
// in each kernel (a fused kernel needs atomics or a second pass for dq); the
// exp recomputed in both kernels.

#include <math_constants.h>

#include "flash_common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out0;  // dq (K2) or dk (K3)
  void* out1;  // dv (K3)
  int H, Hkv, group, Tq, Tk, causal, q_offset, vec16;
  float scale;
  Strides sq, sk, sv, sdo, s0, s1;
};

// p and ds of (query row qi, key kk) from the raw score s and dp.
__device__ __forceinline__ void grad_entry(const Params& p, float s, float dp,
                                           int qi, int kk, float lse,
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
  pe = __expf(s * p.scale - lse);
  ds = pe * (dp - delta);
}

// KV tiles query tile q0 walks for dq: up to the last visible key of its
// last row (none if that row sees no key).
__device__ __forceinline__ int dq_kv_tiles(const Params& p, int q0) {
  const int nk = (p.Tk + BK - 1) / BK;
  if (!p.causal) return nk;
  const int last = min(q0 + BQ, p.Tq) - 1 + p.q_offset;
  return last < 0 ? 0 : min(nk, last / BK + 1);
}

// Query tiles key tile k0 skips for dk/dv: [nokey, lower) see none of its
// keys. Tiles below `nokey` hold rows that see no key at all (they add to
// every key's dv); tiles from `lower` on hold rows that see key k0.
__device__ __forceinline__ void dkv_q_range(const Params& p, int k0,
                                            int& nokey, int& lower) {
  nokey = 0;
  lower = 0;
  if (!p.causal) return;
  if (p.q_offset < 0) nokey = (-p.q_offset + BQ - 1) / BQ;
  lower = max(0, (k0 - p.q_offset) / BQ);
}

// ---------------------------------------------------------------- bf16 ----

template <int D>
constexpr size_t smem_bytes_bf16() {
  return sizeof(__nv_bfloat16) * 4 * 64 * (D + LDS_PAD) +
         sizeof(float) * 2 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_bf16_kernel(Params p) {
  constexpr int LDS = D + LDS_PAD;
  constexpr int KC = D / 16;  // k-steps over head_dim
  constexpr int DT = D / 8;   // 8-wide column tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + 64 * LDS;
  __nv_bfloat16* sK = sDO + 64 * LDS;
  __nv_bfloat16* sV = sK + 64 * LDS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tg = lane & 3;
  // under the causal mask the last query tiles walk the most keys
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.group;

  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf* dout = static_cast<const bf*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const bf* k = static_cast<const bf*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const bf* v = static_cast<const bf*>(p.v) + b * p.sv.b + hk * p.sv.h;
  bf* dq = static_cast<bf*>(p.out0) + b * p.s0.b + h * p.s0.h;

  load_tile_bf16<D>(sQ, q, p.sq.t, q0, p.Tq, p.vec16);
  load_tile_bf16<D>(sDO, dout, p.sdo.t, q0, p.Tq, p.vec16);
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[KC][4], df[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    load_a_frag<LDS>(qf[kc], sQ, wr, kc, g, tg);
    load_a_frag<LDS>(df[kc], sDO, wr, kc, g, tg);
  }
  const int qi[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = static_cast<long long>(bh) * p.Tq + qi[r];
    lse[r] = qi[r] < p.Tq ? p.lse[row] : 0.f;
    delta[r] = qi[r] < p.Tq ? p.delta[row] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  const int n_tiles = dq_kv_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(sK, k, p.sk.t, k0, p.Tk, p.vec16);
    load_tile_bf16<D>(sV, v, p.sv.t, k0, p.Tk, p.vec16);
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kb = half * 32;  // first key of this half in the tile
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
        const bf* kr = sK + (kb + nt * 8 + g) * LDS + 2 * tg;
        const bf* vr = sV + (kb + nt * 8 + g) * LDS + 2 * tg;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          mma_bf16(s[nt], qf[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
          mma_bf16(dp[nt], df[kc], ld32(vr + kc * 16), ld32(vr + kc * 16 + 8));
        }
      }
      // element e of tile nt: row qi[e >> 1], key k0 + kb + 8 nt + 2 tg + (e & 1)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe, ds;
          grad_entry(p, s[nt][e], dp[nt][e], qi[e >> 1],
                     k0 + kb + nt * 8 + 2 * tg + (e & 1), lse[e >> 1],
                     delta[e >> 1], pe, ds);
          s[nt][e] = ds;
        }
      }
      // dq += ds k: ds (rounded to bf16) is laid out as A fragments
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t da[4];
        pack_a_frag(da, s, kc);
        const bf* kb_row = trans_row<LDS>(sK, kb + kc * 16, lane);
#pragma unroll
        for (int dd = 0; dd < DT / 2; ++dd) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, kb_row + dd * 16);
          mma_bf16(acc[2 * dd], da, kf[0], kf[1]);
          mma_bf16(acc[2 * dd + 1], da, kf[2], kf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= p.Tq) continue;
    bf* row = dq + qi[r] * p.s0.t + 2 * tg;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * r] * p.scale, acc[j][2 * r + 1] * p.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_bf16_kernel(Params p) {
  constexpr int LDS = D + LDS_PAD;
  constexpr int KC = D / 16;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + 64 * LDS;
  __nv_bfloat16* sQ = sV + 64 * LDS;
  __nv_bfloat16* sDO = sQ + 64 * LDS;
  float* sLse = reinterpret_cast<float*>(sDO + 64 * LDS);
  float* sDelta = sLse + BQ;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int k0 = blockIdx.x * BK;  // causal: the first key tiles walk most
  const int b = blockIdx.y / p.Hkv;
  const int hk = blockIdx.y % p.Hkv;

  using bf = __nv_bfloat16;
  const bf* k = static_cast<const bf*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const bf* v = static_cast<const bf*>(p.v) + b * p.sv.b + hk * p.sv.h;
  bf* dk_out = static_cast<bf*>(p.out0) + b * p.s0.b + hk * p.s0.h;
  bf* dv_out = static_cast<bf*>(p.out1) + b * p.s1.b + hk * p.s1.h;

  load_tile_bf16<D>(sK, k, p.sk.t, k0, p.Tk, p.vec16);
  load_tile_bf16<D>(sV, v, p.sv.t, k0, p.Tk, p.vec16);

  const int wr = warp * 16;  // this warp's 16 keys
  const int kr[2] = {k0 + wr + g, k0 + wr + g + 8};
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }

  const int nq = (p.Tq + BQ - 1) / BQ;
  int nokey, lower;
  dkv_q_range(p, k0, nokey, lower);
  for (int j = 0; j < p.group; ++j) {
    const int h = hk * p.group + j;
    const long long bh = static_cast<long long>(b) * p.H + h;
    const bf* q = static_cast<const bf*>(p.q) + b * p.sq.b + h * p.sq.h;
    const bf* dout =
        static_cast<const bf*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
    for (int t = 0; t < nq; ++t) {
      if (t >= nokey && t < lower) t = lower;
      if (t >= nq) break;
      const int q0 = t * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile_bf16<D>(sQ, q, p.sq.t, q0, p.Tq, p.vec16);
      load_tile_bf16<D>(sDO, dout, p.sdo.t, q0, p.Tq, p.vec16);
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        sLse[threadIdx.x] = qi < p.Tq ? p.lse[bh * p.Tq + qi] : 0.f;
        sDelta[threadIdx.x] = qi < p.Tq ? p.delta[bh * p.Tq + qi] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qb = half * 32;  // first query of this half in the tile
        float s[4][4], dp[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
        }
        // S^T = k q^T and dP^T = v dO^T: rows are this warp's keys
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t ka[4], va[4];
          load_a_frag<LDS>(ka, sK, wr, kc, g, tg);
          load_a_frag<LDS>(va, sV, wr, kc, g, tg);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const bf* qr = sQ + (qb + nt * 8 + g) * LDS + kc * 16 + 2 * tg;
            const bf* dr = sDO + (qb + nt * 8 + g) * LDS + kc * 16 + 2 * tg;
            mma_bf16(s[nt], ka, ld32(qr), ld32(qr + 8));
            mma_bf16(dp[nt], va, ld32(dr), ld32(dr + 8));
          }
        }
        // element e of tile nt: key kr[e >> 1], query q0 + qb + 8 nt + 2 tg + (e & 1)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qq = qb + nt * 8 + 2 * tg + (e & 1);
            float pe, ds;
            grad_entry(p, s[nt][e], dp[nt][e], q0 + qq, kr[e >> 1],
                       sLse[qq], sDelta[qq], pe, ds);
            s[nt][e] = pe;
            dp[nt][e] = ds;
          }
        }
        // dv += p^T dO, dk += ds^T q: p^T, ds^T (bf16) as A fragments
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          uint32_t pa[4], da[4];
          pack_a_frag(pa, s, kc);
          pack_a_frag(da, dp, kc);
          const bf* do_row = trans_row<LDS>(sDO, qb + kc * 16, lane);
          const bf* q_row = trans_row<LDS>(sQ, qb + kc * 16, lane);
#pragma unroll
          for (int dd = 0; dd < DT / 2; ++dd) {
            uint32_t f[4];
            ldmatrix_x4_trans(f, do_row + dd * 16);
            mma_bf16(dv[2 * dd], pa, f[0], f[1]);
            mma_bf16(dv[2 * dd + 1], pa, f[2], f[3]);
            ldmatrix_x4_trans(f, q_row + dd * 16);
            mma_bf16(dk[2 * dd], da, f[0], f[1]);
            mma_bf16(dk[2 * dd + 1], da, f[2], f[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= p.Tk) continue;
    bf* krow = dk_out + kr[r] * p.s0.t + 2 * tg;
    bf* vrow = dv_out + kr[r] * p.s1.t + 2 * tg;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + j * 8) = __floats2bfloat162_rn(
          dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + j * 8) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
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
    const long long row = static_cast<long long>(bh) * p.Tq + qi;
    lse[i] = qi < p.Tq ? p.lse[row] : 0.f;
    delta[i] = qi < p.Tq ? p.delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = dq_kv_tiles(p, q0);
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
  dkv_q_range(p, k0, nokey, lower);
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
        sLse[tid] = qi < p.Tq ? p.lse[bh * p.Tq + qi] : 0.f;
        sDelta[tid] = qi < p.Tq ? p.delta[bh * p.Tq + qi] : 0.f;
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
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, smem_bytes_bf16<D>());
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, smem_bytes_bf16<D>());
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_f32_kernel<D>, smem_bytes_dq_f32<D>());
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dkv_f32_kernel<D>, smem_bytes_dkv_f32<D>());
  return err;
}

template <int D>
cudaError_t launch(int which, int dtype, const Params& p, dim3 grid,
                   cudaStream_t stream) {
  if (which == 0 && dtype == 0) {
    flash_bwd_dq_f32_kernel<D><<<grid, NTHREADS, smem_bytes_dq_f32<D>(), stream>>>(p);
  } else if (which == 0 && dtype == 1) {
    flash_bwd_dq_bf16_kernel<D><<<grid, NTHREADS, smem_bytes_bf16<D>(), stream>>>(p);
  } else if (which == 1 && dtype == 0) {
    flash_bwd_dkv_f32_kernel<D><<<grid, NTHREADS, smem_bytes_dkv_f32<D>(), stream>>>(p);
  } else if (which == 1 && dtype == 1) {
    flash_bwd_dkv_bf16_kernel<D><<<grid, NTHREADS, smem_bytes_bf16<D>(), stream>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int run(int which, int dtype, int head_dim, const void* q, const void* k,
        const void* v, const void* dout, const void* lse, const void* delta,
        void* out0, void* out1, int B, int H, int Hkv, int Tq, int Tk,
        const long long* st, int causal, float scale, int vec16,
        void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
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
  p.vec16 = vec16;
  p.scale = scale;
  p.sq = {st[0], st[1], st[2]};
  p.sk = {st[3], st[4], st[5]};
  p.sv = {st[6], st[7], st[8]};
  p.sdo = {st[9], st[10], st[11]};
  p.s0 = {st[12], st[13], st[14]};
  p.s1 = {st[15], st[16], st[17]};
  const dim3 grid = which == 0 ? dim3((Tq + BQ - 1) / BQ, B * H)
                               : dim3((Tk + BK - 1) / BK, B * Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(launch<32>(which, dtype, p, grid, s));
    case 64: return static_cast<int>(launch<64>(which, dtype, p, grid, s));
    case 128: return static_cast<int>(launch<128>(which, dtype, p, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Once per device, before the first launch there: lets every instance of
// both kernels take its dynamic shared memory. Returns 0 on success.
extern "C" int edl_flash_bwd_prepare() {
  cudaError_t err = allow_smem_all<32>();
  if (err == cudaSuccess) err = allow_smem_all<64>();
  if (err == cudaSuccess) err = allow_smem_all<128>();
  return static_cast<int>(err);
}

// dtype: 0 = fp32, 1 = bf16. `st` holds 18 element strides: the b, h and t
// axes of q, k, v, dO and the outputs (dq; or dk then dv). vec16: every
// q/k/v/dO row starts on a 16-byte boundary. Both launch on `stream`, do
// not synchronise, and return cudaGetLastError() (0 on success).
extern "C" int edl_flash_bwd_dq(int dtype, int head_dim, const void* q,
                                const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* unused,
                                int B, int H, int Hkv, int Tq, int Tk,
                                const long long* st, int causal, float scale,
                                int vec16, void* stream) {
  return run(0, dtype, head_dim, q, k, v, dout, lse, delta, dq, unused, B, H,
             Hkv, Tq, Tk, st, causal, scale, vec16, stream);
}

extern "C" int edl_flash_bwd_dkv(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int B, int H, int Hkv, int Tq, int Tk,
                                 const long long* st, int causal, float scale,
                                 int vec16, void* stream) {
  return run(1, dtype, head_dim, q, k, v, dout, lse, delta, dk, dv, B, H,
             Hkv, Tq, Tk, st, causal, scale, vec16, stream);
}
