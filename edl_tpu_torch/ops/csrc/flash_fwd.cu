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
//     with no repeat in memory. o [B, H, Tq, D] in the input type, lse
//     [B*H, Tq] fp32.
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
//     the online softmax reproduces exactly that (every score is -1e30).
//   - scores, the running max m and sum l, the accumulator and lse in fp32;
//     l clamped at 1e-30; p rounded to the input type before p.v, as the
//     reference casts probabilities to v.dtype.
//
// Design (simple, right first). One CTA of 128 threads per (B*H row,
// 64-query tile); K/V tiles of 64 keys are staged in shared memory, and the
// online softmax runs in registers. Two bodies share that structure:
//   - bf16 (the model's type): tensor cores through mma.sync m16n8k16 with
//     fp32 accumulation. Each warp owns 16 query rows: its q fragments stay
//     in registers for the whole K/V walk, S = q k^T lands in the mma
//     accumulator layout, p is rounded to bf16 and repacked in registers as
//     the A operand of p.v (no shared-memory round trip), and v's B operand
//     comes from ldmatrix.trans. Row max and sum reduce over the 4 lanes of
//     a quad. Global loads are 16-byte vectors when the wrapper says every
//     row is 16-byte aligned, scalar otherwise. Query tiles are issued
//     longest first under the causal mask.
//   - fp32 (the small config): fp32 FMAs on the CUDA cores, which is the
//     only way to keep full fp32 products (tf32 mma would round q and k).
//     Each thread owns a 4-query x 8-key block of the score tile.
//
// Bound at the flagship shape (per launch, causal, B=8, H=16, T=2048, D=64,
// bf16): 4*D*B*H*T(T+1)/2 = 68.7 GFLOP, about 70 us at 989 TFLOP/s (bf16
// tensor cores), against 135 MB of q/k/v/o/lse traffic, about 40 us at
// 3.35 TB/s: compute-bound.
//
// What this design leaves on the table: mma.sync reaches only part of
// Hopper's tensor-core rate (wgmma, issued by a warpgroup from shared
// memory, is the way to the rest); K/V loads are synchronous and not
// overlapped with the products inside a CTA (no cp.async / TMA ring, no
// producer warp), so only other resident CTAs hide them; the exp and the
// rescale of the accumulator run on every tile (no lazy rescale); K
// fragments are re-read from shared memory by each of the four warps.

#include <math_constants.h>

#include "flash_common.cuh"

namespace {

constexpr float MASK_VALUE = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, group, Tq, Tk, causal, q_offset, vec16;
  float scale;
  Strides sq, sk, sv, so;
};

// Number of KV tiles query tile q0 walks: under the causal mask, up to the
// last visible key of its last row, unless one of its rows sees no key.
__device__ __forceinline__ int kv_tiles(const Params& p, int q0) {
  const int nk = (p.Tk + BK - 1) / BK;
  if (p.causal && q0 + p.q_offset >= 0) {
    const int q_last = min(q0 + BQ, p.Tq) - 1;
    return min(nk, (q_last + p.q_offset) / BK + 1);
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

template <int D>
constexpr size_t smem_bytes_bf16() {
  return sizeof(__nv_bfloat16) * 3 * 64 * (D + LDS_PAD);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_bf16_kernel(Params p) {
  constexpr int LDS = D + LDS_PAD;
  constexpr int KC = D / 16;  // k-steps of q k^T
  constexpr int DT = D / 8;   // 8-wide column tiles of o
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + 64 * LDS;
  __nv_bfloat16* sV = sK + 64 * LDS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int tg = lane & 3;  // column pair within an 8-column tile
  // under the causal mask the last query tiles walk the most keys: issue
  // them first so they do not trail the launch
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / p.group;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           b * p.sk.b + hk * p.sk.h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           b * p.sv.b + hk * p.sv.h;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b +
                     h * p.so.h;

  load_tile_bf16<D>(sQ, q, p.sq.t, q0, p.Tq, p.vec16);
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, for the whole K/V walk
  const int wr = warp * 16;
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) load_a_frag<LDS>(qf[kc], sQ, wr, kc, g, tg);

  // rows qi[0] = wr + g and qi[1] = wr + g + 8 of the tile
  const int qi[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  const int n_tiles = kv_tiles(p, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(sK, k, p.sk.t, k0, p.Tk, p.vec16);
    load_tile_bf16<D>(sV, v, p.sv.t, k0, p.Tk, p.vec16);
    __syncthreads();

    // S = q k^T: 8 column tiles of 8 keys, fp32 accumulators
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kb = sK + (nt * 8 + g) * LDS + 2 * tg;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mma_bf16(s[nt], qf[kc], ld32(kb + kc * 16), ld32(kb + kc * 16 + 8));
      }
    }

    // scale, mask, online softmax; element e of a tile is row qi[e >> 1],
    // key k0 + 8 nt + 2 tg + (e & 1)
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            masked(p, s[nt][e], qi[e >> 1], k0 + nt * 8 + 2 * tg + (e & 1));
        s[nt][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      // key k0 < Tk scores finite (real or the mask value), so the new max
      // is finite and exp(-inf - m) = 0 for keys past Tk
      const float m_new = fmaxf(m[r], mt[r]);
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += pe;
        s[nt][e] = pe;
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // o += p v: p (rounded to bf16) is already laid out as A fragments
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pack_a_frag(pa, s, kc);
      const __nv_bfloat16* vb = trans_row<LDS>(sV, kc * 16, lane);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb + dp * 16);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qi[r] >= p.Tq) continue;
    const float li = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / li;
    __nv_bfloat16* orow = o + qi[r] * p.so.t + 2 * tg;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    if (tg == 0) {
      p.lse[static_cast<long long>(bh) * p.Tq + qi[r]] = m[r] + logf(li);
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

  const int n_tiles = kv_tiles(p, q0);
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
  return allow_smem(flash_fwd_bf16_kernel<D>, smem_bytes_bf16<D>());
}

template <int D>
cudaError_t launch_dtype(int dtype, const Params& p, dim3 grid,
                         cudaStream_t stream) {
  switch (dtype) {
    case 0:
      flash_fwd_f32_kernel<D><<<grid, NTHREADS, smem_bytes_f32<D>(), stream>>>(p);
      break;
    case 1:
      flash_fwd_bf16_kernel<D><<<grid, NTHREADS, smem_bytes_bf16<D>(), stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Once per device, before the first launch there: lets every instance of the
// kernel take its dynamic shared memory (the attribute is per device, so it
// stays off the launch path). Returns 0 on success.
extern "C" int edl_flash_fwd_prepare() {
  cudaError_t err = allow_smem_dtypes<32>();
  if (err == cudaSuccess) err = allow_smem_dtypes<64>();
  if (err == cudaSuccess) err = allow_smem_dtypes<128>();
  return static_cast<int>(err);
}

// dtype: 0 = fp32, 1 = bf16. Strides are in elements, for the b, h and t
// axes of each [B, heads, T, D] tensor. vec16: every q/k/v row starts on a
// 16-byte boundary (bf16 loads as 16-byte vectors). Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int edl_flash_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* o, void* lse, int B, int H, int Hkv, int Tq, int Tk,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    int causal, float scale, int vec16, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
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
  p.vec16 = vec16;
  p.scale = scale;
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.so = {o_sb, o_sh, o_st};
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return static_cast<int>(launch_dtype<32>(dtype, p, grid, s));
    case 64: return static_cast<int>(launch_dtype<64>(dtype, p, grid, s));
    case 128: return static_cast<int>(launch_dtype<128>(dtype, p, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
