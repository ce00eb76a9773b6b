// Fused bidirectional LSTM over T for Hopper (sm_90a), four precisions.
//
// Replaces the Pallas TPU kernels of ribodetector_tpu/ops/lstm_pallas.py:
//   rd_bilstm_exact     <- _kernel in its "x6" mode (fp32 recurrence, the
//                          startup parity probe's reference arm and its
//                          fallback);
//   rd_bilstm_high      <- _kernel_x3cat ("high": 2-limb bf16 split of the
//                          fp32 recurrent product, tanh-form sigmoid; the
//                          default);
//   rd_bilstm_fast      <- _kernel in its "x1" mode with fp32 compute
//                          (--precision fast: one bf16 pass, fp32 state);
//   rd_bilstm_fast_bf16 <- _kernel in its "x1" mode with bf16 compute
//                          (runtime.compute_dtype = bfloat16: one bf16
//                          pass, bf16 state and elementwise ops).
//
// What all compute, per read and direction (hidden H = 128, G = 4H gates,
// gate order i,f,g,o): the forward direction runs t = 0..T-1, the backward
// T-1..0 from the carry (hb0, cb0); gates = tokw[token] + h @ W_hh, where
// tokw row k<4 is w_ih[k] + b and row 4 (pad) is b alone; packed semantics
// hold the backward carry at positions >= length; each direction's h is
// written out at the read's gather step. Output last_out [B, 2H] fp32; the
// Linear(256->2) head runs in the wrapper.
//
//   exact: gates in fp32 FMA, sigmoid 1/(1+expf(-x)), tanhf (IEEE; the build
//          must not use --use_fast_math).
//   high:  gates = Whi*hhi + Whi*hlo + Wlo*hhi accumulated in fp32, with
//          hhi = bf16_rn(h), hlo = bf16_rn(h - hhi), Whi = bf16_rn(W),
//          Wlo = bf16_rn(W - Whi) (the limbs of W come in precomputed, as
//          fp32 values that are exactly bf16). Each bf16 x bf16 product is
//          exact in fp32, so the products are done as fp32 FMAs on the CUDA
//          cores; sigmoid = 0.5*tanhf(0.5x)+0.5. The sum runs over k in
//          order, three products per k (Whi*hhi, Whi*hlo, Wlo*hhi), and the
//          cell's elementwise ops round one by one: the plain torch version
//          (ops/lstm_cuda.py bilstm_logits_high_plain) repeats exactly this
//          order, and the two agree bit for bit. It has to: the limb split
//          turns a 1-ulp difference in h into a 2^-16-relative one in the
//          gates now and then, and over T = 100 steps two summation orders
//          drift ~1e-4 apart in the logits.
//   fast:  what the TPU's DEFAULT-precision dot computes: gates =
//          sum_k bf16(h)[k]*bf16(W)[k], accumulated in fp32 on the bf16
//          tensor cores, + bf16(tokw) (W comes in as bf16 from the wrapper,
//          tokw as bf16-rounded fp32; h is rounded as it is written to
//          shared memory). State h, c and the cell stay fp32, sigmoid
//          1/(1+expf(-x)).
//   fast_bf16: the same product, then the gates rounded to bf16 and every
//          elementwise op rounded to bf16 as jnp ops on bf16 arrays do:
//          sig(x) = bf(bf(0.5*bf(tanh(bf(0.5x)))) + 0.5), c = bf(bf(f*c) +
//          bf(i*g)), h = bf(o*bf(tanh(c))); h and c live as bf16 values.
//   Every cell op is spelled out with __fmul_rn/__fadd_rn/__fdiv_rn (no FMA
//   contraction), as the plain versions round.
//
// Tolerance of the fast modes. A tensor-core mma sums its 16 products per
// k-step in its own order, so the fast kernels are NOT bit-identical to
// their plain version (bilstm_logits_fast_plain, which sums k ascending),
// and rounding h (fast) or the gates (fast_bf16) to bf16 every step turns
// that 1-ulp difference into a 2^-8-relative jump that compounds over T.
// The plain version summed in 16-wide k blocks (the yardstick) moves the
// logits by about as much. The kernels are held to FAST_GATE
// (ops/lstm_cuda.py), in terms that do not grow with the number of reads:
// mean-abs <= 3e-3 / 5e-3 for fast / fast_bf16 (the order alone: up to
// 1.2e-3), the 99.9th percentile of |diff| <= 0.1 / 0.3 (about 4x the
// order's), max-abs <= 4x the yardstick's on the same reads, no argmax flip
// at a plain margin >= 0.1 / 0.5. A rounding left out, an unrounded token
// row or fp32 h in the product shows in the mean-abs (4.6e-3 to 2e-2); a
// wrong token or gate shows everywhere; an order does not.
// Each read's logits depend only on its own tokens (no sum crosses rows),
// so they are bit-identical whatever batch the read sits in.
//
// Design of exact and high (CUDA cores). One block per (direction, tile of
// BT reads); blocks are independent, so the TPU kernel's sequential grid,
// 2-step unroll and feature-major VMEM layout do not carry over. Per step
// the block forms the [BT, G] gate product as a small GEMM: W_hh streams
// from L2 through shared memory in KC-row chunks (256 KB per direction in
// fp32 does not fit one block's shared memory, and it stays resident in the
// 50 MB L2), h for the tile sits in shared memory as [H][BT], and each
// thread owns RB reads x RJ hidden units x 4 gates of accumulators, so the
// cell update happens in registers and c never leaves them. Each read is
// captured exactly once per direction (its gather index lies in [0, T-1]),
// so the output is written straight from the capturing step. Bound: the
// 2*T*G*H multiply-adds per read run at the fp32 CUDA-core rate (high does
// 3x as many); the tensor-core step below is what they move to next.
//
// Design of fast and fast_bf16 (bf16 tensor cores). Two floors bound them
// on this card: the products at the bf16 tensor-core rate, and the cell's
// IEEE expf/tanhf/division on the CUDA cores (2*T*H cell evaluations per
// read, 99 / 138 instructions each in the bare one-cell loop of
// rd_cell_floor_*: the larger of the two, ~20 / ~28 ms against ~7 ms at
// B = 262144, T = 100). So the products go to mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate) and the cell stays in registers:
//   - one block per (direction, tile of TM = 64 reads), 16 warps;
//   - that direction's W_hh^T, bf16 [G][H] = 128 KB, resident in shared
//     memory for all T steps (loaded once), its 16-byte chunks XOR-swizzled
//     by row so ldmatrix reads are free of bank conflicts; h double-buffered
//     as bf16 [2][TM][H], swizzled the same way; ~171 KB in all, one block
//     per SM;
//   - warp w owns hidden units [8w, 8w+8) in all four gates (4 n-tiles),
//     so the i, f, g, o accumulators of one (read, unit) land in the same
//     thread's fragment: the cell runs on them in registers, and c and h
//     (fp32 for fast, bf16 pairs for fast_bf16; for hold and capture) never
//     leave registers;
//   - the tile runs as two passes of 32 rows (32 accumulators a thread);
//     each k16 step loads the warp's W fragments once for both m16 tiles;
//     16 warps of at most 128 registers hide latency better than 8 of up
//     to 255 and compute the same bits (fast at B = 16384, T = 100 on an
//     H100 80GB HBM3 at 700 W: 3.5 against 4.6 ms, chip_smoke.py --quick;
//     the 8-warp fast_bf16 spilled 200 bytes);
//   - the token row is added after the mma, as the plain version adds it;
//   - one barrier per step: the new h goes to the other buffer, then sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int H = 128;       // hidden width (the kernels are specialized to it)
constexpr int G = 4 * H;     // gates
constexpr int NTOK = 5;      // A C G T + pad

enum Mode { EXACT = 0, HIGH = 1, FAST = 2, FAST_BF16 = 3 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MODE>
__device__ __forceinline__ float sigm(float x) {
  // explicit roundings (no contraction into an FMA), so the plain torch
  // versions, which run each operation as its own kernel, round the same way
  if (MODE == HIGH)
    return __fadd_rn(__fmul_rn(0.5f, tanhf(__fmul_rn(0.5f, x))), 0.5f);
  if (MODE == FAST) return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
  if (MODE == FAST_BF16) {
    const float t = bf16_round(tanhf(bf16_round(__fmul_rn(0.5f, x))));
    return bf16_round(__fadd_rn(bf16_round(__fmul_rn(0.5f, t)), 0.5f));
  }
  return 1.0f / (1.0f + expf(-x));
}

// One cell evaluation of one (read, unit): gates = the product's
// accumulators acc[i,f,g,o] + the token row x; c is the carried state.
// Gives the new c and h, rounded as the mode's plain version rounds.
template <int MODE>
__device__ __forceinline__ void cell(const float (&acc)[4], const float (&x)[4],
                                     float c, float& cn, float& hv) {
  if (MODE == EXACT) {
    const float gi = acc[0] + x[0], gf = acc[1] + x[1];
    const float gg = acc[2] + x[2], go = acc[3] + x[3];
    cn = sigm<MODE>(gf) * c + sigm<MODE>(gi) * tanhf(gg);
    hv = sigm<MODE>(go) * tanhf(cn);
    return;
  }
  float g[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    g[q] = __fadd_rn(acc[q], x[q]);
    if (MODE == FAST_BF16) g[q] = bf16_round(g[q]);
  }
  if (MODE == FAST_BF16) {
    const float fc = bf16_round(__fmul_rn(sigm<MODE>(g[1]), c));
    const float ig = bf16_round(__fmul_rn(sigm<MODE>(g[0]), bf16_round(tanhf(g[2]))));
    cn = bf16_round(__fadd_rn(fc, ig));
    hv = bf16_round(__fmul_rn(sigm<MODE>(g[3]), bf16_round(tanhf(cn))));
  } else {  // HIGH, FAST: fp32 cell, one rounding per op
    cn = __fadd_rn(__fmul_rn(sigm<MODE>(g[1]), c),
                   __fmul_rn(sigm<MODE>(g[0]), tanhf(g[2])));
    hv = __fmul_rn(sigm<MODE>(g[3]), tanhf(cn));
  }
}

// The cell alone, for the bound: each iteration is one cell evaluation,
// token-row adds included, with the new h standing in for the next step's
// product. It is the arithmetic the function needs per (read, unit,
// direction, step), without a step's loads, stores, barrier or capture.
// Never launched: chip_smoke.py counts its loop's instructions in the SASS.
template <int MODE>
__device__ __forceinline__ void cell_floor(const float* in, float* out, int n) {
  const float x[4] = {in[0], in[1], in[2], in[3]};
  float c = in[4], h = in[5];
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    const float acc[4] = {h, h, h, h};
    cell<MODE>(acc, x, c, c, h);
  }
  out[0] = c;
  out[1] = h;
}

// ---------------------------------------------------------------------------
// exact, high: products as fp32 FMAs on the CUDA cores

constexpr int BT = 32;       // reads per block
constexpr int KC = 16;       // W_hh rows per shared-memory chunk
constexpr int NT = 256;      // threads per block
constexpr int RB = 4;        // reads per thread
constexpr int RJ = 4;        // hidden units per thread
static_assert((NT / 32) * RB == BT, "one warp per RB-read group");
static_assert(32 * RJ == H, "a warp covers all hidden units");
static_assert(H % KC == 0, "chunking");
static_assert(RB == 4 && RJ == 4, "float4 loads of h and W");

template <int MODE>
constexpr size_t smem_bytes() {
  // W chunk(s) [KC][G], h (or its two limbs) [H][BT], this direction's
  // token table [NTOK][G], tokens [2][BT] int
  return sizeof(float) * ((MODE == HIGH ? 2 : 1) * KC * G +
                          (MODE == HIGH ? 2 : 1) * H * BT + NTOK * G) +
         sizeof(int) * 2 * BT;
}

// tokens  [B, T] uint8 (values > 4 are treated as the pad token)
// gather  [B] int32 capture step per read, in [0, T-1]
// lengths [B] int32 true lengths (read only when packed)
// wa      [2, H, G] fp32: W_hh (exact) or Whi (high), per direction
// wb      [2, H, G] fp32: Wlo (high only)
// tokw    [2, NTOK, G] fp32 token/bias table per direction
// init    [2, H] fp32: backward-carry init h then c
// out     [B, 2H] fp32: forward capture in [:, :H], backward in [:, H:]
template <int MODE>
__global__ void __launch_bounds__(NT, 2)
bilstm_kernel(const uint8_t* __restrict__ tokens, const int* __restrict__ gather,
              const int* __restrict__ lengths, const float* __restrict__ wa,
              const float* __restrict__ wb, const float* __restrict__ tokw,
              const float* __restrict__ init, float* __restrict__ out, int B,
              int T, int packed) {
  static_assert(MODE == EXACT || MODE == HIGH, "CUDA-core modes only");
  constexpr bool LIMBS = MODE == HIGH;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sWa = smem;                          // [KC][G]
  float* sWb = sWa + (LIMBS ? KC * G : 0);    // [KC][G] (high)
  float* sHa = sWb + KC * G;                  // [H][BT]: h, or hhi
  float* sHb = sHa + (LIMBS ? H * BT : 0);    // [H][BT]: hlo (high)
  float* sTw = sHb + H * BT;                  // [NTOK][G]
  int* sTok = reinterpret_cast<int*>(sTw + NTOK * G);  // [2][BT]

  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int r0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int j0 = (tid & 31) * RJ;
  const int b0 = (tid >> 5) * RB;
  const float* Wa = wa + (size_t)d * H * G;
  const float* Wb = LIMBS ? wb + (size_t)d * H * G : nullptr;

  for (int i = tid; i < NTOK * G; i += NT) sTw[i] = tokw[(size_t)d * NTOK * G + i];

  auto init_val = [&](int i) { return d ? init[i] : 0.0f; };
  int gidx[RB], len[RB];
  float h[RB][RJ], c[RB][RJ];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    const int r = r0 + b0 + rb;
    gidx[rb] = r < B ? gather[r] : -1;
    len[rb] = (packed && r < B) ? lengths[r] : 0;
#pragma unroll
    for (int rj = 0; rj < RJ; ++rj) {
      h[rb][rj] = init_val(j0 + rj);
      c[rb][rj] = init_val(H + j0 + rj);
    }
  }
  for (int i = tid; i < H * BT; i += NT) {
    const float v = init_val(i / BT);
    if (LIMBS) {
      const float hi = bf16_round(v);
      sHa[i] = hi;
      sHb[i] = bf16_round(v - hi);
    } else {
      sHa[i] = v;
    }
  }

  for (int t = 0; t < T; ++t) {
    const int pos = d ? T - 1 - t : t;
    int* tok = sTok + (t & 1) * BT;  // double-buffered: no read/write race
    if (tid < BT) {
      const int r = r0 + tid;
      const int v = r < B ? (int)tokens[(size_t)r * T + pos] : NTOK - 1;
      tok[tid] = v < NTOK - 1 ? v : NTOK - 1;
    }

    float acc[RB][4][RJ];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int rj = 0; rj < RJ; ++rj) acc[rb][q][rj] = 0.0f;

    for (int k0 = 0; k0 < H; k0 += KC) {
      __syncthreads();  // previous chunk consumed; last step's h visible
      const float4* srcA = reinterpret_cast<const float4*>(Wa + (size_t)k0 * G);
      for (int i = tid; i < KC * G / 4; i += NT)
        reinterpret_cast<float4*>(sWa)[i] = __ldg(srcA + i);
      if (LIMBS) {
        const float4* srcB = reinterpret_cast<const float4*>(Wb + (size_t)k0 * G);
        for (int i = tid; i < KC * G / 4; i += NT)
          reinterpret_cast<float4*>(sWb)[i] = __ldg(srcB + i);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float4 ha = *reinterpret_cast<const float4*>(sHa + (k0 + kk) * BT + b0);
        const float hav[RB] = {ha.x, ha.y, ha.z, ha.w};
        float hbv[RB];
        if (LIMBS) {
          const float4 hb = *reinterpret_cast<const float4*>(sHb + (k0 + kk) * BT + b0);
          hbv[0] = hb.x; hbv[1] = hb.y; hbv[2] = hb.z; hbv[3] = hb.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 wa4 = *reinterpret_cast<const float4*>(sWa + kk * G + q * H + j0);
          const float wav[RJ] = {wa4.x, wa4.y, wa4.z, wa4.w};
          if (LIMBS) {
            const float4 wb4 = *reinterpret_cast<const float4*>(sWb + kk * G + q * H + j0);
            const float wbv[RJ] = {wb4.x, wb4.y, wb4.z, wb4.w};
#pragma unroll
            for (int rb = 0; rb < RB; ++rb)
#pragma unroll
              for (int rj = 0; rj < RJ; ++rj) {
                float a = acc[rb][q][rj];
                a = fmaf(wav[rj], hav[rb], a);  // Whi * hhi
                a = fmaf(wav[rj], hbv[rb], a);  // Whi * hlo
                a = fmaf(wbv[rj], hav[rb], a);  // Wlo * hhi
                acc[rb][q][rj] = a;
              }
          } else {
#pragma unroll
            for (int rb = 0; rb < RB; ++rb)
#pragma unroll
              for (int rj = 0; rj < RJ; ++rj)
                acc[rb][q][rj] = fmaf(hav[rb], wav[rj], acc[rb][q][rj]);
          }
        }
      }
    }
    __syncthreads();  // every read of this step's h is done before overwrite

#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const int b = b0 + rb;
      const float* tw = sTw + tok[b] * G;
      const bool hold = packed && d && pos >= len[rb];
      const bool cap = gidx[rb] == pos;
      float hn[RJ];
#pragma unroll
      for (int rj = 0; rj < RJ; ++rj) {
        const int j = j0 + rj;
        const float a[4] = {acc[rb][0][rj], acc[rb][1][rj], acc[rb][2][rj],
                            acc[rb][3][rj]};
        const float x[4] = {tw[j], tw[H + j], tw[2 * H + j], tw[3 * H + j]};
        float cn, hv;
        cell<MODE>(a, x, c[rb][rj], cn, hv);
        if (!hold) {
          c[rb][rj] = cn;
          h[rb][rj] = hv;
        }
        hn[rj] = h[rb][rj];
        if (LIMBS) {
          const float hi = bf16_round(hn[rj]);
          sHa[j * BT + b] = hi;
          sHb[j * BT + b] = bf16_round(hn[rj] - hi);
        } else {
          sHa[j * BT + b] = hn[rj];
        }
      }
      if (cap) {
        *reinterpret_cast<float4*>(out + (size_t)(r0 + b) * (2 * H) + d * H + j0) =
            make_float4(hn[0], hn[1], hn[2], hn[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fast, fast_bf16: products on the bf16 tensor cores (mma.sync m16n8k16)

constexpr int TM = 64;             // reads per block
constexpr int TWARPS = H / 8;      // warp w owns hidden units [8w, 8w+8)
constexpr int TNT = 32 * TWARPS;   // threads per block
constexpr int TPASS = 2;           // passes per step over the tile's rows
constexpr int TPR = TM / TPASS;    // rows per pass: two m16 tiles
constexpr int KT = H / 16;         // k16 steps of the product
constexpr int TWS = G + 8;         // token-table row stride in floats: rows
                                   // of different tokens start 8 banks apart
static_assert(TPR == 32, "a pass is two m16 tiles");
constexpr size_t TC_SMEM = sizeof(__nv_bfloat16) * (G * H + 2 * TM * H) +
                           sizeof(float) * NTOK * TWS + sizeof(int) * 4 * TM;

// byte offset of element (row, k) in a [rows][H] bf16 tile whose 16-byte
// chunks are XOR-swizzled by row: the 8 rows an ldmatrix phase reads land
// in 8 different bank groups
__device__ __forceinline__ uint32_t swz(int row, int k) {
  return row * (2 * H) + ((((k >> 3) ^ (row & 7))) << 4) + ((k & 7) << 1);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// a pair of state values: fp32 (fast) or bf16 (fast_bf16, whose values are
// bf16 already, so packing them rounds nothing)
__device__ __forceinline__ void set_pair(float2& s, float a, float b) {
  s = make_float2(a, b);
}
__device__ __forceinline__ void set_pair(__nv_bfloat162& s, float a, float b) {
  s = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float lane_of(float2 s, int e) { return e ? s.y : s.x; }
__device__ __forceinline__ float lane_of(__nv_bfloat162 s, int e) {
  return e ? __high2float(s) : __low2float(s);
}
__device__ __forceinline__ float2 to_float2(float2 s) { return s; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 s) {
  return __bfloat1622float2(s);
}
__device__ __forceinline__ __nv_bfloat162 to_bf16x2(float2 s) {  // the MXU's bf16(h)
  return __floats2bfloat162_rn(s.x, s.y);
}
__device__ __forceinline__ __nv_bfloat162 to_bf16x2(__nv_bfloat162 s) { return s; }

// acc[0..3] += A (16x16 bf16, row) * B (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* acc, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// tokens, gather, lengths, init, out: as bilstm_kernel
// wt    [2, G, H] bf16: bf16_rn(W_hh)^T per direction
// tokw  [2, NTOK, G] fp32: the token/bias table, bf16-rounded values
template <int MODE>
__global__ void __launch_bounds__(TNT, 1)
bilstm_tc_kernel(const uint8_t* __restrict__ tokens, const int* __restrict__ gather,
                 const int* __restrict__ lengths,
                 const __nv_bfloat16* __restrict__ wt, const float* __restrict__ tokw,
                 const float* __restrict__ init, float* __restrict__ out, int B,
                 int T, int packed) {
  static_assert(MODE == FAST || MODE == FAST_BF16, "tensor-core modes only");
  constexpr bool BF = MODE == FAST_BF16;
  extern __shared__ uint4 smem_tc[];
  char* sW = reinterpret_cast<char*>(smem_tc);          // [G][H] bf16, swizzled
  char* sH = sW + sizeof(__nv_bfloat16) * G * H;        // [2][TM][H] bf16, swizzled
  float* sTw = reinterpret_cast<float*>(sH + sizeof(__nv_bfloat16) * 2 * TM * H);
  int* sTok = reinterpret_cast<int*>(sTw + NTOK * TWS);  // [2][TM]
  int* sGat = sTok + 2 * TM;                             // [TM]
  int* sLen = sGat + TM;                                 // [TM]

  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int r0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // this direction's W^T, once for all T steps
  const uint4* wsrc = reinterpret_cast<const uint4*>(wt + (size_t)d * G * H);
  for (int i = tid; i < G * H / 8; i += TNT) {
    const int n = i / (H / 8), k = (i % (H / 8)) * 8;
    *reinterpret_cast<uint4*>(sW + swz(n, k)) = __ldg(wsrc + i);
  }
  for (int i = tid; i < NTOK * G; i += TNT)
    sTw[(i / G) * TWS + i % G] = tokw[(size_t)d * NTOK * G + i];

  // the state's initial value (bf16 state holds bf16 values from the start)
  auto init_val = [&](int i) {
    const float v = d ? init[i] : 0.0f;
    return BF ? bf16_round(v) : v;
  };
  for (int i = tid; i < TM * H / 2; i += TNT) {  // h buffer 0: bf16(h0)
    const int row = i / (H / 2), k = 2 * (i % (H / 2));
    *reinterpret_cast<__nv_bfloat162*>(sH + swz(row, k)) =
        __floats2bfloat162_rn(init_val(k), init_val(k + 1));
  }
  if (tid < TM) {
    const int r = r0 + tid;
    sGat[tid] = r < B ? gather[r] : -1;
    sLen[tid] = (packed && r < B) ? lengths[r] : 0;
    const int v = r < B ? (int)tokens[(size_t)r * T + (d ? T - 1 : 0)] : NTOK - 1;
    sTok[tid] = min(v, NTOK - 1);
  }

  // c and h of (pass, m16 tile, row gid/gid+8), each a pair of units e =
  // 0, 1: rows p*TPR + mi*16 + gid + 8*hi, units u + e. fast keeps them in
  // fp32; fast_bf16's are bf16 values and live as bf16 pairs, in half the
  // registers
  const int u = 8 * warp + 2 * tig;
  using Pair = typename std::conditional<BF, __nv_bfloat162, float2>::type;
  Pair c[TPASS][2][2], h[TPASS][2][2];
#pragma unroll
  for (int p = 0; p < TPASS; ++p)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        set_pair(h[p][mi][hi], init_val(u), init_val(u + 1));
        set_pair(c[p][mi][hi], init_val(H + u), init_val(H + u + 1));
      }
  __syncthreads();

  const uint32_t sW_addr = static_cast<uint32_t>(__cvta_generic_to_shared(sW));
  const uint32_t sH_addr = static_cast<uint32_t>(__cvta_generic_to_shared(sH));
  // ldmatrix row addresses: B from W^T rows (the warp's 8 columns of gates
  // 2j and 2j+1 in load j), A from h rows (reads)
  auto b_row = [&](int j) { return (2 * j + (lane >> 4)) * H + 8 * warp + (lane & 7); };
  const int b_k = ((lane >> 3) & 1) * 8;
  const int a_row = lane & 15;
  const int a_k = (lane >> 4) * 8;

  for (int t = 0; t < T; ++t) {
    const int pos = d ? T - 1 - t : t;
    const int cur = t & 1;
    // next step's token, stored after this step's work (hides the load)
    int next_tok = NTOK - 1;
    if (tid < TM && t + 1 < T && r0 + tid < B)
      next_tok = tokens[(size_t)(r0 + tid) * T + (d ? pos - 1 : pos + 1)];
    const uint32_t hcur = sH_addr + cur * (uint32_t)(sizeof(__nv_bfloat16) * TM * H);
    char* hnext = sH + (cur ^ 1) * sizeof(__nv_bfloat16) * TM * H;
    const int* tok = sTok + cur * TM;

#pragma unroll
    for (int p = 0; p < TPASS; ++p) {
      float acc[2][4][4];  // [m16 tile][gate][fragment]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[mi][nt][f] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldsm_x4(sW_addr + swz(b_row(j), kt * 16 + b_k), b[2 * j][0],
                  b[2 * j][1], b[2 * j + 1][0], b[2 * j + 1][1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t a[4];
          ldsm_x4(hcur + swz(p * TPR + mi * 16 + a_row, kt * 16 + a_k), a[0], a[1],
                  a[2], a[3]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mi][nt], a, b[nt]);
        }
      }

      // the cell, on the accumulators in registers
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = p * TPR + mi * 16 + gid + 8 * hi;
          const float* tw = sTw + tok[row] * TWS;
          const bool hold = packed && d && pos >= sLen[row];
          const bool cap = sGat[row] == pos;
          const float2 ti = *reinterpret_cast<const float2*>(tw + u);
          const float2 tf = *reinterpret_cast<const float2*>(tw + H + u);
          const float2 tg = *reinterpret_cast<const float2*>(tw + 2 * H + u);
          const float2 to = *reinterpret_cast<const float2*>(tw + 3 * H + u);
          float cn[2], hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = 2 * hi + e;
            const float a[4] = {acc[mi][0][f], acc[mi][1][f], acc[mi][2][f],
                                acc[mi][3][f]};
            const float x[4] = {e ? ti.y : ti.x, e ? tf.y : tf.x, e ? tg.y : tg.x,
                                e ? to.y : to.x};
            cell<MODE>(a, x, lane_of(c[p][mi][hi], e), cn[e], hv[e]);
          }
          if (!hold) {
            set_pair(c[p][mi][hi], cn[0], cn[1]);
            set_pair(h[p][mi][hi], hv[0], hv[1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(hnext + swz(row, u)) = to_bf16x2(h[p][mi][hi]);
          if (cap)
            *reinterpret_cast<float2*>(out + (size_t)(r0 + row) * (2 * H) + d * H + u) =
                to_float2(h[p][mi][hi]);
        }
    }
    if (tid < TM) sTok[(cur ^ 1) * TM + tid] = min(next_tok, NTOK - 1);
    __syncthreads();  // the new h and the next token are in place
  }
}

template <int MODE>
cudaError_t launch(const uint8_t* tokens, const int* gather, const int* lengths,
                   const void* wa, const float* wb, const float* tokw,
                   const float* init, float* out, int B, int T, int packed,
                   cudaStream_t stream) {
  if (B <= 0 || T <= 0) return cudaErrorInvalidValue;
  if constexpr (MODE == FAST || MODE == FAST_BF16) {
    cudaError_t err = cudaFuncSetAttribute(
        bilstm_tc_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TC_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((B + TM - 1) / TM, 2);
    bilstm_tc_kernel<MODE><<<grid, TNT, TC_SMEM, stream>>>(
        tokens, gather, lengths, static_cast<const __nv_bfloat16*>(wa), tokw, init,
        out, B, T, packed);
  } else {
    const size_t smem = smem_bytes<MODE>();
    cudaError_t err = cudaFuncSetAttribute(
        bilstm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((B + BT - 1) / BT, 2);
    bilstm_kernel<MODE><<<grid, NT, smem, stream>>>(
        tokens, gather, lengths, static_cast<const float*>(wa), wb, tokw, init, out,
        B, T, packed);
  }
  return cudaGetLastError();
}

template <int MODE>
int launch_c(const void* tokens, const void* gather, const void* lengths,
             const void* wa, const void* wb, const void* tokw, const void* init,
             void* out, int B, int T, int packed, void* stream) {
  return (int)launch<MODE>(
      static_cast<const uint8_t*>(tokens), static_cast<const int*>(gather),
      static_cast<const int*>(lengths), wa, static_cast<const float*>(wb),
      static_cast<const float*>(tokw), static_cast<const float*>(init),
      static_cast<float*>(out), B, T, packed, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int rd_bilstm_exact(const void* tokens, const void* gather, const void* lengths,
                    const void* whh, const void* tokw, const void* init, void* out,
                    int B, int T, int packed, void* stream) {
  return launch_c<EXACT>(tokens, gather, lengths, whh, nullptr, tokw, init, out,
                         B, T, packed, stream);
}

int rd_bilstm_high(const void* tokens, const void* gather, const void* lengths,
                   const void* whi, const void* wlo, const void* tokw,
                   const void* init, void* out, int B, int T, int packed,
                   void* stream) {
  return launch_c<HIGH>(tokens, gather, lengths, whi, wlo, tokw, init, out, B, T,
                        packed, stream);
}

// wt: bf16 [2, G, H], bf16_rn(W_hh)^T per direction; tokw: bf16-rounded
// values, stored as fp32
int rd_bilstm_fast(const void* tokens, const void* gather, const void* lengths,
                   const void* wt, const void* tokw, const void* init, void* out,
                   int B, int T, int packed, void* stream) {
  return launch_c<FAST>(tokens, gather, lengths, wt, nullptr, tokw, init, out, B,
                        T, packed, stream);
}

int rd_bilstm_fast_bf16(const void* tokens, const void* gather,
                        const void* lengths, const void* wt, const void* tokw,
                        const void* init, void* out, int B, int T, int packed,
                        void* stream) {
  return launch_c<FAST_BF16>(tokens, gather, lengths, wt, nullptr, tokw, init,
                             out, B, T, packed, stream);
}

// the cell floor's micro-kernels, one per mode (read in the SASS only)
__global__ void rd_cell_floor_exact(const float* in, float* out, int n) {
  cell_floor<EXACT>(in, out, n);
}
__global__ void rd_cell_floor_high(const float* in, float* out, int n) {
  cell_floor<HIGH>(in, out, n);
}
__global__ void rd_cell_floor_fast(const float* in, float* out, int n) {
  cell_floor<FAST>(in, out, n);
}
__global__ void rd_cell_floor_fast_bf16(const float* in, float* out, int n) {
  cell_floor<FAST_BF16>(in, out, n);
}

const char* rd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
