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
//   high:  gates = Whi*hhi + Whi*hlo + Wlo*hhi accumulated in fp32 on the
//          bf16 tensor cores, + the exact fp32 token row, with hhi =
//          bf16_rn(h), hlo = bf16_rn(h - hhi), Whi = bf16_rn(W), Wlo =
//          bf16_rn(W - Whi) (the limbs of W come in from the wrapper as
//          bf16). Each bf16 x bf16 product is exact in fp32, as on the TPU's
//          MXU, which computes the same three products as one K = 384 dot;
//          sigmoid = 0.5*tanhf(0.5x)+0.5.
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
// Tolerance of the tensor-core modes (high, fast, fast_bf16). A
// tensor-core mma sums its 16 products per k-step in its own order, so
// these kernels are NOT bit-identical to their plain versions
// (ops/lstm_cuda.py bilstm_logits_high_plain / bilstm_logits_fast_plain,
// which sum k ascending). The limb split (high: a 1-ulp difference in h
// flips a rounding of hlo now and then, a 2^-16-relative jump) and bf16
// rounding of h (fast) or of the gates (fast_bf16: a 2^-8-relative jump)
// amplify that difference, and it compounds over T. The plain version
// summed in 16-wide k blocks (the yardstick) moves the logits by about as
// much. The kernels are held to TC_GATE (ops/lstm_cuda.py), in terms that
// do not grow with the number of reads: mean-abs, the 99.9th percentile of
// |diff|, max-abs against the yardstick's on the same reads, no argmax flip
// above a plain margin. They are held besides bit for bit with W_hh = 0,
// where the product is exactly zero in any order: that sees what the
// tolerance cannot, a change that moves each step by about an ulp, as the
// order does (the exp form of high's sigmoid).
// Each read's logits depend only on its own tokens (no sum crosses rows),
// so they are bit-identical whatever batch the read sits in.
//
// Design of exact (CUDA cores). One block per (direction, tile of BT
// reads); blocks are independent, so the TPU kernel's sequential grid,
// 2-step unroll and feature-major VMEM layout do not carry over. Per step
// the block forms the [BT, G] gate product as a small GEMM: W_hh streams
// from L2 through shared memory in KC-row chunks (256 KB per direction in
// fp32 does not fit one block's shared memory, and it stays resident in the
// 50 MB L2), h for the tile sits in shared memory as [H][BT], and each
// thread owns RB reads x RJ hidden units x 4 gates of accumulators, so the
// cell update happens in registers and c never leaves them. Each read is
// captured exactly once per direction (its gather index lies in [0, T-1]),
// so the output is written straight from the capturing step. Bound: the
// 2*T*G*H multiply-adds per read at the fp32 CUDA-core rate.
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
//
// Design of high (bf16 tensor cores, a cluster of two blocks). Its three
// products run on mma.sync as the fast kernels' one does, but it needs both
// limbs of W^T: 2 x 128 KB in bf16 per direction, more than one block's
// 227 KB of shared memory. So each (direction, tile of TM = 64 reads) runs
// on a cluster of two blocks (__cluster_dims__(2, 1, 1)) on neighbouring
// SMs:
//   - block r of the pair owns hidden units [64r, 64r+64) in all four gates
//     (256 of the 512 gate columns) and holds Whi^T and Wlo^T for them,
//     bf16 [2][256][H] = 128 KB, resident for all T steps, swizzled as the
//     fast kernels' W;
//   - each block keeps the whole h of its 64 reads double-buffered as two
//     bf16 limbs, [2 buf][2 limb][TM][H] = 64 KB (the product's k runs over
//     all 128 units); with the fp32 token table of its 256 columns, ~198 KB
//     in all, one block per SM;
//   - 16 warps: 8 unit groups of 8 units x 2 row halves of 32 reads; a warp
//     holds 2 m16 tiles x 4 gates of fp32 accumulators (32 registers). Each
//     k16 step loads the Whi and Wlo fragments once and the hhi and hlo
//     fragments of both m16 tiles, then issues the three mma per tile, in
//     the plain yardstick's order (Whi*hhi, Whi*hlo, Wlo*hhi);
//   - the cell runs on the accumulators in registers (c and h never leave
//     them); the thread that owns a (read, unit pair) splits the new h into
//     its limbs and stores them into the next buffer of both blocks: its
//     own, and the peer's through distributed shared memory
//     (cluster.map_shared_rank);
//   - one cluster barrier per step (barrier.cluster arrive.release /
//     wait.acquire) replaces the block barrier: it makes both halves of the
//     new h visible in both blocks.
// The grid's x dimension is twice the tiles; a cluster's two blocks must
// land in one GPC, so an odd count of free SMs in a GPC would leave one
// idle (an H100 SXM holds 66 clusters on its 132 SMs: none is). Bound: the
// three products at the bf16 tensor-core rate (20.85 ms at B = 262144,
// T = 100) and the cell on the CUDA cores (18.83 ms), about even.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

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
// exact: products as fp32 FMAs on the CUDA cores

constexpr int BT = 32;       // reads per block
constexpr int KC = 16;       // W_hh rows per shared-memory chunk
constexpr int NT = 256;      // threads per block
constexpr int RB = 4;        // reads per thread
constexpr int RJ = 4;        // hidden units per thread
static_assert((NT / 32) * RB == BT, "one warp per RB-read group");
static_assert(32 * RJ == H, "a warp covers all hidden units");
static_assert(H % KC == 0, "chunking");
static_assert(RB == 4 && RJ == 4, "float4 loads of h and W");

// W chunk [KC][G], h [H][BT], this direction's token table [NTOK][G],
// tokens [2][BT] int
constexpr size_t EXACT_SMEM =
    sizeof(float) * (KC * G + H * BT + NTOK * G) + sizeof(int) * 2 * BT;

// tokens  [B, T] uint8 (values > 4 are treated as the pad token)
// gather  [B] int32 capture step per read, in [0, T-1]
// lengths [B] int32 true lengths (read only when packed)
// whh     [2, H, G] fp32 W_hh per direction
// tokw    [2, NTOK, G] fp32 token/bias table per direction
// init    [2, H] fp32: backward-carry init h then c
// out     [B, 2H] fp32: forward capture in [:, :H], backward in [:, H:]
__global__ void __launch_bounds__(NT, 2)
bilstm_exact_kernel(const uint8_t* __restrict__ tokens, const int* __restrict__ gather,
                    const int* __restrict__ lengths, const float* __restrict__ whh,
                    const float* __restrict__ tokw, const float* __restrict__ init,
                    float* __restrict__ out, int B, int T, int packed) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW = smem;                          // [KC][G]
  float* sH = sW + KC * G;                   // [H][BT]
  float* sTw = sH + H * BT;                  // [NTOK][G]
  int* sTok = reinterpret_cast<int*>(sTw + NTOK * G);  // [2][BT]

  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int r0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int j0 = (tid & 31) * RJ;
  const int b0 = (tid >> 5) * RB;
  const float* W = whh + (size_t)d * H * G;

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
  for (int i = tid; i < H * BT; i += NT) sH[i] = init_val(i / BT);

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
      const float4* src = reinterpret_cast<const float4*>(W + (size_t)k0 * G);
      for (int i = tid; i < KC * G / 4; i += NT)
        reinterpret_cast<float4*>(sW)[i] = __ldg(src + i);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float4 h4 = *reinterpret_cast<const float4*>(sH + (k0 + kk) * BT + b0);
        const float hv[RB] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w4 = *reinterpret_cast<const float4*>(sW + kk * G + q * H + j0);
          const float wv[RJ] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int rb = 0; rb < RB; ++rb)
#pragma unroll
            for (int rj = 0; rj < RJ; ++rj)
              acc[rb][q][rj] = fmaf(hv[rb], wv[rj], acc[rb][q][rj]);
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
        cell<EXACT>(a, x, c[rb][rj], cn, hv);
        if (!hold) {
          c[rb][rj] = cn;
          h[rb][rj] = hv;
        }
        hn[rj] = h[rb][rj];
        sH[j * BT + b] = hn[rj];
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

// tokens, gather, lengths, init, out: as bilstm_exact_kernel
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

// ---------------------------------------------------------------------------
// high: three bf16 products on the tensor cores, W's two limbs split over a
// cluster of two blocks

constexpr int HU = H / 2;             // hidden units of one block of the pair
constexpr int HG = 4 * HU;            // its gate columns (i, f, g, o of HU units)
constexpr int HWARPS = 16;            // 8 unit groups x 2 row halves
constexpr int HNT = 32 * HWARPS;      // threads per block
constexpr int HTWS = HG + 8;          // token-table row stride in floats
constexpr int HLIMB = 2 * TM * H;     // bytes of one h limb [TM][H] bf16
constexpr int HBUF = 2 * HLIMB;       // bytes of one h buffer (hi, lo)
constexpr int WLIMB = 2 * HG * H;     // bytes of one W limb [HG][H] bf16
static_assert(HWARPS == (HU / 8) * (TM / 32), "a warp: 8 units x 32 rows");
constexpr size_t HIGH_SMEM = 2 * WLIMB + 2 * HBUF + sizeof(float) * NTOK * HTWS +
                             sizeof(int) * 4 * TM;

// tokens, gather, lengths, init, out: as bilstm_exact_kernel
// whi, wlo [2, G, H] bf16: the limbs bf16_rn(W_hh)^T and
//          bf16_rn(W_hh - Whi)^T per direction
// tokw     [2, NTOK, G] fp32: the token/bias table, exact
// Block rank r of each cluster owns hidden units [HU*r, HU*r + HU).
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(HNT, 1)
bilstm_high_kernel(const uint8_t* __restrict__ tokens, const int* __restrict__ gather,
                   const int* __restrict__ lengths,
                   const __nv_bfloat16* __restrict__ whi,
                   const __nv_bfloat16* __restrict__ wlo,
                   const float* __restrict__ tokw, const float* __restrict__ init,
                   float* __restrict__ out, int B, int T, int packed) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ uint4 smem_hi[];
  char* sW = reinterpret_cast<char*>(smem_hi);    // [2 limb][HG][H] bf16, swizzled
  char* sH = sW + 2 * WLIMB;                      // [2 buf][2 limb][TM][H] bf16
  float* sTw = reinterpret_cast<float*>(sH + 2 * HBUF);  // [NTOK][HTWS]
  int* sTok = reinterpret_cast<int*>(sTw + NTOK * HTWS);  // [2][TM]
  int* sGat = sTok + 2 * TM;                              // [TM]
  int* sLen = sGat + TM;                                  // [TM]
  // the peer block's h buffers: the other half of every new h goes there
  char* sH_peer = cluster.map_shared_rank(sH, rank ^ 1);

  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int r0 = (blockIdx.x >> 1) * TM;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ug = warp & 7;         // unit group: local units [8ug, 8ug + 8)
  const int rh = warp >> 3;        // row half: rows [32rh, 32rh + 32)
  const int ul = 8 * ug + 2 * tig;  // this thread's pair of units, local
  const int u = HU * rank + ul;     // and in the whole h

  // both limbs of this block's gate columns of W^T, once for all T steps:
  // local row q*HU + j is gate row q*H + HU*rank + j
  for (int i = tid; i < 2 * HG * H / 8; i += HNT) {
    const int l = i / (HG * H / 8), n = (i / (H / 8)) % HG, k = (i % (H / 8)) * 8;
    const int gq = (n / HU) * H + HU * rank + n % HU;
    const __nv_bfloat16* src = (l ? wlo : whi) + ((size_t)d * G + gq) * H + k;
    *reinterpret_cast<uint4*>(sW + l * WLIMB + swz(n, k)) =
        __ldg(reinterpret_cast<const uint4*>(src));
  }
  for (int i = tid; i < NTOK * HG; i += HNT) {
    const int tk = i / HG, n = i % HG;
    sTw[tk * HTWS + n] =
        tokw[((size_t)d * NTOK + tk) * G + (n / HU) * H + HU * rank + n % HU];
  }

  auto init_val = [&](int i) { return d ? init[i] : 0.0f; };
  for (int i = tid; i < TM * H / 2; i += HNT) {  // h buffer 0: the limbs of h0
    const int row = i / (H / 2), k = 2 * (i % (H / 2));
    const float v0 = init_val(k), v1 = init_val(k + 1);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(hi);
    *reinterpret_cast<__nv_bfloat162*>(sH + swz(row, k)) = hi;
    *reinterpret_cast<__nv_bfloat162*>(sH + HLIMB + swz(row, k)) =
        __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  }
  if (tid < TM) {
    const int r = r0 + tid;
    sGat[tid] = r < B ? gather[r] : -1;
    sLen[tid] = (packed && r < B) ? lengths[r] : 0;
    const int v = r < B ? (int)tokens[(size_t)r * T + (d ? T - 1 : 0)] : NTOK - 1;
    sTok[tid] = min(v, NTOK - 1);
  }

  // c and h of (m16 tile, row gid/gid+8), each a pair of units u, u + 1
  float2 c[2][2], h[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      h[mi][hi] = make_float2(init_val(u), init_val(u + 1));
      c[mi][hi] = make_float2(init_val(H + u), init_val(H + u + 1));
    }
  cluster.sync();  // both blocks' shared memory is filled before any remote store

  const uint32_t sW_addr = static_cast<uint32_t>(__cvta_generic_to_shared(sW));
  const uint32_t sH_addr = static_cast<uint32_t>(__cvta_generic_to_shared(sH));
  // ldmatrix row addresses: B from W^T rows (the warp's 8 units of gates 2j
  // and 2j+1 in load j), A from h rows (reads)
  auto b_row = [&](int j) { return (2 * j + (lane >> 4)) * HU + 8 * ug + (lane & 7); };
  const int b_k = ((lane >> 3) & 1) * 8;
  const int a_row = 32 * rh + (lane & 15);
  const int a_k = (lane >> 4) * 8;

  for (int t = 0; t < T; ++t) {
    const int pos = d ? T - 1 - t : t;
    const int cur = t & 1;
    // next step's token, stored after this step's work (hides the load)
    int next_tok = NTOK - 1;
    if (tid < TM && t + 1 < T && r0 + tid < B)
      next_tok = tokens[(size_t)(r0 + tid) * T + (d ? pos - 1 : pos + 1)];
    const uint32_t hcur = sH_addr + cur * HBUF;
    const int hnext = (cur ^ 1) * HBUF;
    const int* tok = sTok + cur * TM;

    float acc[2][4][4];  // [m16 tile][gate][fragment]
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[mi][nt][f] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t bh[4][2], bl[4][2], ah[2][4], al[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t off = swz(b_row(j), kt * 16 + b_k);
        ldsm_x4(sW_addr + off, bh[2 * j][0], bh[2 * j][1], bh[2 * j + 1][0],
                bh[2 * j + 1][1]);
        ldsm_x4(sW_addr + WLIMB + off, bl[2 * j][0], bl[2 * j][1], bl[2 * j + 1][0],
                bl[2 * j + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint32_t off = swz(a_row + 16 * mi, kt * 16 + a_k);
        ldsm_x4(hcur + off, ah[mi][0], ah[mi][1], ah[mi][2], ah[mi][3]);
        ldsm_x4(hcur + HLIMB + off, al[mi][0], al[mi][1], al[mi][2], al[mi][3]);
      }
      // per k-step and tile: Whi*hhi, then Whi*hlo, then Wlo*hhi
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mi][nt], ah[mi], bh[nt]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mi][nt], al[mi], bh[nt]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mi][nt], ah[mi], bl[nt]);
    }

    // the cell, on the accumulators in registers; the new h's limbs go to
    // the next buffer of both blocks
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = 32 * rh + 16 * mi + gid + 8 * hi;
        const float* tw = sTw + tok[row] * HTWS;
        const bool hold = packed && d && pos >= sLen[row];
        const bool cap = sGat[row] == pos;
        const float2 ti = *reinterpret_cast<const float2*>(tw + ul);
        const float2 tf = *reinterpret_cast<const float2*>(tw + HU + ul);
        const float2 tg = *reinterpret_cast<const float2*>(tw + 2 * HU + ul);
        const float2 to = *reinterpret_cast<const float2*>(tw + 3 * HU + ul);
        float cn[2], hv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 2 * hi + e;
          const float a[4] = {acc[mi][0][f], acc[mi][1][f], acc[mi][2][f],
                              acc[mi][3][f]};
          const float x[4] = {e ? ti.y : ti.x, e ? tf.y : tf.x, e ? tg.y : tg.x,
                              e ? to.y : to.x};
          cell<HIGH>(a, x, e ? c[mi][hi].y : c[mi][hi].x, cn[e], hv[e]);
        }
        if (!hold) {
          c[mi][hi] = make_float2(cn[0], cn[1]);
          h[mi][hi] = make_float2(hv[0], hv[1]);
        }
        const float2 hn = h[mi][hi];
        const __nv_bfloat162 hhi = __floats2bfloat162_rn(hn.x, hn.y);
        const float2 hhf = __bfloat1622float2(hhi);
        const __nv_bfloat162 hlo = __floats2bfloat162_rn(hn.x - hhf.x, hn.y - hhf.y);
        const int off = hnext + swz(row, u);
        *reinterpret_cast<__nv_bfloat162*>(sH + off) = hhi;
        *reinterpret_cast<__nv_bfloat162*>(sH + off + HLIMB) = hlo;
        *reinterpret_cast<__nv_bfloat162*>(sH_peer + off) = hhi;
        *reinterpret_cast<__nv_bfloat162*>(sH_peer + off + HLIMB) = hlo;
        if (cap)
          *reinterpret_cast<float2*>(out + (size_t)(r0 + row) * (2 * H) + d * H + u) = hn;
      }
    if (tid < TM) sTok[(cur ^ 1) * TM + tid] = min(next_tok, NTOK - 1);
    // both halves of the new h and the next token are in place in both
    // blocks (release/acquire at cluster scope); also keeps either block
    // from exiting while its peer may still store into it
    cluster.sync();
  }
}

template <int MODE>
cudaError_t launch(const uint8_t* tokens, const int* gather, const int* lengths,
                   const void* wa, const void* wb, const float* tokw,
                   const float* init, float* out, int B, int T, int packed,
                   cudaStream_t stream) {
  if (B <= 0 || T <= 0) return cudaErrorInvalidValue;
  const int tiles = (B + TM - 1) / TM;
  cudaError_t err;
  if constexpr (MODE == FAST || MODE == FAST_BF16) {
    err = cudaFuncSetAttribute(bilstm_tc_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)TC_SMEM);
    if (err != cudaSuccess) return err;
    bilstm_tc_kernel<MODE><<<dim3(tiles, 2), TNT, TC_SMEM, stream>>>(
        tokens, gather, lengths, static_cast<const __nv_bfloat16*>(wa), tokw, init,
        out, B, T, packed);
  } else if constexpr (MODE == HIGH) {
    err = cudaFuncSetAttribute(bilstm_high_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)HIGH_SMEM);
    if (err != cudaSuccess) return err;
    // one cluster of two blocks per (tile, direction)
    bilstm_high_kernel<<<dim3(2 * tiles, 2), HNT, HIGH_SMEM, stream>>>(
        tokens, gather, lengths, static_cast<const __nv_bfloat16*>(wa),
        static_cast<const __nv_bfloat16*>(wb), tokw, init, out, B, T, packed);
  } else {
    err = cudaFuncSetAttribute(bilstm_exact_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)EXACT_SMEM);
    if (err != cudaSuccess) return err;
    bilstm_exact_kernel<<<dim3((B + BT - 1) / BT, 2), NT, EXACT_SMEM, stream>>>(
        tokens, gather, lengths, static_cast<const float*>(wa), tokw, init, out, B,
        T, packed);
  }
  return cudaGetLastError();
}

template <int MODE>
int launch_c(const void* tokens, const void* gather, const void* lengths,
             const void* wa, const void* wb, const void* tokw, const void* init,
             void* out, int B, int T, int packed, void* stream) {
  return (int)launch<MODE>(
      static_cast<const uint8_t*>(tokens), static_cast<const int*>(gather),
      static_cast<const int*>(lengths), wa, wb, static_cast<const float*>(tokw),
      static_cast<const float*>(init), static_cast<float*>(out), B, T, packed,
      static_cast<cudaStream_t>(stream));
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

// How many clusters of the high kernel this card holds at once (each
// cluster's two blocks on two SMs of one GPC): 2 x that against the SM
// count is what the cluster's placement leaves idle.
int rd_high_max_active_clusters(int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      bilstm_high_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)HIGH_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, 2);
  cfg.blockDim = dim3(HNT);
  cfg.dynamicSmemBytes = HIGH_SMEM;  // cluster size: the kernel's __cluster_dims__
  return (int)cudaOccupancyMaxActiveClusters(clusters, bilstm_high_kernel, &cfg);
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
