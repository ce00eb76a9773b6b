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
//          order. It has to: the limb split turns a 1-ulp difference in h
//          into a 2^-16-relative one in the gates now and then, and over
//          T = 100 steps two summation orders drift ~1e-4 apart in the
//          logits.
//   fast:  what the TPU's DEFAULT-precision dot computes: gates =
//          sum_k bf16(W)*bf16(h) + bf16(tokw) in fp32 (W and tokw come in
//          bf16-rounded from the wrapper; h is rounded as it is written to
//          shared memory). State h, c and the cell stay fp32, sigmoid
//          1/(1+expf(-x)).
//   fast_bf16: the same product, then the gates rounded to bf16 and every
//          elementwise op rounded to bf16 as jnp ops on bf16 arrays do:
//          sig(x) = bf(bf(0.5*bf(tanh(bf(0.5x)))) + 0.5), c = bf(bf(f*c) +
//          bf(i*g)), h = bf(o*bf(tanh(c))); h and c live as bf16 values.
//   Both fast modes spell every cell op out with __fmul_rn/__fadd_rn/
//   __fdiv_rn, and sum over k ascending: bf16 state turns a 1-ulp fp32
//   difference into a 2^-8-relative jump in h, so the plain torch version
//   (ops/lstm_cuda.py bilstm_logits_fast_plain) repeats this exact order
//   and the two agree bit for bit instead of drifting apart.
//
// Design. One block per (direction, tile of BT reads); blocks are
// independent, so the TPU kernel's sequential grid, 2-step unroll and
// feature-major VMEM layout do not carry over. Per step the block forms the
// [BT, G] gate product as a small GEMM: W_hh streams from L2 through shared
// memory in KC-row chunks (256 KB per direction in fp32 does not fit one
// block's shared memory, and it stays resident in the 50 MB L2), h for the
// tile sits in shared memory as [H][BT], and each thread owns RB reads x RJ
// hidden units x 4 gates of accumulators, so the cell update happens in
// registers and c never leaves them. Each read is captured exactly once per
// direction (its gather index lies in [0, T-1]), so the output is written
// straight from the capturing step.
//
// Bound on this card: operations. Per read both directions do 2*T*G*H
// multiply-adds (13.1 M at T = 100); exact and both fast modes run them at
// the fp32 CUDA-core rate and high runs 3x as many there too, so high is the
// slowest here. The fast modes' single bf16 pass belongs on the tensor
// cores (mma.sync / wgmma, bf16 in, fp32 accumulate), as does high's limb
// split; that redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 128;       // hidden width (the kernel is specialized to it)
constexpr int G = 4 * H;     // gates
constexpr int NTOK = 5;      // A C G T + pad
constexpr int BT = 32;       // reads per block
constexpr int KC = 16;       // W_hh rows per shared-memory chunk
constexpr int NT = 256;      // threads per block
constexpr int RB = 4;        // reads per thread
constexpr int RJ = 4;        // hidden units per thread
static_assert((NT / 32) * RB == BT, "one warp per RB-read group");
static_assert(32 * RJ == H, "a warp covers all hidden units");
static_assert(H % KC == 0, "chunking");
static_assert(RB == 4 && RJ == 4, "float4 loads of h and W");

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
// wa      [2, H, G] fp32: W_hh (exact), Whi (high) or bf16_rn(W_hh) (fast
//         modes), per direction
// wb      [2, H, G] fp32: Wlo (high only)
// tokw    [2, NTOK, G] fp32 token/bias table per direction (bf16-rounded
//         values in the fast modes)
// init    [2, H] fp32: backward-carry init h then c
// out     [B, 2H] fp32: forward capture in [:, :H], backward in [:, H:]
template <int MODE>
__global__ void __launch_bounds__(NT, 2)
bilstm_kernel(const uint8_t* __restrict__ tokens, const int* __restrict__ gather,
              const int* __restrict__ lengths, const float* __restrict__ wa,
              const float* __restrict__ wb, const float* __restrict__ tokw,
              const float* __restrict__ init, float* __restrict__ out, int B,
              int T, int packed) {
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

  // the state's initial value (bf16 state holds bf16 values from the start)
  auto init_val = [&](int i) {
    const float v = d ? init[i] : 0.0f;
    return MODE == FAST_BF16 ? bf16_round(v) : v;
  };
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
      // the MXU rounds h to bf16 in the fast modes' single pass
      sHa[i] = MODE == FAST ? bf16_round(v) : v;
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
            // fast modes: both factors are bf16 values, so the product is
            // exact and the FMA rounds once, as the plain version's add does
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
        float cn, hv;
        if (MODE == EXACT) {
          const float gi = acc[rb][0][rj] + tw[j];
          const float gf = acc[rb][1][rj] + tw[H + j];
          const float gg = acc[rb][2][rj] + tw[2 * H + j];
          const float go = acc[rb][3][rj] + tw[3 * H + j];
          cn = sigm<MODE>(gf) * c[rb][rj] + sigm<MODE>(gi) * tanhf(gg);
          hv = sigm<MODE>(go) * tanhf(cn);
        } else if (MODE == FAST_BF16) {
          const float gi = bf16_round(__fadd_rn(acc[rb][0][rj], tw[j]));
          const float gf = bf16_round(__fadd_rn(acc[rb][1][rj], tw[H + j]));
          const float gg = bf16_round(__fadd_rn(acc[rb][2][rj], tw[2 * H + j]));
          const float go = bf16_round(__fadd_rn(acc[rb][3][rj], tw[3 * H + j]));
          const float fc = bf16_round(__fmul_rn(sigm<MODE>(gf), c[rb][rj]));
          const float ig = bf16_round(__fmul_rn(sigm<MODE>(gi), bf16_round(tanhf(gg))));
          cn = bf16_round(__fadd_rn(fc, ig));
          hv = bf16_round(__fmul_rn(sigm<MODE>(go), bf16_round(tanhf(cn))));
        } else {  // HIGH, FAST: fp32 cell, one rounding per op
          const float gi = __fadd_rn(acc[rb][0][rj], tw[j]);
          const float gf = __fadd_rn(acc[rb][1][rj], tw[H + j]);
          const float gg = __fadd_rn(acc[rb][2][rj], tw[2 * H + j]);
          const float go = __fadd_rn(acc[rb][3][rj], tw[3 * H + j]);
          cn = __fadd_rn(__fmul_rn(sigm<MODE>(gf), c[rb][rj]),
                         __fmul_rn(sigm<MODE>(gi), tanhf(gg)));
          hv = __fmul_rn(sigm<MODE>(go), tanhf(cn));
        }
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
          sHa[j * BT + b] = MODE == FAST ? bf16_round(hn[rj]) : hn[rj];
        }
      }
      if (cap) {
        *reinterpret_cast<float4*>(out + (size_t)(r0 + b) * (2 * H) + d * H + j0) =
            make_float4(hn[0], hn[1], hn[2], hn[3]);
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const uint8_t* tokens, const int* gather, const int* lengths,
                   const float* wa, const float* wb, const float* tokw,
                   const float* init, float* out, int B, int T, int packed,
                   cudaStream_t stream) {
  if (B <= 0 || T <= 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<MODE>();
  cudaError_t err = cudaFuncSetAttribute(
      bilstm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, 2);
  bilstm_kernel<MODE><<<grid, NT, smem, stream>>>(tokens, gather, lengths, wa, wb,
                                                  tokw, init, out, B, T, packed);
  return cudaGetLastError();
}

template <int MODE>
int launch_c(const void* tokens, const void* gather, const void* lengths,
             const void* wa, const void* wb, const void* tokw, const void* init,
             void* out, int B, int T, int packed, void* stream) {
  return (int)launch<MODE>(
      static_cast<const uint8_t*>(tokens), static_cast<const int*>(gather),
      static_cast<const int*>(lengths), static_cast<const float*>(wa),
      static_cast<const float*>(wb), static_cast<const float*>(tokw),
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

// whh and tokw: bf16-rounded values, stored as fp32
int rd_bilstm_fast(const void* tokens, const void* gather, const void* lengths,
                   const void* whh, const void* tokw, const void* init, void* out,
                   int B, int T, int packed, void* stream) {
  return launch_c<FAST>(tokens, gather, lengths, whh, nullptr, tokw, init, out,
                        B, T, packed, stream);
}

int rd_bilstm_fast_bf16(const void* tokens, const void* gather,
                        const void* lengths, const void* whh, const void* tokw,
                        const void* init, void* out, int B, int T, int packed,
                        void* stream) {
  return launch_c<FAST_BF16>(tokens, gather, lengths, whh, nullptr, tokw, init,
                             out, B, T, packed, stream);
}

const char* rd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
