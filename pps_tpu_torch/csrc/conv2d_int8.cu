// conv2d_int8: the int8 post-training-quantized convolution of the serving
// body, as an implicit GEMM with the activation quantize fused into its
// load and the dequantize epilogue fused into its store.
//
// Counterpart of pps_tpu/models/resnet.py:conv2d_int8 (:205-233), which the
// JAX package leaves to XLA as lax.conv_general_dilated(s8, s8,
// preferred_element_type=int32).  PyTorch has no int8 convolution on CUDA
// (F.conv2d refuses int8 tensors there and cuDNN's int8 path is not
// exposed), so the port computes it here.  Per output element:
//
//   q   = clamp(rint(float(x) * xinv), -127, 127)   (round half to even)
//   acc = sum over (kh, kw, c) of q * wq              (int32, exact)
//   y   = float(acc) * osc[o], then + fb[o]           (two float32 roundings)
//
// and y is stored in the output dtype (bf16 rounds to nearest even).  The
// multiply and the add are __fmul_rn / __fadd_rn so nvcc cannot contract
// them into one FMA: the plain version (kernels/conv2d_int8.py) rounds
// twice, as XLA does.  Integer sums are exact in any order (|acc| <= 4608 *
// 127^2 < 2^31), so K may be reordered or padded with zero weights.  xinv
// is one scalar (BN-folded bodies) or one value per input channel
// (GroupNorm bodies, whose per-channel scales are already absorbed into
// wq).
//
// Layouts: x is NHWC (a channels_last NCHW tensor), float32 (the stem's
// image) or bf16 (the body); wq is OHWI int8, [C_out][KH][KW][C_in/groups],
// so one output channel's K = KH*KW*C_in/groups weights are contiguous;
// the output is NHWC, float32 or bf16 (or the int32 accumulators, mode 2,
// the debug entry the checks use).  Padding is ((k-1)*d)//2 on each side,
// as the JAX body's SAME_LOWER.
//
// Bound: the R-50 body at batch 64 and 384x128 does ~0.76 TOP of int8
// products per batch (0.38 ms at the H100's 1,979 TOP/s dense int8); each
// conv moves its input once in its dtype, its int8 weights and its output
// (the res2 maps dominate): the body as a whole is bound by bytes (~0.89
// ms against ~0.38 ms of operations).
//
// Routes, chosen by shape alone (choose_route below; the same function in
// Python is kernels/conv2d_int8.py:route):
//
// 1. wgmma, the body (bf16 x, groups 1, C_in % 64 == 0, C_out % 8 == 0,
//    stride <= 8: every R-50 body conv).  A persistent CTA per SM walks
//    tiles of 128 output pixels x BN output channels (BN 64, 128 or 256, by
//    a cost model of waves over the SMs), a tile row's N tiles back to back
//    so its activations are re-read from L2.  The tile's pixels are a box
//    of bw x bh x bimg (width, height, images; a 1x1 stride-1 conv sees its
//    n * h * w pixels as one row).  Warpgroup 0 is the producer: one thread
//    keeps a ring of up to 6 stages full through TMA, each stage one box of
//    64 bf16 channels of the tile's pixels for one tap (a 4-d tensor map
//    over NHWC; the conv's stride is the map's element stride, its padding
//    the zeros TMA fills past an edge, and quantize(0) = 0) and the 64-of-K
//    slice of the tile's int8 weights (64-byte swizzle).  Warpgroups 1 and
//    2 take 64 rows each: read the 128-byte-swizzled bf16 box, quantize
//    into wgmma's A registers (so the quantize runs once per tile of BN
//    channels, and A needs no fence between the generic and async
//    proxies), then two wgmma.mma_async.m64nBNk32.s32.s8.s8 per stage with
//    B from shared memory.  A wgmma reads its A registers asynchronously,
//    so two register sets alternate, each rewritten only after the
//    wgmma.wait_group that retires its products; the stage before is
//    released there too.  The epilogue dequantizes into a 128-byte-swizzled
//    staging tile and stores it with TMA (whole 128-byte rows; the store
//    clips the tile's edges) while the producer loads the next tile.
//    setmaxnreg moves registers from the producer to the consumers
//    (40 / 232).
// 2. wgmma, the stem (float32 x, C_in * KW <= 32, C_out <= 64): K is laid
//    out per kernel row, its KW * C_in values (21 for the 7x7 RGB stem)
//    padded to 32, so K = KH * 32.  The producer loads the input rows a
//    tile of 2 output rows needs (a 3-d map over [n][h][w * c]; 9 rows of
//    2 boxes of 224 floats for the R-50 stem) as one ring stage; the
//    consumers gather each row's 32 values from shared memory and quantize
//    them into A registers; the weights, zero-padded the same way, sit in
//    shared memory for the whole kernel.
// 3. general, every other shape (C_in/groups not a multiple of 64, groups
//    > 1, C_out % 8 != 0, float32 body inputs): the simple kernel below, a
//    64 x 64 tile of 4 warps stepping K by 32 with mma.sync.m16n8k32 s8.
//
// Plain C interface, loaded with ctypes: the launch goes on the caller's
// stream, allocates nothing, does not synchronise, and the function
// returns cudaGetLastError() (or -1 for arguments it does not take).  The
// tensor maps are made on the host at every call (cuTensorMapEncodeTiled,
// fetched at run time with cudaGetDriverEntryPoint, so the library links
// no libcuda) and passed as __grid_constant__ kernel parameters.
//
// Bring-up on the card alone: python3 -m pps_tpu_torch.tools.conv2d_int8_check

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ===========================================================================
// The general route: any shape, mma.sync (sm_80 and later).
// ===========================================================================
namespace general {

// A CTA of 4 warps computes a 64 (output pixels) x 64 (output channels)
// tile of one group's GEMM, M = N*Ho*Wo, N = C_out/groups, K = KH*KW*C_in/
// groups, stepping K by 32.  Each step, the CTA quantizes a 64 x 32 slice
// of the im2col matrix into shared memory (16 channels a thread, one 16-
// or 64-byte vector load, when C_in/groups is a multiple of 32: the slice
// then sits inside one tap; element by element with bounds checks
// otherwise, zero-padded in shared memory past K) and copies a 64 x 32
// int8 weight slice beside it; each warp then issues 8 mma.sync.m16n8k32
// s8 x s8 -> s32 products on its 32 x 32 quarter.  Shared rows are padded
// to 48 bytes, so the fragment loads hit 32 distinct banks.  The epilogue
// applies osc and fb straight from the accumulator registers.

constexpr int kBM = 64;        // output pixels per CTA
constexpr int kBN = 64;        // output channels per CTA
constexpr int kBK = 32;        // K per step (one mma k32)
constexpr int kRow = 48;       // shared row stride in bytes (32 + 16 pad)
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile

struct Params {
  const void* x;
  const float* xinv;
  const int8_t* wq;
  const float* osc;
  const float* fb;
  void* out;
  int n, h, w, cin;           // input NHWC
  int ho, wo, cout;           // output NHWC
  int kh, kw, stride, dil, pad_h, pad_w, groups;
  int per_channel;            // xinv has cin entries (else one)
  int x_fast, w_fast;         // vector loads allowed (see launch)
};

__device__ __forceinline__ float load_x(const float* x, int64_t i) {
  return x[i];
}

__device__ __forceinline__ float load_x(const __nv_bfloat16* x, int64_t i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ int quantize(float v, float inv) {
  float r = rintf(__fmul_rn(v, inv));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int>(r);
}

// 16 consecutive channels of one pixel, quantized, packed little-endian.
__device__ __forceinline__ void quantize16(const float* src, const float* inv,
                                           int per_channel, uint32_t* dst) {
  float v[16];
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float4 f = s4[j];
    v[4 * j] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int e = 4 * j + b;
      const int q = quantize(v[e], per_channel ? inv[e] : inv[0]);
      word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * b);
    }
    dst[j] = word;
  }
}

__device__ __forceinline__ void quantize16(const __nv_bfloat16* src,
                                           const float* inv, int per_channel,
                                           uint32_t* dst) {
  float v[16];
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint4 raw = s4[j];
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[8 * j + e] = __bfloat162float(b[e]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int e = 4 * j + b;
      const int q = quantize(v[e], per_channel ? inv[e] : inv[0]);
      word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * b);
    }
    dst[j] = word;
  }
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_out(float* out, int64_t i, float y) {
  out[i] = y;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* out, int64_t i,
                                          float y) {
  out[i] = __float2bfloat16_rn(y);
}

// TX: input element type; TO: output element type (int32_t = accumulators).
template <typename TX, typename TO>
__global__ void __launch_bounds__(kThreads)
    conv2d_int8_kernel(Params p) {
  __shared__ __align__(16) uint8_t a_s[kBM * kRow];
  __shared__ __align__(16) uint8_t b_s[kBN * kRow];

  const TX* x = static_cast<const TX*>(p.x);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;        // mma group / thread in group
  const int wm = warp >> 1, wn = warp & 1;      // warp's quarter of the tile

  const int grp = blockIdx.z;
  const int cg = p.cin / p.groups;              // input channels per group
  const int og = p.cout / p.groups;             // output channels per group
  const int ktot = p.kh * p.kw * cg;
  const int64_t mtot = static_cast<int64_t>(p.n) * p.ho * p.wo;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // Each thread stages one im2col row (row = tid / 2) and one weight row,
  // half (16 bytes) of the 32-byte K slice each.
  const int row = tid >> 1, half = tid & 1;
  const int64_t m = m0 + row;
  const bool m_ok = m < mtot;
  int img = 0, oh = 0, ow = 0;
  if (m_ok) {
    img = static_cast<int>(m / (static_cast<int64_t>(p.ho) * p.wo));
    const int r = static_cast<int>(m - static_cast<int64_t>(img) * p.ho * p.wo);
    oh = r / p.wo;
    ow = r - oh * p.wo;
  }
  const int ih0 = oh * p.stride - p.pad_h, iw0 = ow * p.stride - p.pad_w;
  const int wrow = n0 + row;                    // weight row within the group
  const bool w_ok = wrow < og;
  const int8_t* wbase = p.wq + (static_cast<int64_t>(grp) * og + wrow) * ktot;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < ktot; k0 += kBK) {
    // ---- activations: quantize a 64 x 32 im2col slice into a_s ----
    uint32_t words[4] = {0u, 0u, 0u, 0u};
    if (p.x_fast) {
      // cg % 32 == 0: the slice is 32 channels of one tap
      const int tap = k0 / cg, c0 = k0 - tap * cg + half * 16;
      const int dh = tap / p.kw, dw = tap - dh * p.kw;
      const int ih = ih0 + dh * p.dil, iw = iw0 + dw * p.dil;
      if (m_ok && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w) {
        const int ch = grp * cg + c0;
        const int64_t off =
            ((static_cast<int64_t>(img) * p.h + ih) * p.w + iw) * p.cin + ch;
        quantize16(x + off, p.xinv + (p.per_channel ? ch : 0), p.per_channel,
                   words);
      }
    } else if (m_ok) {
#pragma unroll 4
      for (int e = 0; e < 16; ++e) {
        const int k = k0 + half * 16 + e;
        int q = 0;
        if (k < ktot) {
          const int tap = k / cg, c = k - tap * cg;
          const int dh = tap / p.kw, dw = tap - dh * p.kw;
          const int ih = ih0 + dh * p.dil, iw = iw0 + dw * p.dil;
          if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.w) {
            const int ch = grp * cg + c;
            const int64_t off =
                ((static_cast<int64_t>(img) * p.h + ih) * p.w + iw) * p.cin +
                ch;
            q = quantize(load_x(x, off), p.xinv[p.per_channel ? ch : 0]);
          }
        }
        words[e >> 2] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (e & 3));
      }
    }
    *reinterpret_cast<uint4*>(a_s + row * kRow + half * 16) =
        make_uint4(words[0], words[1], words[2], words[3]);

    // ---- weights: a 64 x 32 int8 slice into b_s (zero past K / C_out) ----
    uint4 wv = make_uint4(0u, 0u, 0u, 0u);
    const int kw0 = k0 + half * 16;
    if (w_ok) {
      if (p.w_fast) {
        // ktot % 16 == 0: the 16 bytes lie wholly inside or past K
        if (kw0 < ktot) wv = *reinterpret_cast<const uint4*>(wbase + kw0);
      } else {
        uint32_t ww[4] = {0u, 0u, 0u, 0u};
        for (int e = 0; e < 16; ++e) {
          const int k = kw0 + e;
          if (k < ktot) {
            ww[e >> 2] |= (static_cast<uint32_t>(
                               static_cast<uint8_t>(wbase[k])))
                          << (8 * (e & 3));
          }
        }
        wv = make_uint4(ww[0], ww[1], ww[2], ww[3]);
      }
    }
    *reinterpret_cast<uint4*>(b_s + row * kRow + half * 16) = wv;
    __syncthreads();

    // ---- products: each warp a 32 x 32 quarter, 2 x 4 mma of 16 x 8 ----
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* base = a_s + (wm * 32 + i * 16 + g) * kRow + t * 4;
      af[i][0] = *reinterpret_cast<const uint32_t*>(base);
      af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow);
      af[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* base = b_s + (wn * 32 + j * 8 + g) * kRow + t * 4;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(base);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0],
               bf[j][1]);
    __syncthreads();
  }

  // ---- epilogue: dequantize (two roundings) and store NHWC ----
  TO* out = static_cast<TO*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t mo = m0 + wm * 32 + i * 16 + g + hr * 8;
      if (mo >= mtot) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + j * 8 + t * 2 + e;
          if (col >= og) continue;
          const int o = grp * og + col;
          const int64_t idx = mo * p.cout + o;
          const int a = acc[i][j][hr * 2 + e];
          if constexpr (std::is_same<TO, int32_t>::value) {
            // int32 accumulators (the debug entry)
            out[idx] = a;
          } else {
            const float y =
                __fadd_rn(__fmul_rn(__int2float_rn(a), p.osc[o]), p.fb[o]);
            store_out(out, idx, y);
          }
        }
      }
    }
  }
}

template <typename TX, typename TO>
int launch(const Params& p, cudaStream_t stream) {
  const int64_t mtot = static_cast<int64_t>(p.n) * p.ho * p.wo;
  const int og = p.cout / p.groups;
  dim3 grid(static_cast<unsigned>((mtot + kBM - 1) / kBM),
            static_cast<unsigned>((og + kBN - 1) / kBN),
            static_cast<unsigned>(p.groups));
  conv2d_int8_kernel<TX, TO><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace general
}  // namespace

// ===========================================================================
// The wgmma route (sm_90a): the R-50 body and its stem.
// ===========================================================================
namespace hop {

constexpr int kThreads = 384;     // warpgroup 0 loads, 1 and 2 compute
constexpr int kBM = 128;          // output pixels per tile (64 per consumer)
constexpr int kBK = 64;           // K per ring stage: 64 bf16 channels
constexpr int kABytes = kBM * 128;  // one bf16 activation box, 128-B rows
constexpr int kMaxStages = 6;
constexpr int kSmemBudget = 200 * 1024;
constexpr int kStemB = 4 * 64 * 64;  // the stem's weights, 4 SW64 tiles
constexpr int kSms = 132;         // the H100's SMs, for the N-tile choice
constexpr int kQuantCycles = 448; // one stage's quantize, cycles per SMSP
// the kernel's two ways to feed A (the route's kind)
constexpr int kTap = 0;           // one TMA box per tap and 64 channels
constexpr int kStem = 1;          // the stem's input rows, K per kernel row

struct Params {
  const float* xinv;
  const float* osc;
  const float* fb;
  const int8_t* wq;               // the stem's weights (body: TMA)
  int cin, cout, kh, kw, stride, dil, pad_h, pad_w;
  int bw, bh, bimg, log_bw;       // a tile's output pixels as a box
  int tw, th;                     // tiles along w and h
  int n_tiles, tiles;             // N tiles, all tiles (N tiles fastest)
  int ksteps, csteps;             // ring stages per tile; cin / 64
  int stages, per_channel;
  int sub_w, sub_h, sub_n;        // consumer 1's offset in the tile box
  int rows_in, row_floats, box_w, nbox, stage_bytes;  // the stem's ring
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait that never
// ends (a wrong parity or byte count) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 27)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* m, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}


__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// K-major operand, 64-byte swizzle (rows of 64 int8, 8-row atoms of 512 B):
// start address, leading offset (unused when swizzled), stride offset 512 B
// between 8-row groups, layout type 2 (64 B).
__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// The byte address TMA's 64-byte swizzle gives offset `off` of a tile.
__device__ __forceinline__ int swz64(int off) {
  return off ^ (((off >> 7) & 3) << 4);
}

// m64nNk32 s8 x s8 -> s32, A from registers, B (K-major) from shared memory.
// d[4j + 0, 1] hold row 16 * warp + lane / 4, columns 8j + 2 (lane % 4) + 0, 1;
// d[4j + 2, 3] the same columns 8 rows lower.  scale_d 0 overwrites d.
#define PPS_ACC64(d) \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
  "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), \
  "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
  "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
  "+r"(d[30]), "+r"(d[31])

#define PPS_ACC128(d) \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
  "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), \
  "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
  "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
  "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
  "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), \
  "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
  "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), \
  "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

#define PPS_ACC256(d) \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
  "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), \
  "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
  "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
  "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
  "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), \
  "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
  "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), \
  "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), \
  "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
  "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), \
  "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), \
  "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), \
  "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), \
  "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), \
  "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), \
  "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), \
  "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
  "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), \
  "+r"(d[126]), "+r"(d[127])

__device__ __forceinline__ void wgmma_n64(uint32_t* d, const uint32_t* a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : PPS_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(uint32_t* d, const uint32_t* a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : PPS_ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(uint32_t* d, const uint32_t* a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : PPS_ACC256(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void wgmma(uint32_t* d, const uint32_t* a,
                                      uint64_t desc_b, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_n64(d, a, desc_b, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, a, desc_b, scale_d);
  } else {
    wgmma_n256(d, a, desc_b, scale_d);
  }
}

// q = clamp(rint(v * inv), -127, 127) as the low byte of a float's bits:
// clamping first is the same (rint is monotone, the bounds are integers),
// and adding 1.5 * 2^23 rounds to the nearest integer, ties to even, into
// the mantissa's low bits (no float -> int conversion, a slow instruction).
__device__ __forceinline__ uint32_t qbits(float v, float inv) {
  float r = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(r, 12582912.0f));
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// four consecutive bf16 channels (8 bytes) -> four int8 in one word
__device__ __forceinline__ uint32_t quant_bf16x4(uint2 raw, const float* inv) {
  return pack4(qbits(__uint_as_float(raw.x << 16), inv[0]),
               qbits(__uint_as_float(raw.x & 0xffff0000u), inv[1]),
               qbits(__uint_as_float(raw.y << 16), inv[2]),
               qbits(__uint_as_float(raw.y & 0xffff0000u), inv[3]));
}

// Dequantize a consumer's 64 x BN accumulators into its staging tile (the
// output dtype, 128-byte rows in the 128-byte swizzle, one box per 128
// bytes of channels) and store it with TMA; the store clips what lies past
// the output's edges.  The staging is reused only after the previous
// store has read it.
template <int BN, typename TO>
__device__ __forceinline__ void epilogue(const uint32_t* acc, uint8_t* stg,
                                         const CUtensorMap* omap,
                                         const Params& p, int n0, int ow,
                                         int oh, int img, int wg, int w,
                                         int g, int t, bool leader) {
  constexpr int kES = sizeof(TO);
  constexpr int kBoxC = 128 / kES;                  // channels per box
  if (leader) bulk_wait_read();
  __syncwarp();  // bar.sync counts whole warps: arrive converged
  named_sync(1 + wg);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * t;                   // column in the tile
    const int col = n0 + cl;
    float s0 = 0.f, s1 = 0.f, f0 = 0.f, f1 = 0.f;
    if constexpr (!std::is_same<TO, int32_t>::value) {
      if (col < p.cout) {                           // cout is even
        s0 = __ldg(p.osc + col);
        s1 = __ldg(p.osc + col + 1);
        f0 = __ldg(p.fb + col);
        f1 = __ldg(p.fb + col + 1);
      }
    }
    const int inner = (cl % kBoxC) * kES;           // byte within the row
    uint8_t* box = stg + (cl / kBoxC) * (64 * 128);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = 16 * w + g + 8 * rr;          // row % 8 == g
      uint8_t* dst = box + row * 128 + ((((inner >> 4) ^ g)) << 4) +
                     (inner & 15);
      const uint32_t a0 = acc[4 * j + 2 * rr], a1 = acc[4 * j + 2 * rr + 1];
      if constexpr (std::is_same<TO, int32_t>::value) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(a0, a1);
      } else {
        const float y0 = __fadd_rn(
            __fmul_rn(__int2float_rn(static_cast<int>(a0)), s0), f0);
        const float y1 = __fadd_rn(
            __fmul_rn(__int2float_rn(static_cast<int>(a1)), s1), f1);
        if constexpr (std::is_same<TO, float>::value) {
          *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
        } else {
          __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
          *reinterpret_cast<__nv_bfloat162*>(dst) = v;
        }
      }
    }
  }
  fence_proxy_async();
  __syncwarp();
  named_sync(1 + wg);
  if (leader) {
    const uint32_t s = smem_u32(stg);
#pragma unroll
    for (int b = 0; b < BN / kBoxC; ++b)
      tma_store_4d(omap, s + b * (64 * 128), n0 + b * kBoxC, ow, oh, img);
    bulk_commit();
  }
  __syncwarp();
}

// Persistent CTAs walk the tiles (N tiles of one tile row back to back, so
// its activations are re-read from L2).  Warpgroup 0's first thread keeps
// the ring of `stages` full with TMA; warpgroups 1 and 2 each take 64 of a
// tile's 128 rows: read the bf16 box, quantize into wgmma's A registers,
// multiply against the int8 weights in shared memory, then the epilogue.
// (ptxas still budgets 168 registers a thread, so BN 256 spills a little
// and ptxas serializes its wgmmas; a lone producer warp, 288 threads, kept
// the same budget and measured slower.)
template <int BN, int MODE, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    conv2d_int8_wgmma(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap omap,
                      const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sb = smem_u32(base);
  const uint32_t full0 = sb, empty0 = sb + 64;    // 8 barriers of 8 bytes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // tap: A stages, B stages, staging; stem: B, x stages, staging
  constexpr bool STEM = MODE == kStem;
  uint8_t* ring = base + 1024;
  uint8_t* stem_b = ring;
  uint8_t* b_ring = ring + p.stages * kABytes;
  uint8_t* x_ring = ring + kStemB;
  uint8_t* staging = STEM ? x_ring + p.stages * p.stage_bytes
                          : ring + p.stages * (kABytes + BN * kBK);

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 8);               // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (STEM) {
    // The stem's weights, K laid out per kernel row: row kh of output
    // channel n holds its kw * cin weights at bytes 0.. of a 32-byte slot,
    // zero after (the input side reads any value there: q * 0 = 0).  Two
    // slots per 64-byte row of an SW64 tile; kh <= 8 needs 4 tiles.
    const int krow = p.kw * p.cin;
    for (int i = threadIdx.x; i < kStemB; i += kThreads) {
      const int tile = i >> 12, rem = i & 4095;
      const int n = rem >> 6, b = rem & 63;
      const int dh = 2 * tile + (b >> 5), kk = b & 31;
      int8_t v = 0;
      if (n < p.cout && dh < p.kh && kk < krow)
        v = p.wq[(n * p.kh + dh) * krow + kk];
      stem_b[tile * 4096 + swz64(n * 64 + b)] = static_cast<uint8_t>(v);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int mt = tile / p.n_tiles, nt = tile - mt * p.n_tiles;
        const int wb = mt % p.tw, rest = mt / p.tw;
        const int hb = rest % p.th, nb = rest / p.th;
        const int iw0 = wb * p.bw * p.stride - p.pad_w;
        const int ih0 = hb * p.bh * p.stride - p.pad_h;
        const int n0 = nb * p.bimg;
        if constexpr (STEM) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, p.rows_in * p.nbox * p.box_w * 4);
          const uint32_t dst = smem_u32(x_ring + stage * p.stage_bytes);
          // a box's first float must sit on 16 bytes: start up to 3 early
          const int c0 = iw0 * p.cin - ((iw0 * p.cin) & 3);
          for (int r = 0; r < p.rows_in; ++r)
            for (int b = 0; b < p.nbox; ++b)
              tma_load_3d(dst + (r * p.row_floats + b * p.box_w) * 4, &xmap,
                          full, c0 + b * p.box_w, ih0 + r, n0);
          if (++stage == p.stages) { stage = 0; phase ^= 1; }
        } else {
          for (int ks = 0; ks < p.ksteps; ++ks) {
            const int tap = ks / p.csteps, cb = ks - tap * p.csteps;
            const int dh = tap / p.kw, dw = tap - dh * p.kw;
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            const uint32_t full = full0 + 8 * stage;
            mbar_expect_tx(full, kABytes + BN * kBK);
            tma_load_4d(smem_u32(ring + stage * kABytes), &xmap, full,
                        cb * kBK, iw0 + dw * p.dil, ih0 + dh * p.dil, n0);
            tma_load_2d(smem_u32(b_ring + stage * (BN * kBK)), &wmap, full,
                        ks * kBK, nt * BN);
            if (++stage == p.stages) { stage = 0; phase ^= 1; }
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4 - 1, w = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;
    const int r0 = 64 * wg + 16 * w + g;          // rows r0 and r0 + 8
    uint8_t* stg = staging + wg * (64 * BN * static_cast<int>(sizeof(TO)));
    const float inv0 = p.per_channel ? 0.f : __ldg(p.xinv);
    int stage = 0;
    uint32_t phase = 0;
    uint32_t acc[BN / 2];

    // the stem: each of this thread's 16 K slots (k = 4t + e, 16 + 4t + e
    // of a kernel row) as an offset into a staged input row, and its scale
    int colofs[16];
    float sinv[16];
    int rowpos[2] = {0, 0};
    if constexpr (STEM) {
      const int krow = p.kw * p.cin;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 16 * h2 + 4 * t + e;
          const int c = kk % p.cin, dw = kk / p.cin;
          colofs[4 * h2 + e] = kk < krow ? dw * p.dil * p.cin + c : 0;
          sinv[4 * h2 + e] = p.per_channel ? __ldg(p.xinv + c) : inv0;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + 8 * rr;
        const int ohl = r >> p.log_bw, owl = r & (p.bw - 1);
        rowpos[rr] = ohl * p.stride * p.row_floats + owl * p.stride * p.cin;
      }
    }

    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int mt = tile / p.n_tiles, nt = tile - mt * p.n_tiles;
      const int wb = mt % p.tw, rest = mt / p.tw;
      const int hb = rest % p.th, nb = rest / p.th;
      if constexpr (STEM) {
        mbar_wait(full0 + 8 * stage, phase);
        __syncwarp();  // wgmma's .aligned instructions need whole warps
        const int lead = ((wb * p.bw * p.stride - p.pad_w) * p.cin) & 3;
        const float* xs =
            reinterpret_cast<const float*>(x_ring + stage * p.stage_bytes) +
            lead;
        const uint32_t bs = smem_u32(stem_b);
        // one kernel row: gather and quantize its 32 K values into `a`
        // (rewritten only after the products that read it completed: the
        // wait<1> of the row before), then one k32 product
        auto stem_row = [&](int dh, uint32_t(&a)[4]) {
          const int roff = dh * p.dil * p.row_floats;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float* src = xs + rowpos[rr] + roff;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              uint32_t q[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                q[e] = qbits(src[colofs[4 * h2 + e]], sinv[4 * h2 + e]);
              a[rr + 2 * h2] = pack4(q[0], q[1], q[2], q[3]);
            }
          }
          wg_fence();
          wgmma<BN>(acc, a,
                    desc_sw64(bs + (dh >> 1) * 4096 + (dh & 1) * 32),
                    dh > 0);
          wg_commit();
          wg_wait<1>();
        };
        uint32_t a0[4], a1[4];  // A fragments of two rows in flight
        int dh = 0;
        for (; dh + 1 < p.kh; dh += 2) {
          stem_row(dh, a0);
          stem_row(dh + 1, a1);
        }
        if (dh < p.kh) stem_row(dh, a0);
        wg_wait<0>();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        __syncwarp();
        if (++stage == p.stages) { stage = 0; phase ^= 1; }
      } else {
        int prev = 0;
        // one ring stage: quantize the bf16 box into `a` (rewritten only
        // after the products that read it completed: the wait<1> of the
        // stage before), two k32 products, then release the stage before
        auto body_stage = [&](int ks, uint32_t(&a)[2][4]) {
          float inv[16];
          if (p.per_channel) {
            const int cb = ks % p.csteps;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                inv[4 * j + e] = __ldg(p.xinv + cb * kBK + 16 * j + 4 * t + e);
          } else {
#pragma unroll
            for (int i = 0; i < 16; ++i) inv[i] = inv0;
          }
          mbar_wait(full0 + 8 * stage, phase);
          __syncwarp();  // wgmma's .aligned instructions need whole warps
          const uint8_t* as = ring + stage * kABytes;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const uint8_t* row = as + (r0 + 8 * rr) * 128 + ((t & 1) << 3);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint2 raw = *reinterpret_cast<const uint2*>(
                  row + (((2 * j + (t >> 1)) ^ g) << 4));
              // j = 2s + h: k32 step s, register rr + 2h
              a[j >> 1][rr + 2 * (j & 1)] = quant_bf16x4(raw, inv + 4 * j);
            }
          }
          const uint32_t bs = smem_u32(b_ring + stage * (BN * kBK));
          wg_fence();
          wgmma<BN>(acc, a[0], desc_sw64(bs), ks > 0);
          wgmma<BN>(acc, a[1], desc_sw64(bs + 32), 1);
          wg_commit();
          if (ks > 0) {
            wg_wait<1>();
            if (lane == 0) mbar_arrive(empty0 + 8 * prev);
            __syncwarp();
          }
          prev = stage;
          if (++stage == p.stages) { stage = 0; phase ^= 1; }
        };
        uint32_t a0[2][4], a1[2][4];  // A fragments of two stages in flight
        int ks = 0;
        for (; ks + 1 < p.ksteps; ks += 2) {
          body_stage(ks, a0);
          body_stage(ks + 1, a1);
        }
        if (ks < p.ksteps) body_stage(ks, a0);
        wg_wait<0>();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        __syncwarp();
      }
      epilogue<BN, TO>(acc, stg, &omap, p, nt * BN,
                       wb * p.bw + wg * p.sub_w, hb * p.bh + wg * p.sub_h,
                       nb * p.bimg + wg * p.sub_n, wg, w, g, t, leader);
    }
    if (leader) bulk_wait_all();
  }
}

}  // namespace hop

// ===========================================================================
// Host side: the route, the tensor maps, the launches.
// ===========================================================================
namespace {

// The stem route's ring stage: the input rows a tile of bh x bw output
// pixels needs (rows_in), and one row's span of (w * c) floats as nbox
// boxes of box_w floats (a multiple of 32, so each box starts 128-byte
// aligned in shared memory).  False when a stage would not fit.
bool stem_boxes(int bw, int bh, int cin, int kh, int kw, int stride, int dil,
                int* rows_in, int* box_w, int* nbox) {
  const int rows = (bh - 1) * stride + (kh - 1) * dil + 1;
  // + 3: a box starts on 16 bytes, up to 3 floats before the first needed
  const int span = ((bw - 1) * stride + (kw - 1) * dil + 1) * cin + 3;
  int nb = (span + 255) / 256, width = 0;
  for (;; ++nb) {
    width = ((span + nb - 1) / nb + 31) / 32 * 32;
    if (width <= 256) break;
  }
  if (rows > 256 || nb > 4 || rows * nb * width * 4 > 32768) return false;
  *rows_in = rows;
  *box_w = width;
  *nbox = nb;
  return true;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The route a conv takes, by shape alone (kernels/conv2d_int8.py:route is
// the same function in Python).  kind 0: the general kernel; 1: the wgmma
// body (bf16 x, C_in % 64 == 0); 2: the wgmma stem (float32 x, one kernel
// row's C_in * KW <= 32 values).  Tiles are 128 output pixels as a box of
// bw x bh x bimg (width, height, images) over (n, ho, wo): for a 1x1
// stride-1 conv the pixels are one row, n * h * w wide.
struct Route {
  int kind, bn, bw, bh, bimg;
  int n, ho, wo;                // the output as the tiles see it
  int m_tiles, n_tiles;
};

Route choose_route(int x_dtype, int n, int h, int w, int cin, int cout,
                   int kh, int kw, int stride, int dil, int groups) {
  Route r{};
  const int ph = ((kh - 1) * dil) / 2, pw = ((kw - 1) * dil) / 2;
  const int ho = (h + 2 * ph - dil * (kh - 1) - 1) / stride + 1;
  const int wo = (w + 2 * pw - dil * (kw - 1) - 1) / stride + 1;
  if (groups != 1 || cout % 8 != 0 || ho <= 0 || wo <= 0) return r;
  if (x_dtype == 1 && cin % hop::kBK == 0 && stride <= 8) {
    const bool flat = kh == 1 && kw == 1 && stride == 1;
    r.n = flat ? 1 : n;
    r.ho = flat ? 1 : ho;
    r.wo = flat ? n * ho * wo : wo;
    const int s = flat ? 1 : stride;
    int64_t best = -1;
    for (int lw = 7; lw >= 0; --lw) {
      for (int lh = 7 - lw; lh >= 0; --lh) {
        const int bw = 1 << lw, bh = 1 << lh, bimg = 128 >> (lw + lh);
        if (bw * s > 256 || bh * s > 256) continue;
        const int64_t tiles =
            cdiv(r.wo, bw) * cdiv(r.ho, bh) * cdiv(r.n, bimg);
        if (best < 0 || tiles < best) {
          best = tiles;
          r.bw = bw;
          r.bh = bh;
          r.bimg = bimg;
        }
      }
    }
    r.m_tiles = static_cast<int>(best);
    const int ksteps = kh * kw * cin / hop::kBK;
    int64_t best_cost = -1;
    for (int bn = 256; bn >= 64; bn /= 2) {
      if (bn > 64 && bn >= 2 * cout) continue;
      const int64_t tiles = r.m_tiles * cdiv(cout, bn);
      const int q = 2 * bn + 64;
      const int64_t cost =
          cdiv(tiles, hop::kSms) *
          (ksteps * static_cast<int64_t>(q > hop::kQuantCycles
                                             ? q
                                             : hop::kQuantCycles) +
           8 * bn);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        r.bn = bn;
      }
    }
    r.n_tiles = static_cast<int>(cdiv(cout, r.bn));
    r.kind = 1;
    return r;
  }
  if (x_dtype == 0 && cin * kw <= 32 && kh <= 8 && cout <= 64 &&
      (w * cin) % 4 == 0) {
    r.n = n;
    r.ho = ho;
    r.wo = wo;
    int64_t best = -1;
    for (int lw = 7; lw >= 0; --lw) {
      const int bw = 1 << lw, bh = 128 >> lw;
      int rows_in, box_w, nbox;
      if (!stem_boxes(bw, bh, cin, kh, kw, stride, dil, &rows_in, &box_w,
                      &nbox))
        continue;
      const int64_t tiles = cdiv(wo, bw) * cdiv(ho, bh) * n;
      if (best < 0 || tiles < best) {
        best = tiles;
        r.bw = bw;
        r.bh = bh;
        r.bimg = 1;
      }
    }
    if (best < 0) return r;
    r.m_tiles = static_cast<int>(best);
    r.bn = 64;
    r.n_tiles = 1;
    r.kind = 2;
  }
  return r;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched at run time with cudaGetDriverEntryPoint
// (the library links no libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

bool encode(CUtensorMap* m, CUtensorMapDataType dt, int rank, const void* ptr,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, const cuuint32_t* estr,
            CUtensorMapSwizzle sw) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  return fn(m, dt, rank, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device and its SM count (queried once per device).
int sm_count(int* dev) {
  static int counts[64];
  if (cudaGetDevice(dev) != cudaSuccess || *dev < 0 || *dev >= 64) {
    *dev = 0;
    return hop::kSms;
  }
  if (counts[*dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, *dev) !=
            cudaSuccess ||
        v <= 0)
      return hop::kSms;
    counts[*dev] = v;
  }
  return counts[*dev];
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <int BN, int MODE, typename TO>
int launch_wgmma(const Route& r, const general::Params& g, cudaStream_t s) {
  constexpr int kES = sizeof(TO);
  constexpr bool STEM = MODE == hop::kStem;
  hop::Params p{};
  p.xinv = g.xinv;
  p.osc = g.osc;
  p.fb = g.fb;
  p.wq = g.wq;
  p.cin = g.cin;
  p.cout = g.cout;
  p.kh = g.kh;
  p.kw = g.kw;
  p.stride = g.stride;
  p.dil = g.dil;
  p.pad_h = g.pad_h;
  p.pad_w = g.pad_w;
  p.bw = r.bw;
  p.bh = r.bh;
  p.bimg = r.bimg;
  p.log_bw = log2i(r.bw);
  p.tw = static_cast<int>(cdiv(r.wo, r.bw));
  p.th = static_cast<int>(cdiv(r.ho, r.bh));
  p.n_tiles = r.n_tiles;
  p.tiles = r.m_tiles * r.n_tiles;
  p.per_channel = g.per_channel;
  // consumer 1 takes the second half of the box's outermost dimension
  if (r.bimg > 1) {
    p.sub_n = r.bimg / 2;
  } else if (r.bh > 1) {
    p.sub_h = r.bh / 2;
  } else {
    p.sub_w = r.bw / 2;
  }
  const int staging = 2 * 64 * BN * kES;
  CUtensorMap xm, wm, om;
  memset(&wm, 0, sizeof(wm));
  const cuuint32_t one4[4] = {1, 1, 1, 1};
  if constexpr (STEM) {
    if (!stem_boxes(r.bw, r.bh, g.cin, g.kh, g.kw, g.stride, g.dil,
                    &p.rows_in, &p.box_w, &p.nbox))
      return -1;
    p.row_floats = p.nbox * p.box_w;
    p.stage_bytes =
        static_cast<int>(cdiv(p.rows_in * p.row_floats * 4, 1024) * 1024);
    p.stages = (hop::kSmemBudget - hop::kStemB - staging) / p.stage_bytes;
    // x as [n][h][w * c] float32, one box of box_w floats of one row
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(g.w) * g.cin,
                                static_cast<cuuint64_t>(g.h),
                                static_cast<cuuint64_t>(g.n)};
    const cuuint64_t strides[2] = {dims[0] * 4, dims[0] * 4 * g.h};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(p.box_w), 1, 1};
    if (!encode(&xm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, g.x, dims, strides,
                box, one4, CU_TENSOR_MAP_SWIZZLE_NONE))
      return -2;
  } else {
    p.csteps = g.cin / hop::kBK;
    p.ksteps = g.kh * g.kw * p.csteps;
    p.stages = (hop::kSmemBudget - staging) / (hop::kABytes + BN * hop::kBK);
    const bool flat = r.n == 1 && r.ho == 1 && g.kh == 1 && g.kw == 1 &&
                      g.stride == 1;
    // x as NHWC bf16 (a 1x1 stride-1 conv: one row of n * h * w pixels);
    // a box is 64 channels of bw x bh x bimg pixels, strided by the conv's
    // stride, with zeros where it hangs past an edge (the padding)
    const cuuint64_t xw = flat ? static_cast<cuuint64_t>(g.n) * g.h * g.w
                               : static_cast<cuuint64_t>(g.w);
    const cuuint64_t xh = flat ? 1 : g.h, xn = flat ? 1 : g.n;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g.cin), xw, xh, xn};
    const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * 2 * xw,
                                   dims[0] * 2 * xw * xh};
    const int s = flat ? 1 : g.stride;
    const cuuint32_t box[4] = {hop::kBK, static_cast<cuuint32_t>(r.bw * s),
                               static_cast<cuuint32_t>(r.bh * s),
                               static_cast<cuuint32_t>(r.bimg)};
    const cuuint32_t estr[4] = {1, static_cast<cuuint32_t>(s),
                                static_cast<cuuint32_t>(s), 1};
    if (!encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, g.x, dims, strides,
                box, estr, CU_TENSOR_MAP_SWIZZLE_128B))
      return -2;
    // the weights as [cout][K] int8, K = kh * kw * cin; 64 of K per box
    const int64_t ktot = static_cast<int64_t>(g.kh) * g.kw * g.cin;
    const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(ktot),
                                 static_cast<cuuint64_t>(g.cout)};
    const cuuint64_t wstr[1] = {static_cast<cuuint64_t>(ktot)};
    const cuuint32_t wbox[2] = {hop::kBK, BN};
    if (!encode(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, g.wq, wdims, wstr,
                wbox, one4, CU_TENSOR_MAP_SWIZZLE_64B))
      return -2;
  }
  if (p.stages > hop::kMaxStages) p.stages = hop::kMaxStages;
  if (p.stages < 2) return -1;
  // the output as NHWC (the tiles' view); one box per 128 bytes of
  // channels of half a tile
  {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g.cout),
                                static_cast<cuuint64_t>(r.wo),
                                static_cast<cuuint64_t>(r.ho),
                                static_cast<cuuint64_t>(r.n)};
    const cuuint64_t strides[3] = {dims[0] * kES, dims[0] * kES * dims[1],
                                   dims[0] * kES * dims[1] * dims[2]};
    const cuuint32_t box[4] = {
        static_cast<cuuint32_t>(128 / kES),
        static_cast<cuuint32_t>(p.sub_w ? r.bw / 2 : r.bw),
        static_cast<cuuint32_t>(p.sub_h ? r.bh / 2 : r.bh),
        static_cast<cuuint32_t>(p.sub_n ? r.bimg / 2 : r.bimg)};
    const CUtensorMapDataType dt =
        std::is_same<TO, float>::value   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
        : std::is_same<TO, int32_t>::value ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!encode(&om, dt, 4, g.out, dims, strides, box, one4,
                CU_TENSOR_MAP_SWIZZLE_128B))
      return -2;
  }
  const int ring = STEM ? hop::kStemB + p.stages * p.stage_bytes
                        : p.stages * (hop::kABytes + BN * hop::kBK);
  const size_t smem = 2048 + ring + staging;
  auto kernel = hop::conv2d_int8_wgmma<BN, MODE, TO>;
  // the shared memory a launch may ask for, raised once per device to the
  // most any call of this instantiation asks (the largest ring)
  static size_t granted[64];
  int dev = 0;
  const int sms = sm_count(&dev);
  if (granted[dev] < smem) {
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(hop::kSmemBudget + 2048));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted[dev] = hop::kSmemBudget + 2048;
  }
  const int grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<grid, hop::kThreads, smem, s>>>(xm, wm, om, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_route(const Route& r, const general::Params& g, cudaStream_t s) {
  if (r.kind == 2) return launch_wgmma<64, hop::kStem, TO>(r, g, s);
  if (r.bn == 256) return launch_wgmma<256, hop::kTap, TO>(r, g, s);
  if (r.bn == 128) return launch_wgmma<128, hop::kTap, TO>(r, g, s);
  return launch_wgmma<64, hop::kTap, TO>(r, g, s);
}

}  // namespace

// The route pps_conv2d_int8 takes for a shape: writes {kind, bn, bw, bh,
// bimg, m_tiles, n_tiles} to out7 and returns kind (0 general, 1 wgmma
// body, 2 wgmma stem).  x_dtype as for pps_conv2d_int8.
extern "C" int pps_conv2d_int8_route(int x_dtype, int n, int h, int w,
                                     int cin, int cout, int kh, int kw,
                                     int stride, int dil, int groups,
                                     int* out7) {
  const Route r =
      choose_route(x_dtype, n, h, w, cin, cout, kh, kw, stride, dil, groups);
  const int v[7] = {r.kind, r.bn, r.bw, r.bh, r.bimg, r.m_tiles, r.n_tiles};
  for (int i = 0; i < 7; ++i) out7[i] = v[i];
  return r.kind;
}

// x_dtype: 0 float32, 1 bfloat16.  out_dtype: 0 float32, 1 bfloat16,
// 2 int32 accumulators (osc and fb unused).  Returns a cudaError_t (0 on
// success), -1 for arguments the kernel does not take, -2 when a TMA
// tensor map cannot be made.
extern "C" int pps_conv2d_int8(const void* x, int x_dtype, const float* xinv,
                               int per_channel, const int8_t* wq,
                               const float* osc, const float* fb, void* out,
                               int out_dtype, int n, int h, int w, int cin,
                               int cout, int kh, int kw, int stride, int dil,
                               int groups, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || dil <= 0 || groups <= 0 ||
      cin % groups != 0 || cout % groups != 0) {
    return -1;
  }
  general::Params p;
  p.x = x;
  p.xinv = xinv;
  p.wq = wq;
  p.osc = osc;
  p.fb = fb;
  p.out = out;
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.dil = dil;
  p.groups = groups;
  p.pad_h = ((kh - 1) * dil) / 2;
  p.pad_w = ((kw - 1) * dil) / 2;
  p.ho = (h + 2 * p.pad_h - dil * (kh - 1) - 1) / stride + 1;
  p.wo = (w + 2 * p.pad_w - dil * (kw - 1) - 1) / stride + 1;
  p.per_channel = per_channel;
  const int cg = cin / groups;
  const int ktot = kh * kw * cg;
  // vector loads need 16-byte alignment: 16 channels of a pixel start on a
  // multiple of 16 elements when cg (and so cin) is a multiple of 32
  p.x_fast = (cg % general::kBK == 0) &&
             (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  p.w_fast = (ktot % 16 == 0) &&
             (reinterpret_cast<uintptr_t>(wq) % 16 == 0);
  if (p.ho <= 0 || p.wo <= 0) return -1;
  if (x_dtype != 0 && x_dtype != 1) return -1;
  if (out_dtype < 0 || out_dtype > 2) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Route r =
      choose_route(x_dtype, n, h, w, cin, cout, kh, kw, stride, dil, groups);
  if (r.kind != 0) {
    // TMA needs 16-byte aligned addresses (the wrapper provides them)
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
         reinterpret_cast<uintptr_t>(out)) % 16 != 0)
      return -1;
    if (out_dtype == 0) return launch_route<float>(r, p, s);
    if (out_dtype == 1) return launch_route<__nv_bfloat16>(r, p, s);
    return launch_route<int32_t>(r, p, s);
  }
  if (x_dtype == 0) {
    if (out_dtype == 0) return general::launch<float, float>(p, s);
    if (out_dtype == 1) return general::launch<float, __nv_bfloat16>(p, s);
    return general::launch<float, int32_t>(p, s);
  }
  if (out_dtype == 0) return general::launch<__nv_bfloat16, float>(p, s);
  if (out_dtype == 1) return general::launch<__nv_bfloat16, __nv_bfloat16>(p, s);
  return general::launch<__nv_bfloat16, int32_t>(p, s);
}
