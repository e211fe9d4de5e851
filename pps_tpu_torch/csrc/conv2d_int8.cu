// conv2d_int8: the int8 post-training-quantized convolution of the serving
// body, as one implicit GEMM with the activation quantize fused into its
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
// twice, as XLA does.  xinv is one scalar (BN-folded bodies) or one value
// per input channel (GroupNorm bodies, whose per-channel scales are already
// absorbed into wq).
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
// (the res2 maps dominate, ~0.05 ms each at 3.35 TB/s): the body as a
// whole is bound by bytes (~0.89 ms against ~0.38 ms of operations).
//
// Design (simple first; wgmma, TMA and a pipelined ring are later work):
// a CTA of 4 warps computes a 64 (output pixels) x 64 (output channels)
// tile of one group's GEMM, M = N*Ho*Wo, N = C_out/groups, K = KH*KW*C_in/
// groups, stepping K by 32.  Each step, the CTA quantizes a 64 x 32 slice
// of the im2col matrix into shared memory (16 channels a thread, one 16-
// or 64-byte vector load, when C_in/groups is a multiple of 32: the slice
// then sits inside one tap; element by element with bounds checks
// otherwise, as for the stem's K = 147, whose tail is zero-padded in
// shared memory) and copies a 64 x 32 int8 weight slice beside it; each
// warp then issues 8 mma.sync.m16n8k32 s8 x s8 -> s32 products on its
// 32 x 32 quarter.  Shared rows are padded to 48 bytes, so the fragment
// loads hit 32 distinct banks.  The epilogue applies osc and fb straight
// from the accumulator registers.
//
// Plain C interface, loaded with ctypes: the launch goes on the caller's
// stream, allocates nothing, does not synchronise, and the function
// returns cudaGetLastError() (or -1 for arguments it does not take).

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

// x_dtype: 0 float32, 1 bfloat16.  out_dtype: 0 float32, 1 bfloat16,
// 2 int32 accumulators (osc and fb unused).  Returns a cudaError_t (0 on
// success) or -1 for arguments the kernel does not take.
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
  Params p;
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
  p.x_fast = (cg % kBK == 0) &&
             (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  p.w_fast = (ktot % 16 == 0) &&
             (reinterpret_cast<uintptr_t>(wq) % 16 == 0);
  if (p.ho <= 0 || p.wo <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if (out_dtype == 0) return launch<float, float>(p, s);
    if (out_dtype == 1) return launch<float, __nv_bfloat16>(p, s);
    if (out_dtype == 2) return launch<float, int32_t>(p, s);
  } else if (x_dtype == 1) {
    if (out_dtype == 0) return launch<__nv_bfloat16, float>(p, s);
    if (out_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(p, s);
    if (out_dtype == 2) return launch<__nv_bfloat16, int32_t>(p, s);
  }
  return -1;
}
