// 3x3 'same' convolution + f32 bias + ReLU over NHWC tensors, one launch per
// stage of a conv chain.
//
// Replaces the Pallas TPU kernel unet_zoo_tpu/ops/pallas/conv_chain.py:
// fused_conv_chain (body _chain_kernel). Same semantics: zero padding, f32
// accumulation, bias and ReLU in the epilogue, the result rounded once to the
// input's dtype. The wrapper (unet_zoo_tpu_torch/ops/pallas/conv_chain.py)
// chains the stages and hands each launch weights already cast to the input
// dtype and laid out as (C_out_pad, 3, 3, C_in_pad), zero-padded.
//
// What bounds it on an H100. Per output pixel a stage does 2*9*C_in*C_out
// FLOPs and, at best, moves (C_in + C_out) activations through device memory.
// With C_in = C_out = C in bf16 that is 4.5*C FLOP/byte: 144 at C = 32 (the
// 128x128 levels, below the ~295 FLOP/byte bf16 ridge, so memory traffic is
// the floor there), 576 to 864 at C = 128..192 (compute-bound). Either floor
// needs the tensor cores fed from well-reused shared-memory tiles.
//
// What this first design does:
// * implicit GEMM, M = 128 output pixels (an 8x16 tile of one image),
//   N = 32 or 64 output channels, K = 9 taps x C_in streamed in chunks of 16
//   channels; the Pallas kernel's whole-image VMEM plan (~27 MB at
//   128x128x96) cannot fit the 227 KB of shared memory a block gets;
// * zero padding by masking the loads of the 10x18 halo tile at the image
//   edge: no padded copy of the input in device memory;
// * bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate), warp tile 32x32,
//   fragments read with 32-bit shared loads from rows padded to 48 bytes so a
//   warp's 32 reads hit 32 distinct banks; any C_in >= 1 (loads masked past
//   C_in, vectorised 16-byte loads when C_in % 8 == 0);
// * f32: CUDA-core FMA, 4 pixels x 8 channels a thread, so f32 results keep
//   full f32 precision (no TF32).
// What it leaves for later: stage fusion with per-tile halo recompute (each
// stage's output round-trips device memory here), reading the up path's two
// inputs without a concat, pool/resize folded into the loader, a cp.async or
// TMA pipeline (loads and MMAs do not overlap within a block here), wgmma,
// and a backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TH = 8;                       // output tile rows
constexpr int TW = 16;                      // output tile cols: 128 pixels a block
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;  // 180 input pixels a tile reads
constexpr int KC = 16;                      // input channels a K step (one k16 MMA per tap)

struct Shape {
  int batch, height, width, ci, ci_pad, co;
  int tiles_h, tiles_w;
};

struct Tile {
  int b, h0, w0;
};

__device__ __forceinline__ Tile tile_of(const Shape& s) {
  int t = blockIdx.x;
  Tile r;
  r.w0 = (t % s.tiles_w) * TW;
  t /= s.tiles_w;
  r.h0 = (t % s.tiles_h) * TH;
  r.b = t / s.tiles_h;
  return r;
}

__device__ __forceinline__ bool in_image(const Shape& s, int h, int w) {
  return h >= 0 && h < s.height && w >= 0 && w < s.width;
}

__device__ __forceinline__ int64_t pixel_index(const Shape& s, int b, int h, int w) {
  return (static_cast<int64_t>(b) * s.height + h) * s.width + w;
}

// ---------------------------------------------------------------- bf16, mma.sync

constexpr int LDS_BF16 = KC + 8;  // smem row stride in elements (48 bytes)

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// BN output channels a block; 4 x (BN/32) warps, each owning 2 output rows of
// the tile (two m16 tiles of 16 pixels) by 32 channels (four n8 tiles).
template <int BN>
__global__ void __launch_bounds__(4 * BN)
    conv3x3_bf16_mma(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                     Shape s, bool vec_loads) {
  constexpr int WARPS_N = BN / 32;
  constexpr int THREADS = 4 * BN;
  __shared__ __align__(16) uint16_t sx[HALO_PIX * LDS_BF16];  // [halo pixel][channel]
  __shared__ __align__(16) uint16_t sw[9 * BN * LDS_BF16];    // [tap][out channel][channel]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;  // mma fragment group and thread-in-group
  const Tile tile = tile_of(s);
  const int n0 = blockIdx.y * BN;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  for (int k0 = 0; k0 < s.ci_pad; k0 += KC) {
    // halo tile, 8 channels (16 bytes) an item; zeros outside the image and past C_in
    for (int i = tid; i < HALO_PIX * 2; i += THREADS) {
      const int p = i >> 1, c = k0 + (i & 1) * 8;
      const int h = tile.h0 + p / HALO_W - 1, wc = tile.w0 + p % HALO_W - 1;
      union {
        uint4 v;
        uint16_t e[8];
      } u;
      u.v = make_uint4(0, 0, 0, 0);
      if (in_image(s, h, wc) && c < s.ci) {
        const uint16_t* src = x + pixel_index(s, tile.b, h, wc) * s.ci + c;
        if (vec_loads) {
          u.v = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (c + j < s.ci) u.e[j] = src[j];
        }
      }
      *reinterpret_cast<uint4*>(&sx[p * LDS_BF16 + (i & 1) * 8]) = u.v;
    }
    // this chunk's 16 channels of every (tap, out channel) row
    for (int i = tid; i < 9 * BN * 2; i += THREADS) {
      const int row = i >> 1, half = i & 1;  // row = n * 9 + tap
      const int n = row / 9, tap = row % 9;
      const uint4 v = *reinterpret_cast<const uint4*>(
          w + (static_cast<int64_t>(n0 + n) * 9 + tap) * s.ci_pad + k0 + half * 8);
      *reinterpret_cast<uint4*>(&sw[(tap * BN + n) * LDS_BF16 + half * 8]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A rows: the 16 pixels of output row 2*warp_m+mi, i.e. halo pixels
        // (row + dy, col + dx); A cols: the chunk's channels
        const uint16_t* base =
            sx + ((2 * warp_m + mi + dy) * HALO_W + dx) * LDS_BF16 + 2 * t;
        a[mi][0] = lds32(base + g * LDS_BF16);
        a[mi][1] = lds32(base + (g + 8) * LDS_BF16);
        a[mi][2] = lds32(base + g * LDS_BF16 + 8);
        a[mi][3] = lds32(base + (g + 8) * LDS_BF16 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint16_t* base = sw + (tap * BN + warp_n * 32 + ni * 8 + g) * LDS_BF16 + 2 * t;
        b[ni][0] = lds32(base);
        b[ni][1] = lds32(base + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // epilogue: f32 bias, ReLU, one rounding to bf16
  const bool pairs = s.co % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int h = tile.h0 + 2 * warp_m + mi;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + warp_n * 32 + ni * 8 + 2 * t;
      if (n >= s.co) continue;
      const float b0 = bias[n];
      const float b1 = n + 1 < s.co ? bias[n + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // accumulator rows g and g + 8
        const int wc = tile.w0 + g + 8 * half;
        if (!in_image(s, h, wc)) continue;
        const float v0 = fmaxf(acc[mi][ni][2 * half] + b0, 0.f);
        const float v1 = fmaxf(acc[mi][ni][2 * half + 1] + b1, 0.f);
        __nv_bfloat16* dst = out + pixel_index(s, tile.b, h, wc) * s.co + n;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (n + 1 < s.co) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- f32, FMA

constexpr int BN_F32 = 32;
constexpr int LDS_F32 = KC + 1;  // odd stride: a warp's 8 pixel groups read 8 distinct banks

// 128 threads; thread = 4 consecutive pixels of one tile row x 8 out channels.
__global__ void __launch_bounds__(128)
    conv3x3_f32_fma(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, Shape s) {
  __shared__ float sx[HALO_PIX * LDS_F32];                 // [halo pixel][channel]
  __shared__ __align__(16) float sw[9 * KC * BN_F32];      // [tap][channel][out channel]

  const int tid = threadIdx.x;
  const int cg = tid & 3;                                  // out channels 8*cg .. 8*cg+7
  const int row = tid >> 4, col0 = ((tid >> 2) & 3) * 4;   // pixels (row, col0 .. col0+3)
  const Tile tile = tile_of(s);
  const int n0 = blockIdx.y * BN_F32;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s.ci_pad; k0 += KC) {
    for (int i = tid; i < HALO_PIX * KC; i += 128) {
      const int p = i / KC, c = k0 + i % KC;
      const int h = tile.h0 + p / HALO_W - 1, wc = tile.w0 + p % HALO_W - 1;
      sx[p * LDS_F32 + i % KC] =
          in_image(s, h, wc) && c < s.ci ? x[pixel_index(s, tile.b, h, wc) * s.ci + c] : 0.f;
    }
    for (int i = tid; i < 9 * KC * BN_F32; i += 128) {
      const int k = i % KC, r = i / KC;  // r = n * 9 + tap
      const int n = r / 9, tap = r % 9;
      sw[(tap * KC + k) * BN_F32 + n] =
          w[(static_cast<int64_t>(n0 + n) * 9 + tap) * s.ci_pad + k0 + k];
    }
    __syncthreads();

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* xs = sx + ((row + dy) * HALO_W + col0 + dx) * LDS_F32;
      const float* ws = sw + tap * KC * BN_F32 + cg * 8;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[i * LDS_F32 + k];
        const float4 wa = *reinterpret_cast<const float4*>(ws + k * BN_F32);
        const float4 wb = *reinterpret_cast<const float4*>(ws + k * BN_F32 + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int h = tile.h0 + row;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int wc = tile.w0 + col0 + i;
    if (!in_image(s, h, wc)) continue;
    float* dst = out + pixel_index(s, tile.b, h, wc) * s.co;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + cg * 8 + j;
      if (n < s.co) dst[n] = fmaxf(acc[i][j] + bias[n], 0.f);
    }
  }
}

}  // namespace

// One stage: out = relu(conv3x3(x, w) + bias). x (batch, height, width, ci)
// and out (batch, height, width, co) are contiguous NHWC in the dtype given
// (0 = float32, 1 = bfloat16); w is (co rounded up to 64, 3, 3, ci_pad) in
// the same dtype, zero past co and ci; bias is float32 (co,). Launches on
// `stream` of `device` and returns cudaGetLastError() (0 on success).
extern "C" int conv3x3_bias_relu(const void* x, const void* w, const void* bias, void* out,
                                 int batch, int height, int width, int ci, int ci_pad, int co,
                                 int dtype, int device, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || ci <= 0 || co <= 0 || ci_pad < ci ||
      ci_pad % KC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s{batch, height, width, ci, ci_pad, co, (height + TH - 1) / TH, (width + TW - 1) / TW};
  const long long blocks = static_cast<long long>(batch) * s.tiles_h * s.tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid_x = static_cast<unsigned>(blocks);
  if (dtype == 1) {
    const auto* xb = static_cast<const uint16_t*>(x);
    const auto* wb = static_cast<const uint16_t*>(w);
    const bool vec = ci % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    auto* ob = static_cast<__nv_bfloat16*>(out);
    const auto* bb = static_cast<const float*>(bias);
    if (co <= 32) {
      conv3x3_bf16_mma<32><<<dim3(grid_x, (co + 31) / 32), 128, 0, st>>>(xb, wb, bb, ob, s, vec);
    } else {
      conv3x3_bf16_mma<64><<<dim3(grid_x, (co + 63) / 64), 256, 0, st>>>(xb, wb, bb, ob, s, vec);
    }
  } else if (dtype == 0) {
    conv3x3_f32_fma<<<dim3(grid_x, (co + BN_F32 - 1) / BN_F32), 128, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
