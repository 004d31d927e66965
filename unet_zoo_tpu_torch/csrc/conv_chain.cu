// 3x3 'same' convolution + f32 bias + ReLU over NHWC tensors, one launch per
// stage of a conv chain.
//
// Replaces the Pallas TPU kernel unet_zoo_tpu/ops/pallas/conv_chain.py:
// fused_conv_chain (body _chain_kernel). Same semantics: zero padding, f32
// accumulation, bias and ReLU in the epilogue, the result rounded once to the
// input's dtype. The wrapper (unet_zoo_tpu_torch/ops/pallas/conv_chain.py)
// chains the stages, hands each launch weights already cast to the input
// dtype and laid out as (C_out_pad, 3, 3, C_in_pad), zero-padded (in f32
// twice: the tf32 hi and lo halves), and computes the launch plan (K chunk,
// output channels and rows a block, pipeline depth, shared memory, loader)
// that each launcher checks.
//
// What bounds it on an H100. Per output pixel a stage does 2*9*C_in*C_out
// FLOPs and, at best, moves (C_in + C_out) activations through device memory.
// With C_in = C_out = C in bf16 that is 4.5*C FLOP/byte: 144 at C = 32 (the
// 128x128 levels, below the ~295 FLOP/byte bf16 ridge, so memory traffic is
// the floor there), 576 to 864 at C = 128..192 (compute-bound). Either floor
// needs the tensor cores fed from shared memory while the next tiles load.
//
// The bf16 design (conv3x3_bf16_wgmma), an implicit GEMM per block:
// * M = 64 or 128 output pixels (a 4x16 or 8x16 tile of one image: one or
//   two consumer warpgroups, one m64 wgmma tile each), N = all of C_out in
//   one block up to 192 (wgmma n32/n64/n128/n192; wider C_out takes several
//   blocks along grid y), K = 9 taps x C_in in chunks of 16, 32 or 64 input
//   channels (32, 64 or 128-byte rows, with the TMA swizzle of that width).
// * Warp-specialised and persistent: as many blocks as fit on the card at
//   once walk the work items (tile, channel block). One producer warp keeps
//   loads in flight into two rings guarded by full/empty mbarriers, running
//   ahead into the next item: the input halo ((TH+2) x 18 pixels x one
//   chunk, reused by all 9 taps) and the weights (one (chunk, tap) tile of
//   N x chunk a stage; where all 9 * chunks tiles fit with two blocks an SM
//   they stay resident, loaded once a block). The consumers run
//   wgmma.mma_async with f32 accumulators in registers, one group in flight
//   while the next tap's A is fetched.
// * Input halo by TMA: a 4-D tiled tensor map over NHWC, box (chunk, 18,
//   TH+2, 1) at (c0, w0-1, h0-1, b). TMA fills the out-of-bounds elements,
//   negative coordinates and channels past C_in included, with zeros: that
//   is the 'same' padding, with no masks and no padded copy.
// * Weights by TMA: a 2-D map over the packed weights viewed as (C_out_pad,
//   9*C_in_pad), K-major; wgmma reads each tile through a shared-memory
//   descriptor of the matching swizzle.
// * Epilogue in registers: f32 bias, ReLU, one rounding to bf16, then 4-byte
//   stores of channel pairs, a lane quad writing 16 contiguous bytes. A quad
//   transpose into 16-byte stores cost more instructions than it saved: with
//   it gone and the clock read off the waits' fast path, a 32 -> 32 stage
//   went from 0.636 to 0.519 ms at bs512 on an NVIDIA H100 80GB HBM3 at 700 W
//   (tools/torch_conv_chain_stages.py).
// The traps, and which way each is solved:
// * A shifted tap is no plain descriptor slice of the halo: 16-pixel output
//   rows sit in 18-pixel halo rows, and a shift by dx moves the swizzle
//   phase. So A comes from registers: each lane gives ldmatrix the address
//   of its own (swizzled) halo row, and wgmma takes A from registers and B
//   from shared memory. Each input byte crosses L2 once a tile, not 9 times.
// * TMA needs 16-byte global strides: C_in % 8 != 0 (the U-Net's first
//   stage has C_in = 1) or an input not 16-byte aligned takes the plain
//   loader instead (load_halo_plain): the producer warp reads the halo with
//   masked 2-byte loads (cp.async copies 4 bytes at least, from aligned
//   addresses, so it cannot take a 2-byte pixel stride) and writes it in the
//   same swizzled layout, feeding the same wgmma body. The wrapper picks the
//   loader by shape and alignment; both count as a launch.
// * Nine taps' weights for one chunk do not fit beside the halo at N = 192
//   (221 KB), so the K loop runs over (chunk, tap) with the halo reused
//   across its 9 taps; above 48 KB of shared memory the kernel is opened up
//   to 227 KB with cudaFuncSetAttribute before its first launch on a device.
// * ptxas serializes wgmma, with only a line in its log, when the role
//   branch looks divergent (C7518) or an A register is redefined while a
//   wgmma that read it may be in flight (C7513). So the roles branch on a
//   shuffled, warp-uniform warp index, the mbarrier wait loops inside its
//   asm, and the last tap of a chunk drains the pipeline before the chunk
//   loop's next pass (chip_smoke.py fails on either warning).
// * An mbarrier arrive does not wait for an ldmatrix still in flight before
//   it (the SASS issues the arrive right behind the LDSM). Released right
//   after the last tap's ldmatrix, a halo stage could take the producer's
//   next TMA before that ldmatrix had read it: the U-Net's down1 block at
//   batch 512 went wrong in about 1 launch of 20, by up to 1.06
//   (tools/torch_conv_chain_repeats.py, NVIDIA H100 80GB HBM3 at 700 W).
//   So a consumer releases the halo stage only after the wgmmas that
//   consumed those registers are done, and chip_smoke.py holds every
//   block's repeated launches to one bit-identical result.
// * A pipeline fault must not hang the card: a wait that outlasts ~10 s
//   traps, and the launch reports an error.
// * Tensor maps hold the global address, so both are encoded on the host at
//   every launch, through cuTensorMapEncodeTiled taken from libcuda.so.1 with
//   dlopen (no -lcuda), and passed as __grid_constant__ parameters.
// * Small grids: the wrapper takes 4-row tiles (one consumer warpgroup) when
//   8-row tiles give fewer blocks than the card has SMs.
//
// The f32 design (conv3x3_f32_3xtf32_wgmma) replaces the same Pallas kernel
// in float32 (unet_zoo_tpu/ops/pallas/conv_chain.py:132 with f32 inputs),
// which the registered f32 experiments run (ProbUNet's 13 trunk blocks at
// 128x128 down to 2x2, the U-Net's 7). What bounds it: f32 FMA outside the
// tensor cores peaks at 67 TFLOP/s; TF32 on them at 494.7, but one TF32
// product keeps ~11 bits. 3xTF32 splits each operand into hi = tf32(v) and
// lo = tf32(v - hi) and sums lo*hi + hi*lo + hi*hi in f32 (lo*lo dropped):
// ~2^-21 relative a product, f32-level, at a third of the TF32 rate, ~165
// TFLOP/s: the operation floor. With C_in = C_out = C a stage does 2.25*C
// FLOPs a byte moved in f32, 72 at C = 32 and 144 at 64 (the 128x128 and
// 64x64 levels), against a ridge of ~49 at the 3xTF32 rate: there the
// bytes come within 1.5-3x of the floor, and the C_in = 1 stage is bound
// by them. The design:
// * the bf16 kernel's pipeline (TMA halo and weight rings, warp-specialised,
//   persistent), with k8 tf32 wgmmas over chunks of 8, 16 or 32 channels
//   (32, 64 or 128-byte rows, the TMA swizzle of that width);
// * B split once, at pack time, by the wrapper: a weight stage is the
//   (chunk, tap) tile's hi then lo half, two TMA boxes of a 3-D map;
// * A read with ldmatrix, which over f32 rows hands out the m64k8 tf32
//   fragment as it hands out the bf16 one over bf16 rows, and split in
//   registers (cvt.rna.tf32) into fresh registers per tap; the last tap of
//   a chunk drains the wgmma pipeline before the registers are reused;
// * small images: a tile of 64 rows a consumer warpgroup may hold several
//   whole images (H x W < 64: 16 of 2x2, 4 of 4x4), their halos one TMA box
//   (chunk, W + 2, H + 2, n_img) at (0, -1, -1, b0) whose zero fill pads
//   every image; where tiles x output-channel blocks leave SMs idle, the
//   plan takes one warpgroup a tile and then narrower channel blocks (down
//   to 32), so that the 2x2-8x8 levels spread over 6-72 blocks in place of
//   1-12 (no split of K: each block's K loop stays one pass);
// * C_in % 4 != 0 (the first stage's C_in = 1) or an unaligned input takes
//   the producer's plain loader (load_halo_plain_f32) into the same layout;
// * the tensor cores' f32 accumulation drops low bits at each wgmma, so
//   one accumulator over all of K drifted ~K * 1e-8 of max|out| (3.0e-5 at
//   K = 3456, NVIDIA H100 80GB HBM3 at 700 W): each K chunk sums into a
//   fresh accumulator that a rounded f32 add folds into the total, which
//   costs a second set of accumulators: with two taps of split A registers
//   they must fit the 168 registers a thread of a 288-thread block gets, so
//   channel blocks stop at 96 (C_out 128 and 192 take two blocks), and a
//   96-wide block takes 16-channel chunks.
// What it leaves for later: stage fusion with per-tile halo recompute (each
// stage's output round-trips device memory here), reading the up path's two
// inputs without a concat, pool/resize folded into the loader, and a
// hand-written backward.

#include <cuda.h>  // CUtensorMap and its enums; libcuda.so.1 itself is opened with dlopen
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int TW = 16;  // output tile cols
constexpr int HALO_W = TW + 2;

struct Shape {
  int batch, height, width, ci, ci_pad, co;
  int tile_h, tiles_h, tiles_w;
  int n_blocks;  // blocks of output channels a tile
};

struct Tile {
  int b, h0, w0;
};

__device__ __forceinline__ Tile tile_of(const Shape& s, int t) {
  Tile r;
  r.w0 = (t % s.tiles_w) * TW;
  t /= s.tiles_w;
  r.h0 = (t % s.tiles_h) * s.tile_h;
  r.b = t / s.tiles_h;
  return r;
}

__device__ __forceinline__ bool in_image(const Shape& s, int h, int w) {
  return h >= 0 && h < s.height && w >= 0 && w < s.width;
}

__device__ __forceinline__ int64_t pixel_index(const Shape& s, int b, int h, int w) {
  return (static_cast<int64_t>(b) * s.height + h) * s.width + w;
}

// ---------------------------------------------------------------- bf16, TMA + wgmma

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have on an H100
constexpr int HALO_STAGES_MAX = 4;
constexpr int WEIGHT_STAGES_MAX = 54;  // 6 resident chunks; (2 * 4 + 2 * 54) mbarriers fit in 1024 bytes

struct Pipe {
  int halo_stages, weight_stages;
  int halo_bytes;   // one halo box
  int halo_stride;  // a halo stage, rounded up to the 1024-byte swizzle period
  int weight_bytes;  // one (chunk, tap) weight tile
  int tma;          // 1: halo by TMA, 0: by the plain loader
  int resident;     // 1: all 9 * chunks weight tiles stay in shared memory
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// ~10 s at the H100's clock: a wait that long is a pipeline fault, and
// trapping turns it into a launch error instead of a hung card
constexpr long long WATCHDOG_CYCLES = 20000000000LL;

// Returns once the phase of the given parity has completed. The loop lives
// inside the asm, so the compiler sees no divergent branch before the
// wgmma that follows (it would serialize the wgmmas otherwise); the clock is
// read only once the first try has failed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, %2;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity), "l"(WATCHDOG_CYCLES)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The TMA swizzle of KC-channel (2*KC-byte) rows: the 16-byte unit index
// (address bits 4..) is XORed with address bits 7.. over log2(KC/8) bits.
// `off` is from a 1024-byte aligned base, so it has the address's low bits.
template <int KC>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (KC / 8 - 1)) << 4);
}

// wgmma shared-memory descriptor of a K-major N x KC weight tile with the
// swizzle of its row width: 8-row groups KC*2*8 bytes apart (SBO), the
// leading offset unused (1), layout 1/2/3 = 128/64/32-byte swizzle.
template <int KC>
__device__ __forceinline__ uint64_t weight_desc(uint32_t addr) {
  constexpr uint64_t layout = KC == 64 ? 1 : KC == 32 ? 2 : 3;
  constexpr uint64_t sbo = 8 * KC * 2 / 16;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) | (sbo << 32) | (layout << 62);
}

// wgmma m64nNk16, bf16 in, f32 accumulate, A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B K-major from shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// The plain loader: the producer warp reads one halo chunk with masked
// loads (zeros outside the image and past C_in) and writes it in the
// layout TMA would, swizzle included. A lane loads BATCH 16-byte units
// before it stores any, so a halo costs a few memory round trips and not
// one a unit; channel pairs are packed into 32-bit words by shifts.
template <int KC>
__device__ void load_halo_plain(const uint16_t* __restrict__ x, const Shape& s, uint8_t* dst, Tile tile,
                                int c0, int lane) {
  constexpr int VEC = KC / 8;  // 16-byte units a pixel
  constexpr int BATCH = 4;
  const int units = (s.tile_h + 2) * HALO_W * VEC;
  for (int i0 = lane; i0 < units; i0 += 32 * BATCH) {
    uint32_t v[BATCH][4];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + 32 * k, p = i / VEC, c = c0 + (i % VEC) * 8;
      const int h = tile.h0 - 1 + p / HALO_W, w = tile.w0 - 1 + p % HALO_W;
      const bool valid = i < units && in_image(s, h, w) && c < s.ci;
      const uint16_t* src = x + (valid ? pixel_index(s, tile.b, h, w) * s.ci + c : 0);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const uint32_t lo = valid && c + e < s.ci ? src[e] : 0;
        const uint32_t hi = valid && c + e + 1 < s.ci ? src[e + 1] : 0;
        v[k][e / 2] = lo | hi << 16;
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + 32 * k;
      if (i < units)
        *reinterpret_cast<uint4*>(dst + swizzle<KC>((i / VEC) * KC * 2 + (i % VEC) * 16)) =
            make_uint4(v[k][0], v[k][1], v[k][2], v[k][3]);
    }
  }
}

// BN output channels a block (all of C_out up to 192), KC input channels a
// K chunk. Persistent: each block walks work items (tile, channel block)
// blockIdx.x, + gridDim.x, ...; the producer runs ahead into the next
// item while the consumers finish one. Consumer warp w (of tile_h) owns
// output row w of the tile; the producer warp comes after them. With
// pipe.resident the weight "ring" holds all 9 * chunks tiles, loaded once
// a block and never released.
template <int BN, int KC>
__global__ void __launch_bounds__(288, BN <= 64 ? 2 : 1)
    conv3x3_bf16_wgmma(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                       const uint16_t* __restrict__ x, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, Shape s, Pipe pipe) {
  constexpr int KSTEPS = KC / 16;
  constexpr int PIX_BYTES = KC * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // barriers in the first 1024 bytes, then the rings
  const uint32_t halo0 = base + 1024;
  const uint32_t weight0 = halo0 + pipe.halo_stages * pipe.halo_stride;
  const int hs_n = pipe.halo_stages, ws_n = pipe.weight_stages;
  auto halo_full = [&](int i) { return base + 8 * i; };
  auto halo_empty = [&](int i) { return base + 8 * (hs_n + i); };
  auto weight_full = [&](int i) { return base + 8 * (2 * hs_n + i); };
  auto weight_empty = [&](int i) { return base + 8 * (2 * hs_n + ws_n + i); };

  // the warp index through a shuffle, so the compiler knows it is warp-uniform
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int consumer_threads = 32 * s.tile_h;  // one warp an output row
  if (tid == 0) {
    for (int i = 0; i < hs_n; ++i) {
      mbar_init(halo_full(i), pipe.tma ? 1 : 32);
      mbar_init(halo_empty(i), consumer_threads);
    }
    for (int i = 0; i < ws_n; ++i) {
      mbar_init(weight_full(i), 1);
      mbar_init(weight_empty(i), consumer_threads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int chunks = s.ci_pad / KC;
  const int items = s.batch * s.tiles_h * s.tiles_w * s.n_blocks;

  if (warp == s.tile_h) {
    // producer warp: per item and chunk, the halo, then the chunk's 9 weight tiles
    int hs = 0, hph = 0, ws = 0, wph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Tile tile = tile_of(s, item / s.n_blocks);
      const int n0 = item % s.n_blocks * BN;
      const bool load_weights = !pipe.resident || item == static_cast<int>(blockIdx.x);
      for (int chunk = 0; chunk < chunks; ++chunk) {
        mbar_wait(halo_empty(hs), hph ^ 1);
        const uint32_t halo = halo0 + hs * pipe.halo_stride;
        if (pipe.tma) {
          if (lane == 0) {
            mbar_expect_tx(halo_full(hs), pipe.halo_bytes);
            tma_load_4d(halo, &x_map, halo_full(hs), chunk * KC, tile.w0 - 1, tile.h0 - 1, tile.b);
          }
        } else {
          load_halo_plain<KC>(x, s, smem_raw + (halo - raw), tile, chunk * KC, lane);
          mbar_arrive(halo_full(hs));
        }
        if (++hs == hs_n) hs = 0, hph ^= 1;
        if (!load_weights) continue;
        for (int tap = 0; tap < 9; ++tap) {
          if (!pipe.resident) mbar_wait(weight_empty(ws), wph ^ 1);
          if (lane == 0) {
            mbar_expect_tx(weight_full(ws), pipe.weight_bytes);
            tma_load_2d(weight0 + ws * pipe.weight_bytes, &w_map, weight_full(ws), tap * s.ci_pad + chunk * KC,
                        n0);
          }
          if (++ws == ws_n) ws = 0, wph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warp w computes output row w (16 pixels) by BN channels
  const int row = warp;
  const int g = lane >> 2, t = lane & 3;
  // A rows: the 16 pixels of output row `row` shifted by (dy, dx) in the
  // halo; lanes 0-15 give the rows' first 8 channels, lanes 16-31 the next 8
  const uint32_t lane_off = (row * HALO_W + (lane & 15)) * PIX_BYTES + (lane >> 4) * 16;
  int hs = 0, hph = 0, ws = 0, wph = 0, prev_ws = -1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Tile tile = tile_of(s, item / s.n_blocks);
    const int n0 = item % s.n_blocks * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int chunk = 0; chunk < chunks; ++chunk) {
      mbar_wait(halo_full(hs), hph);
      const uint32_t halo = halo0 + hs * pipe.halo_stride;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t pix = lane_off + ((tap / 3) * HALO_W + tap % 3) * PIX_BYTES;
        uint32_t a[KSTEPS][4];
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) ldmatrix_x4(a[k], halo + swizzle<KC>(pix + k * 32));
        const int stage = pipe.resident ? chunk * 9 + tap : ws;
        mbar_wait(weight_full(stage), pipe.resident ? 0 : wph);
        wgmma_fence();
        const uint64_t desc = weight_desc<KC>(weight0 + stage * pipe.weight_bytes);
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) Wgmma<BN>::mma(acc, a[k], desc + 2 * k);  // +32 bytes a k16 step
        wgmma_commit();
        // the previous tap's MMAs are done: release its weight stage. The
        // last tap drains the pipeline, so that no wgmma is in flight across
        // the chunk loop, whose next pass redefines the A registers (ptxas
        // serializes every wgmma otherwise), and only then releases the
        // halo stage: its wgmmas have consumed the registers that the last
        // ldmatrix filled, so that ldmatrix has read the stage
        if (tap < 8) {
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
          mbar_arrive(halo_empty(hs));
        }
        if (!pipe.resident) {
          if (prev_ws >= 0) mbar_arrive(weight_empty(prev_ws));
          prev_ws = tap < 8 ? ws : -1;
          if (tap == 8) mbar_arrive(weight_empty(ws));
          if (++ws == ws_n) ws = 0, wph ^= 1;
        }
      }
      if (++hs == hs_n) hs = 0, hph ^= 1;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // epilogue: f32 bias, ReLU, one rounding to bf16. Accumulators 4 nb .. 4 nb + 3
    // hold n8 block nb: rows g (the first two) and g + 8, channels 8 nb + 2t, +1.
    // A lane stores channel pairs (4 bytes) where C_out is even, a lane quad 16
    // contiguous bytes; the stores come after all the pairs of 32 channels.
    const int h = tile.h0 + row;
    const bool pairs = s.co % 2 == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int w = tile.w0 + g + 8 * half;
      const bool inside = h < s.height && w < s.width;
      __nv_bfloat16* dst = out + pixel_index(s, tile.b, h, w) * s.co;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        __nv_bfloat162 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + 32 * j + 8 * q + 2 * t;
          const float b0 = n < s.co ? bias[n] : 0.f;
          const float b1 = n + 1 < s.co ? bias[n + 1] : 0.f;
          const int i = 4 * (4 * j + q) + 2 * half;
          v[q] = __floats2bfloat162_rn(fmaxf(acc[i] + b0, 0.f), fmaxf(acc[i + 1] + b1, 0.f));
        }
        if (inside) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = n0 + 32 * j + 8 * q + 2 * t;
            if (pairs) {
              if (n < s.co) *reinterpret_cast<__nv_bfloat162*>(dst + n) = v[q];
            } else {
              if (n < s.co) dst[n] = v[q].x;
              if (n + 1 < s.co) dst[n + 1] = v[q].y;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- f32, 3xTF32 + wgmma

// Where a tile lies: n_img images (folded, where whole images are smaller
// than the tile) x tile_h rows x tile_w columns, padded to 64 rows a
// consumer warpgroup.
struct Geo {
  int batch, height, width, ci, ci_pad, co;
  int tile_h, tile_w, n_img;
  int tiles_b, tiles_h, tiles_w;
  int n_blocks;  // blocks of output channels a tile
  int warps;     // consumer warps, 4 a warpgroup
};

struct Origin {
  int b, h, w;
};

__device__ __forceinline__ Origin origin_of(const Geo& g, int t) {
  Origin o;
  o.w = (t % g.tiles_w) * g.tile_w;
  t /= g.tiles_w;
  o.h = (t % g.tiles_h) * g.tile_h;
  o.b = t / g.tiles_h * g.n_img;
  return o;
}

// tf32 of v, rounded to nearest (ties away), in the low 13 bits zero
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma m64nNk8, tf32 in (K-major both, the only layout .tf32 has), f32
// accumulate, A from registers (per warp rows g, g + 8 x k t, t + 4), B
// from shared memory.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTf32<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// The plain loader of the f32 kernel: as load_halo_plain, over f32 pixels
// of 4-channel 16-byte units and the folded tile's halo (n_img images of
// (tile_h + 2) x (tile_w + 2) pixels), zeros outside the images, past the
// batch and past C_in.
template <int KC>
__device__ void load_halo_plain_f32(const float* __restrict__ x, const Geo& g, uint8_t* dst, Origin o, int c0,
                                    int lane) {
  constexpr int VEC = KC / 4;  // 16-byte units a pixel
  constexpr int BATCH = 4;
  const int hw = g.tile_w + 2, plane = (g.tile_h + 2) * hw;
  const int units = g.n_img * plane * VEC;
  for (int i0 = lane; i0 < units; i0 += 32 * BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + 32 * k, p = i / VEC, c = c0 + (i % VEC) * 4;
      const int b = o.b + p / plane, h = o.h - 1 + p % plane / hw, w = o.w - 1 + p % hw;
      const bool valid = i < units && b < g.batch && h >= 0 && h < g.height && w >= 0 && w < g.width && c < g.ci;
      const float* src = x + (valid ? ((static_cast<int64_t>(b) * g.height + h) * g.width + w) * g.ci + c : 0);
      v[k].x = valid ? src[0] : 0.f;
      v[k].y = valid && c + 1 < g.ci ? src[1] : 0.f;
      v[k].z = valid && c + 2 < g.ci ? src[2] : 0.f;
      v[k].w = valid && c + 3 < g.ci ? src[3] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + 32 * k;
      if (i < units) *reinterpret_cast<float4*>(dst + swizzle<KC * 2>((i / VEC) * KC * 4 + (i % VEC) * 16)) = v[k];
    }
  }
}

// BN output channels a block, KC input channels (4 * KC bytes) a K chunk.
// The pipeline is the bf16 kernel's (producer warp, halo and weight rings,
// persistent items, resident weights where they fit); what differs:
// * a weight stage holds the (chunk, tap) tile twice, hi then lo, split at
//   pack time, both by TMA (a 3-D map whose outer axis picks the half);
// * each consumer reads its A fragment with ldmatrix (an .x4 of b16 8x8
//   matrices over f32 data is the m64k8 tf32 fragment), splits it into hi
//   and lo in fresh registers, and issues lo*hi, hi*lo, hi*hi per k8 step;
// * consumer warp w owns tile rows m = 16 w .. 16 w + 15, a row being a
//   pixel of the folded tile (image, row, column); padding rows read pixel 0
//   and are never stored.
template <int BN, int KC>
__global__ void __launch_bounds__(288, 1)
    conv3x3_f32_3xtf32_wgmma(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                             const float* __restrict__ x, const float* __restrict__ bias, float* __restrict__ out,
                             Geo g, Pipe pipe) {
  constexpr int KSTEPS = KC / 8;
  constexpr int ROW = KC * 4;           // bytes a halo pixel and a weight row
  constexpr int SW = KC * 2;            // the bf16 chunk of the same row width (swizzle, descriptor)
  constexpr uint32_t HALF = BN * ROW;   // the lo tile, behind the hi tile of a weight stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // barriers in the first 1024 bytes, then the rings
  const uint32_t halo0 = base + 1024;
  const uint32_t weight0 = halo0 + pipe.halo_stages * pipe.halo_stride;
  const int hs_n = pipe.halo_stages, ws_n = pipe.weight_stages;
  auto halo_full = [&](int i) { return base + 8 * i; };
  auto halo_empty = [&](int i) { return base + 8 * (hs_n + i); };
  auto weight_full = [&](int i) { return base + 8 * (2 * hs_n + i); };
  auto weight_empty = [&](int i) { return base + 8 * (2 * hs_n + ws_n + i); };

  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int consumer_threads = 32 * g.warps;
  if (tid == 0) {
    for (int i = 0; i < hs_n; ++i) {
      mbar_init(halo_full(i), pipe.tma ? 1 : 32);
      mbar_init(halo_empty(i), consumer_threads);
    }
    for (int i = 0; i < ws_n; ++i) {
      mbar_init(weight_full(i), 1);
      mbar_init(weight_empty(i), consumer_threads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int chunks = g.ci_pad / KC;
  const int items = g.tiles_b * g.tiles_h * g.tiles_w * g.n_blocks;
  const int hw = g.tile_w + 2;

  if (warp == g.warps) {
    // producer warp: per item and chunk, the halo, then the chunk's 9 weight stages
    int hs = 0, hph = 0, ws = 0, wph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Origin o = origin_of(g, item / g.n_blocks);
      const int n0 = item % g.n_blocks * BN;
      const bool load_weights = !pipe.resident || item == static_cast<int>(blockIdx.x);
      for (int chunk = 0; chunk < chunks; ++chunk) {
        mbar_wait(halo_empty(hs), hph ^ 1);
        const uint32_t halo = halo0 + hs * pipe.halo_stride;
        if (pipe.tma) {
          if (lane == 0) {
            mbar_expect_tx(halo_full(hs), pipe.halo_bytes);
            tma_load_4d(halo, &x_map, halo_full(hs), chunk * KC, o.w - 1, o.h - 1, o.b);
          }
        } else {
          load_halo_plain_f32<KC>(x, g, smem_raw + (halo - raw), o, chunk * KC, lane);
          mbar_arrive(halo_full(hs));
        }
        if (++hs == hs_n) hs = 0, hph ^= 1;
        if (!load_weights) continue;
        for (int tap = 0; tap < 9; ++tap) {
          if (!pipe.resident) mbar_wait(weight_empty(ws), wph ^ 1);
          if (lane == 0) {
            const uint32_t dst = weight0 + ws * pipe.weight_bytes;
            const int k0 = tap * g.ci_pad + chunk * KC;
            mbar_expect_tx(weight_full(ws), pipe.weight_bytes);
            tma_load_3d(dst, &w_map, weight_full(ws), k0, n0, 0);
            tma_load_3d(dst + HALF, &w_map, weight_full(ws), k0, n0, 1);
          }
          if (++ws == ws_n) ws = 0, wph ^= 1;
        }
      }
    }
    return;
  }

  // consumers. The pixel whose halo row this lane hands ldmatrix: tile row
  // m = 16 warp + (lane & 15); lanes 16-31 give its k + 4 half
  const int tile_pixels = g.n_img * g.tile_h * g.tile_w, per_img = g.tile_h * g.tile_w;
  int m = 16 * warp + (lane & 15);
  if (m >= tile_pixels) m = 0;
  const uint32_t lane_off =
      (((m / per_img) * (g.tile_h + 2) + m % per_img / g.tile_w) * hw + m % g.tile_w) * ROW + (lane >> 4) * 16;
  const int gq = lane >> 2, t = lane & 3;
  int hs = 0, hph = 0, ws = 0, wph = 0, prev_ws = -1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Origin o = origin_of(g, item / g.n_blocks);
    const int n0 = item % g.n_blocks * BN;
    // each chunk sums into acc from zero, and acc into total with a rounded
    // f32 add: the tensor cores' own accumulation loses low bits (~K * 1e-8
    // of max|out| over one chain of K = 3456, against ~1e-6 for the chunk's)
    float acc[BN / 2], total[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] = 0.f;
    for (int chunk = 0; chunk < chunks; ++chunk) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      mbar_wait(halo_full(hs), hph);
      const uint32_t halo = halo0 + hs * pipe.halo_stride;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t pix = lane_off + ((tap / 3) * hw + tap % 3) * ROW;
        // A and its split, in registers that no wgmma in flight has read:
        // the last tap of a chunk drains the pipeline before the next pass
        uint32_t hi[KSTEPS][4], lo[KSTEPS][4];
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) {
          uint32_t a[4];
          ldmatrix_x4(a, halo + swizzle<SW>(pix + k * 32));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = __uint_as_float(a[i]);
            hi[k][i] = to_tf32(v);
            lo[k][i] = to_tf32(v - __uint_as_float(hi[k][i]));
          }
        }
        const int stage = pipe.resident ? chunk * 9 + tap : ws;
        mbar_wait(weight_full(stage), pipe.resident ? 0 : wph);
        wgmma_fence();
        const uint32_t w_hi = weight0 + stage * pipe.weight_bytes;
        const uint64_t d_hi = weight_desc<SW>(w_hi), d_lo = weight_desc<SW>(w_hi + HALF);
        // the small products first: lo*hi, hi*lo, then hi*hi (+32 bytes a k8 step)
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) {
          WgmmaTf32<BN>::mma(acc, lo[k], d_hi + 2 * k);
          WgmmaTf32<BN>::mma(acc, hi[k], d_lo + 2 * k);
          WgmmaTf32<BN>::mma(acc, hi[k], d_hi + 2 * k);
        }
        wgmma_commit();
        // as in the bf16 kernel: release the previous tap's weight stage
        // once its group is done; the last tap drains the pipeline and only
        // then releases the halo stage its ldmatrix read
        if (tap < 8) {
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
          mbar_arrive(halo_empty(hs));
        }
        if (!pipe.resident) {
          if (prev_ws >= 0) mbar_arrive(weight_empty(prev_ws));
          prev_ws = tap < 8 ? ws : -1;
          if (tap == 8) mbar_arrive(weight_empty(ws));
          if (++ws == ws_n) ws = 0, wph ^= 1;
        }
      }
      if (++hs == hs_n) hs = 0, hph ^= 1;
      // the chunk's wgmmas are done (its last tap waited on them): no read
      // of acc may move above that wait
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        asm volatile("" : "+f"(acc[i])::"memory");
        total[i] += acc[i];
      }
    }

    // epilogue: f32 bias, ReLU, f32 stores of channel pairs (8 bytes, a lane
    // quad 32 contiguous bytes). Accumulators 4 nb .. 4 nb + 3 hold n8 block
    // nb: rows gq (the first two) and gq + 8, channels 8 nb + 2t, +1.
    const bool pairs = g.co % 2 == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int mm = 16 * warp + gq + 8 * half;
      const int b = o.b + mm / per_img, h = o.h + mm % per_img / g.tile_w, w = o.w + mm % g.tile_w;
      if (mm >= tile_pixels || b >= g.batch || h >= g.height || w >= g.width) continue;
      float* dst = out + ((static_cast<int64_t>(b) * g.height + h) * g.width + w) * g.co;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int n = n0 + 8 * nb + 2 * t, i = 4 * nb + 2 * half;
        const float v0 = fmaxf(total[i] + (n < g.co ? bias[n] : 0.f), 0.f);
        const float v1 = fmaxf(total[i + 1] + (n + 1 < g.co ? bias[n + 1] : 0.f), 0.f);
        if (pairs) {
          if (n < g.co) *reinterpret_cast<float2*>(dst + n) = make_float2(v0, v1);
        } else {
          if (n < g.co) dst[n] = v0;
          if (n + 1 < g.co) dst[n + 1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// error codes of this library beyond the runtime's
constexpr int ERR_NO_LIBCUDA = 100000;  // libcuda.so.1 or cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 100001;     // + CUresult: cuTensorMapEncodeTiled refused a map

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

CUtensorMapSwizzle swizzle_of(int chunk) {
  return chunk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : chunk == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                                : CU_TENSOR_MAP_SWIZZLE_32B;
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The persistent grid of `kernel`: as many blocks as are resident at once
// on the device's SMs, at most one a work item; 0 or an error code. The
// residency is cached by (kernel, device, threads, shared memory): the
// occupancy query costs more host time than the launch itself. A key's
// first use also opens the kernel up to all of a block's shared memory on
// that device.
template <typename Kernel>
int persistent_grid(Kernel kernel, int device, int threads, int smem, long long items, unsigned* grid) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, long long> resident_blocks;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), device, threads, smem);
  long long resident;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = resident_blocks.find(key);
    if (it == resident_blocks.end()) {
      int per_sm = 0, sms = 0;
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      it = resident_blocks.emplace(key, static_cast<long long>(per_sm) * sms).first;
    }
    resident = it->second;
  }
  *grid = static_cast<unsigned>(items < resident ? items : resident);
  return 0;
}

template <int BN, int KC>
int launch_bf16(const CUtensorMap& xm, const CUtensorMap& wm, const uint16_t* x, const float* bias,
                __nv_bfloat16* out, const Shape& s, const Pipe& pipe, long long items, int smem, int device,
                cudaStream_t st) {
  auto kernel = conv3x3_bf16_wgmma<BN, KC>;
  const int threads = 32 * s.tile_h + 32;
  unsigned grid = 0;
  if (const int err = persistent_grid(kernel, device, threads, smem, items, &grid)) return err;
  kernel<<<grid, threads, smem, st>>>(xm, wm, x, bias, out, s, pipe);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int dispatch_n(int block_n, const CUtensorMap& xm, const CUtensorMap& wm, const uint16_t* x, const float* bias,
               __nv_bfloat16* out, const Shape& s, const Pipe& pipe, long long items, int smem, int device,
               cudaStream_t st) {
  switch (block_n) {
    case 32: return launch_bf16<32, KC>(xm, wm, x, bias, out, s, pipe, items, smem, device, st);
    case 64: return launch_bf16<64, KC>(xm, wm, x, bias, out, s, pipe, items, smem, device, st);
    case 128: return launch_bf16<128, KC>(xm, wm, x, bias, out, s, pipe, items, smem, device, st);
    case 192: return launch_bf16<192, KC>(xm, wm, x, bias, out, s, pipe, items, smem, device, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


template <int BN, int KC>
int launch_f32(const CUtensorMap& xm, const CUtensorMap& wm, const float* x, const float* bias, float* out,
               const Geo& g, const Pipe& pipe, long long items, int smem, int device, cudaStream_t st) {
  auto kernel = conv3x3_f32_3xtf32_wgmma<BN, KC>;
  const int threads = 32 * g.warps + 32;
  unsigned grid = 0;
  if (const int err = persistent_grid(kernel, device, threads, smem, items, &grid)) return err;
  kernel<<<grid, threads, smem, st>>>(xm, wm, x, bias, out, g, pipe);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int dispatch_n_f32(int block_n, const CUtensorMap& xm, const CUtensorMap& wm, const float* x, const float* bias,
                   float* out, const Geo& g, const Pipe& pipe, long long items, int smem, int device,
                   cudaStream_t st) {
  switch (block_n) {
    case 32: return launch_f32<32, KC>(xm, wm, x, bias, out, g, pipe, items, smem, device, st);
    case 64: return launch_f32<64, KC>(xm, wm, x, bias, out, g, pipe, items, smem, device, st);
    case 96:  // at most 16-channel chunks: see f32_launch_plan
      if constexpr (KC <= 16) return launch_f32<96, KC>(xm, wm, x, bias, out, g, pipe, items, smem, device, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One bf16 stage: out = relu(conv3x3(x, w) + bias). x (batch, height, width,
// ci) and out (batch, height, width, co) are contiguous NHWC bf16; w is
// (co_pad, 3, 3, ci_pad) bf16, zero past co and ci; bias is float32 (co,).
// The plan (chunk, block_n, tile_h, halo_stages, weight_stages, smem_bytes,
// tma, resident) comes from the wrapper's launch_plan and is checked here. Launches
// on `stream` of `device` and returns 0 on success, else a CUDA error code
// or one of this library's (see conv_chain_error_string).
extern "C" int conv3x3_bias_relu_bf16(const void* x, const void* w, const void* bias, void* out, int batch,
                                      int height, int width, int ci, int ci_pad, int co, int co_pad, int chunk,
                                      int block_n, int tile_h, int halo_stages, int weight_stages,
                                      int smem_bytes, int tma, int resident, int device, void* stream) {
  const bool chunk_ok = chunk == 16 || chunk == 32 || chunk == 64;
  if (batch <= 0 || height <= 0 || width <= 0 || ci <= 0 || co <= 0 || !chunk_ok || ci_pad < ci ||
      ci_pad % chunk != 0 || co_pad < co || (tile_h != 4 && tile_h != 8) || halo_stages < 1 ||
      halo_stages > HALO_STAGES_MAX || weight_stages < 2 || weight_stages > WEIGHT_STAGES_MAX ||
      (tma && (ci % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int halo_bytes = (tile_h + 2) * HALO_W * chunk * 2;
  const Pipe pipe{halo_stages, weight_stages, halo_bytes, round_up(halo_bytes, 1024), block_n * chunk * 2, tma,
                  resident};
  const int n_blocks = (co + block_n - 1) / block_n;
  if (smem_bytes != 2048 + halo_stages * pipe.halo_stride + weight_stages * pipe.weight_bytes ||
      smem_bytes > SMEM_LIMIT || (resident && (weight_stages != 9 * ci_pad / chunk || n_blocks != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{batch, height, width, ci, ci_pad, co, tile_h, (height + tile_h - 1) / tile_h, (width + TW - 1) / TW,
                n_blocks};
  const long long items = static_cast<long long>(batch) * s.tiles_h * s.tiles_w * n_blocks;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_LIBCUDA;
  CUtensorMap xm{}, wm{};
  const CUtensorMapSwizzle swz = swizzle_of(chunk);
  if (tma) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(ci), static_cast<cuuint64_t>(width),
                                static_cast<cuuint64_t>(height), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ci) * 2, static_cast<cuuint64_t>(ci) * 2 * width,
                                   static_cast<cuuint64_t>(ci) * 2 * width * height};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk), HALO_W, static_cast<cuuint32_t>(tile_h + 2), 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(9) * ci_pad, static_cast<cuuint64_t>(co_pad)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(9) * ci_pad * 2};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(block_n)};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  }
  const auto* xb = static_cast<const uint16_t*>(x);
  const auto* bb = static_cast<const float*>(bias);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16: return dispatch_n<16>(block_n, xm, wm, xb, bb, ob, s, pipe, items, smem_bytes, device, st);
    case 32: return dispatch_n<32>(block_n, xm, wm, xb, bb, ob, s, pipe, items, smem_bytes, device, st);
    default: return dispatch_n<64>(block_n, xm, wm, xb, bb, ob, s, pipe, items, smem_bytes, device, st);
  }
}

// One f32 stage: out = relu(conv3x3(x, w) + bias) in float32 to f32-level
// accuracy (3xTF32). x (batch, height, width, ci) and out (batch, height,
// width, co) are contiguous NHWC float32; w is (2, co_pad, 3, 3, ci_pad)
// float32, the kernel's tf32 hi and lo halves, zero past co and ci; bias
// is float32 (co,). The plan (chunk, block_n, tile_h, tile_w, n_img, warps,
// halo_stages, weight_stages, smem_bytes, tma, resident) comes from the
// wrapper's f32_launch_plan and is checked here. Returns as the bf16 entry.
extern "C" int conv3x3_bias_relu_f32(const void* x, const void* w, const void* bias, void* out, int batch,
                                     int height, int width, int ci, int ci_pad, int co, int co_pad, int chunk,
                                     int block_n, int tile_h, int tile_w, int n_img, int warps, int halo_stages,
                                     int weight_stages, int smem_bytes, int tma, int resident, int device,
                                     void* stream) {
  const bool chunk_ok = chunk == 8 || chunk == 16 || chunk == 32;
  const bool n_ok = block_n == 32 || block_n == 64 || block_n == 96;
  if (batch <= 0 || height <= 0 || width <= 0 || ci <= 0 || co <= 0 || !chunk_ok || !n_ok || ci_pad < ci ||
      ci_pad % chunk != 0 || co_pad < co || (warps != 4 && warps != 8) || tile_h < 1 || tile_w < 1 || n_img < 1 ||
      tile_w + 2 > 256 || tile_h + 2 > 256 || n_img > 256 || n_img * tile_h * tile_w > 16 * warps ||
      halo_stages < 1 || halo_stages > HALO_STAGES_MAX || weight_stages < 2 || weight_stages > WEIGHT_STAGES_MAX ||
      (tma && (ci % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int halo_bytes = n_img * (tile_h + 2) * (tile_w + 2) * chunk * 4;
  const Pipe pipe{halo_stages, weight_stages, halo_bytes, round_up(halo_bytes, 1024), 2 * block_n * chunk * 4, tma,
                  resident};
  const int n_blocks = (co + block_n - 1) / block_n;
  if (smem_bytes != 2048 + halo_stages * pipe.halo_stride + weight_stages * pipe.weight_bytes ||
      smem_bytes > SMEM_LIMIT || (resident && (weight_stages != 9 * ci_pad / chunk || n_blocks != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{batch, height, width, ci, ci_pad, co, tile_h, tile_w, n_img, (batch + n_img - 1) / n_img,
              (height + tile_h - 1) / tile_h, (width + tile_w - 1) / tile_w, n_blocks, warps};
  const long long items = static_cast<long long>(g.tiles_b) * g.tiles_h * g.tiles_w * n_blocks;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_LIBCUDA;
  CUtensorMap xm{}, wm{};
  const CUtensorMapSwizzle swz = swizzle_of(chunk * 2);  // the swizzle of 4 * chunk-byte rows
  if (tma) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(ci), static_cast<cuuint64_t>(width),
                                static_cast<cuuint64_t>(height), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ci) * 4, static_cast<cuuint64_t>(ci) * 4 * width,
                                   static_cast<cuuint64_t>(ci) * 4 * width * height};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(tile_w + 2),
                               static_cast<cuuint32_t>(tile_h + 2), static_cast<cuuint32_t>(n_img)};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(&xm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  }
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(9) * ci_pad, static_cast<cuuint64_t>(co_pad), 2};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(9) * ci_pad * 4,
                                   static_cast<cuuint64_t>(9) * ci_pad * 4 * co_pad};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(chunk), static_cast<cuuint32_t>(block_n), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = encode(&wm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(r);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 8: return dispatch_n_f32<8>(block_n, xm, wm, xf, bf, of, g, pipe, items, smem_bytes, device, st);
    case 16: return dispatch_n_f32<16>(block_n, xm, wm, xf, bf, of, g, pipe, items, smem_bytes, device, st);
    default: return dispatch_n_f32<32>(block_n, xm, wm, xf, bf, of, g, pipe, items, smem_bytes, device, st);
  }
}

extern "C" const char* conv_chain_error_string(int code) {
  if (code == ERR_NO_LIBCUDA) return "libcuda.so.1 or its cuTensorMapEncodeTiled was not found";
  if (code >= ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 100001)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
