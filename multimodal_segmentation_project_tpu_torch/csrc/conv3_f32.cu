// SAME 3x3x3 convolution on channel-first fp32 volumes, at fp32 accuracy on
// Hopper's tensor cores: a 3xTF32 implicit GEMM on wgmma, with a
// compile-time epilogue and a compile-time input prologue.
//
// Replaces: multimodal_segmentation_project_tpu/ops/pallas_conv.py, each on
// an fp32 x as the JAX package runs it under its fp32 policy (its kernels
// stage and write in x's dtype):
//   * _fwd_bias_act_kernel (public op conv3x3x3_cf_relu): the eval
//     forward's conv, BatchNorm folded into w and b by the caller, epilogue
//     kBiasRelu, out = relu(acc + bias) (mmseg_conv3_f32_bias_relu);
//   * _fwd_kernel (public op conv3x3x3_cf, the training conv, and the dx of
//     its backward): epilogue kCastBias, out = acc + bias, or acc where
//     bias is null (the dx, on the spatially flipped weights with Cin and
//     Cout swapped); in fp32 the cast is the identity (mmseg_conv3_f32);
//   * _fwd_stats_kernel (conv3x3x3_cf_stats, conv0 of the fused training
//     DoubleConv): epilogue kBiasStats, y = acc + bias and per channel the
//     sums of y and y^2 over batch and volume (mmseg_conv3_f32_stats);
//   * _fwd_prologue_stats_kernel (conv3x3x3_cf_boundary_stats, conv1 of
//     the fused block): kBiasStats with the prologue on, the input taken
//     as relu(x * a + t), a, t fp32 per (batch, channel), the SAME halo
//     kept 0 (mmseg_conv3_f32_prologue_stats);
//   * _fwd_prologue_kernel (conv3x3x3_cf_boundary): kCastBias with the
//     prologue on (mmseg_conv3_f32_prologue);
//   * _dx_epilogue_kernel (the backward of both boundary ops): epilogue
//     kDxMask on the dx conv of the cotangent (flipped, transposed
//     weights). With the conv's result dr, the boundary conv's raw input
//     xr and its affine (a, t) at the output coordinates: u = xr * a + t,
//     du = u > 0 ? dr : 0, dy = du * a, and per (batch, channel) the sums
//     of du * xr (da) and of du (dt). Its output channels are the boundary
//     conv's INPUT channels; a, t, xr are indexed by them
//     (mmseg_conv3_f32_dx_epilogue).
// The epilogue numbering is conv3.cu's.
//
// Why 3xTF32. An fp32 conv is held to 2e-5 of max |out|; one TF32 product
// (10 mantissa bits) errs by about 1e-3 of itself. Each operand is split,
// v = hi + lo with hi = tf32(v) (to nearest, ties away, as cvt.rna) and lo
// = v - hi, and a * b = lo_a hi_b + hi_a lo_b + hi_a hi_b + (terms of
// 2^-22 |a b| and less): three TF32 products carry a product to about
// fp32's accuracy. The weights' planes are split by the wrapper, lo
// rounded as hi is; the activations' in registers, lo cut to TF32's 19
// bits. The tensor core adds a wgmma's products and its accumulator in
// its own order, truncating, so a chain of thousands of them would drift
// toward zero: it accumulates within one chunk of input channels only (72
// of K, the three products of a k step in that order), and the chunk's
// sum is then added to fp32 master sums by FADD, which rounds to nearest.
//
// Layout: x (B, Cin, D, H, W) fp32, bias (Cout,) fp32 or null (kCastBias),
// out (B, Cout, D, H, W) fp32, a, t (B, Cin) fp32 for the prologue, xr
// (B, Cout, D, H, W) fp32 and a, t (B, Cout) fp32 for kDxMask, all
// contiguous. The weights arrive packed and split by the wrapper
// (ops/conv3.py:pack_weights_f32) as (nslices, nchunks, KS, 2, 2, N, 4)
// fp32: per slice of NS output channels and chunk of CK input channels, K =
// 9 CK (k = CK (3 kd + kh) + ci, zero-padded to KS steps of 8) by N = 3 NS
// (n = NS kw + channel), and per k step a hi and a lo plane, each the
// wgmma's K-major canonical layout without swizzle (two core matrices of N
// rows x 4 k along K, 16 N bytes apart): one (slice, chunk) slab is its
// shared-memory image, copied as it is.
//
// Design: an implicit GEMM with the kw taps on N, on wgmma.mma_async
// m64nNk8 f32.tf32 with A from registers:
//   * M is input voxels: a warp's 16 fragment rows are the voxels w0 - 1 ..
//     w0 + 14 of an output row; K is (kd, kh, input channel); N is (kw,
//     output channel), N = 48 or 96. A chunk's sum is then the output row's
//     14 voxels: output voxel w0 + r - 1 = (row r - 1 at kw 0 + row r at kw
//     1) + row r + 1 at kw 2, the neighbouring rows from the lanes 4 apart
//     by shuffles. Against taps on K this reads a third of the A values and
//     issues a third of the wgmmas, each three times as wide.
//   * Blocks are persistent (one an SM) and walk the units k, k + grid,
//     ...: an output tile of TILE_D x TILE_H x TILE_W voxels (W fastest,
//     then H, D, the batch) and a slice of NS = 16 or 32 output channels
//     (Cout > 32: two slices of 32). A block is TILE_D consumer warpgroups,
//     warpgroup g taking plane g of a tile as two m64 tiles of 4 output
//     rows (warp q of it rows q and 4 + q): 3 x 8 x 14 where NS = 16 (the
//     192^3 convs; 168 registers a thread at most, and the 5 staged planes
//     all used), 2 x 8 x 14 where NS = 32 (more accumulators a thread).
//   * A: for a k step a thread reads its 4 values of each m64 tile from the
//     staged tile with ld.shared at the offsets of its k and k + 4 (a
//     per-block table of (kd, kh, ci) -> offset), applies the prologue there
//     (PRO: relu(x * a + t) rounded after each operation, no contraction, a
//     NaN kept, and 0 on the halo by a per-row mask of the (kd, kh) pairs
//     inside the volume), and splits each value (4 integer and fp32
//     operations). The 4 lanes of a quad read 4 channels of one staged row:
//     a channel's XCH floats are 8 (mod 32) words apart, so a warp's 32
//     reads fall on 32 banks. The A registers are double-buffered and the
//     next k step's table entry and values are loaded a step ahead, so that
//     the loads overlap the wgmmas.
//   * B (weights) comes from shared memory through a matrix descriptor.
//   * Cin = 1 takes the 9 (kd, kh) pairs on K (CK = 1: 2 k steps); otherwise
//     CK = 8 channels a chunk (9 k steps). Padded k read pair 0 of channel 0
//     (a value of the window) against zero weights.
//   * Staging: a ring of NST stages (2 to 4, as many as fit in 227 KB), one
//     (unit, chunk) item each: the haloed input tile of CK channels, XD x
//     XH rows of XW = 20 floats (from voxel w0 - 1 rounded down to 4: a TMA
//     box starts on 16 bytes), XD = 5 planes (a 2-plane tile's 4 and one
//     more) so that XCH = 1000 = 8 (mod 32), and the chunk's weight slab. Where W % 4 ==
//     0 and x is 16-byte aligned, thread 0 starts one TMA copy of a 5-D box
//     (the tensor map's zero fill is the SAME halo and the channels past
//     Cin) and one bulk copy of the slab, both completing on the stage's
//     mbarrier; else every thread copies the staged voxels in 4-byte
//     cp.async pieces, zero-filled alike, and the slab lands as before.
//     Item i + NST is started once every warp is done with item i.
// Epilogue, from the registers, at a unit's last chunk: bias added after
// the whole sum (kBiasRelu: then ReLU that keeps a NaN, as jnp.maximum
// does), one 4-byte store per element (the 8 lanes of a quad row write 32
// consecutive bytes of one channel). kBiasStats and kDxMask also sum per
// channel in a fixed order: each thread its voxels of a channel in order
// (m64 tile, then fragment row; a square, or the product du * xr, rounded
// before it is added), a butterfly over the 8 lanes that share the
// channel, then the block's warps in order through shared memory; one partial
// per (sum, channel, batch, tile), which conv3_f32_stats_reduce_kernel sums
// in tile order. No atomics: the same bits on every run.
//
// What bounds it on an H100: the eval forward's eleven convs do about 682
// GFLOP of fp32 products, 10.2 ms at 67 TFLOP/s of FFMA; as 3xTF32 three
// times that, 4.1 ms at 494.7 TFLOP/s of dense TF32; the bytes, each
// input read once, about 5.7 GB, 1.7 ms at 3.35 TB/s. The wgmmas here are
// 3 x 16 / 14 of the products' (the kw rows past a tile's 14 voxels), the
// staged bytes 3 to 4.5 times the input (the halo, and the padding plane
// of a 2-plane tile), and the weight slab comes again for every tile. dw_dissect.py --conv-f32
// times the body with parts removed: at the 192^3 convs (N = 48) the
// staging alone (TMA boxes of 80-byte rows and the slabs) takes most of
// the time; from N = 96 on the wgmmas and the A path do.
#include <cuda.h>

#include "conv3_f32_tile.cuh"

namespace {

using conv3f32::cp_async4;
using conv3f32::cp_async_commit;
using conv3f32::cp_async_wait;
using conv3f32::prologue;

enum Epilogue { kBiasRelu = 0, kCastBias = 1, kBiasStats = 2, kDxMask = 3 };  // conv3.cu's

constexpr int TILE_H = 8;           // output rows per plane: two m64 tiles of 4
constexpr int TILE_W = 14;          // output voxels per row: a fragment's 16 rows but the ends
constexpr int XD = 5;               // staged planes: a tile's 3 + 2 (of 2 + 2, and one more)
constexpr int XH = 10;              // staged rows per plane: TILE_H + 2
constexpr int XW = 20;              // staged row: 20 voxels from w0 - 1 rounded down to 4
constexpr int XCH = XD * XH * XW;   // staged floats per channel
constexpr int MT = 2;               // m64 tiles per warpgroup
constexpr int MAX_STAGES = 4;
constexpr int TABLE_BYTES = 576;    // 9 k steps x 4 lanes of a quad x an int4
constexpr int AT_BYTES = 512;       // (a, t) of 64 channels
constexpr int RED_BYTES = 2048;     // the sums' scratch: warps x 2 sums x channels of a slice
constexpr int SMEM_LIMIT = 232448;  // an H100 block's dynamic shared memory
constexpr int RTHREADS = 256;       // threads of the cross-tile reduce
static_assert(XH == TILE_H + 2 && XW >= 3 + 16, "a tile's haloed rows");
static_assert(XCH % 32 == 8, "4 consecutive channels on 4 distinct groups of 8 banks");

// consumer warpgroups of a block for a slice of NS output channels, and so
// the output planes of its tile (one each): three where NS = 16 (at most
// 168 registers a thread), two where NS = 32 (its accumulators take more)
__host__ __device__ constexpr int warpgroups(int ns) { return ns == 16 ? 3 : 2; }
static_assert(XD >= warpgroups(16) + 2 && XD >= warpgroups(32) + 2, "a tile's haloed planes");
static_assert(RED_BYTES >= 4 * 2 * 4 * warpgroups(16) * 16 &&
                  RED_BYTES >= 4 * 2 * 4 * warpgroups(32) * 32,
              "a float of either sum a warp and channel");

// input channels per chunk: one where Cin = 1 (the 9 (kd, kh) pairs are K),
// else 8 (K = 72 a chunk: (kd, kh) pair after pair, 8 channels each)
__host__ __device__ constexpr int chunk_channels(int cin) { return cin == 1 ? 1 : 8; }
// k steps of 8 per chunk (9 CK rounded up)
__host__ __device__ constexpr int k_steps(int ck) { return (9 * ck + 7) / 8; }
// a stage's input tile of CK channels, from a 128-byte boundary
__host__ __device__ constexpr int x_bytes(int ck) { return (ck * XCH * 4 + 127) / 128 * 128; }
// a chunk's weight slab: the hi and lo planes (32 N bytes each, N = 3 NS)
// of every k step
__host__ __device__ constexpr int slab_bytes(int ck, int ns) { return 64 * 3 * ns * k_steps(ck); }
// the k table, (a, t), the sums' scratch and the ring's mbarriers
constexpr int FIXED_BYTES = TABLE_BYTES + AT_BYTES + RED_BYTES + 8 * MAX_STAGES;
// output channels of a slice: the wgmma's N is 3 NS (kw, channel)
__host__ __device__ constexpr int slice_channels(int cout) { return cout <= 16 ? 16 : 32; }

// the ring's stages: as many as fit, at most MAX_STAGES, each an input
// tile and its chunk's slab
int ring_stages(int ck, int ns) {
  const int n = (SMEM_LIMIT - FIXED_BYTES) / (x_bytes(ck) + slab_bytes(ck, ns));
  return n < MAX_STAGES ? n : MAX_STAGES;
}

int smem_bytes(int cin, int cout) {
  const int ck = chunk_channels(cin), ns = slice_channels(cout);
  return ring_stages(ck, ns) * (x_bytes(ck) + slab_bytes(ck, ns)) + FIXED_BYTES;
}

struct ConvArgs {
  const float* x;     // (B, Cin, D, H, W)
  const float* w;     // packed and split weights
  const float* bias;  // (Cout,); null for a kCastBias conv without one (the dx)
  float* out;         // (B, Cout, D, H, W)
  const float* pa;    // prologue: (B, Cin)
  const float* pt;
  const float* xr;    // kDxMask: the boundary conv's raw input, (B, Cout, D, H, W)
  const float* ea;    // kDxMask: its affine, (B, Cout)
  const float* et;
  float* partial;     // kBiasStats, kDxMask: one value per (run, tile)
  int B, Cin, Cout, D, H, W;
  int tile_d, tiles_w, tiles_h, nblk, nslices, nunits;  // nblk: tiles per batch element
  int ck, ks, nchunks, nst;
  int tma;            // the tensor map is set: W % 4 == 0, x 16-byte aligned
};

// A unit of work: one output tile and one slice of its output channels.
struct UnitAt {
  int b, blk, sl, d0, h0, w0;
};

__device__ __forceinline__ UnitAt unit_at(const ConvArgs& p, int unit) {
  const int tile = unit / p.nslices, sl = unit - tile * p.nslices;
  const int b = tile / p.nblk, blk = tile - b * p.nblk;
  const int tw = blk % p.tiles_w, r = blk / p.tiles_w;
  return {b, blk, sl, (r / p.tiles_h) * p.tile_d, (r % p.tiles_h) * TILE_H, tw * TILE_W};
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

// Wait for the mbarrier at bar to complete the phase of the given parity;
// trap rather than hang if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

// the TMA copy of a 5-D box at coordinates (c0 innermost .. c4) into the
// shared address dst, completing on the mbarrier at bar
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(bar)
      : "memory");
}

// bytes contiguous bytes from global src into the shared address dst,
// completing on the mbarrier at bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving an accumulator's reads or writes across a
// wgmma fence or wait
template <int NA>
__device__ __forceinline__ void fence_operands(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major operand without swizzle at shared address
// addr: core matrices of 8 rows x 16 bytes, 16 N bytes apart along K
// (leading byte offset) and 128 bytes apart along N (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int n) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(n) << 16) | (uint64_t(8) << 32);
}

// d (64 x N fp32, the accumulator fragment) = a (64 x 8 TF32, this thread's
// 4 values of the register fragment) * b (8 x N TF32, at desc) + (scale_d ?
// d : 0)
template <int N>
struct Wgmma;

template <>
struct Wgmma<48> {
  __device__ static __forceinline__ void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  __device__ static __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <int NS, int EPI, bool PRO>
__global__ void __launch_bounds__(128 * warpgroups(NS), 1)
    conv3_f32_kernel(const ConvArgs p, const __grid_constant__ CUtensorMap tx) {
  constexpr bool SUMS = EPI == kBiasStats || EPI == kDxMask;
  constexpr int THREADS = 128 * warpgroups(NS);
  constexpr int N = 3 * NS;     // the wgmma's width: (kw, channel of the slice)
  constexpr int NA = N / 2;     // accumulators of one m64 tile a thread
  constexpr int NM = NS / 2;    // master sums of one m64 tile a thread
  using MMA = Wgmma<N>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = warp >> 2, wq = warp & 3;   // warpgroup (output plane), warp in it
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' groupID, threadID_in_group
  const int xbytes = x_bytes(p.ck), wbytes = slab_bytes(p.ck, NS);
  const int sb = xbytes + wbytes;  // a stage: the input tile, then the chunk's slab
  unsigned char* fixed = smem + p.nst * sb;
  int4* table = reinterpret_cast<int4*>(fixed);
  float2* at_s = reinterpret_cast<float2*>(fixed + TABLE_BYTES);
  float* red = reinterpret_cast<float*>(fixed + TABLE_BYTES + AT_BYTES);
  const uint32_t smem_s = uint32_t(__cvta_generic_to_shared(smem));
  const uint32_t bar0 = smem_s + uint32_t(p.nst * sb + TABLE_BYTES + AT_BYTES + RED_BYTES);
  // this thread's staged offset of fragment row gq (input voxel w0 - 1 + gq)
  // of output row (plane g, row wq), before the tile's shift and the k's
  const int tbase = (g * XH + wq) * XW + gq;

  // the k table: lane q of a quad at k step s takes k = 8 s + q and 8 s + q
  // + 4, k = CK pair + ci over the 9 (kd, kh) pairs: their staged offsets,
  // and (1 << pair) | ci << 27; a padded k reads pair 0 of channel 0
  const int kpad = 9 * p.ck;
  for (int i = tid; i < p.ks * 4; i += THREADS) {
    int off[2], meta[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 8 * (i >> 2) + (i & 3) + 4 * j;
      const int pair = k < kpad ? k / p.ck : 0, ci = k < kpad ? k % p.ck : 0;
      off[j] = ci * XCH + ((pair / 3) * XH + pair % 3) * XW;
      meta[j] = (1 << pair) | (ci << 27);
    }
    table[i] = make_int4(off[0], off[1], meta[0], meta[1]);
  }
  if (tid == 0) {
    for (int s = 0; s < p.nst; ++s) mbar_init(bar0 + 8u * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int my_units = (p.nunits - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  const int items = my_units * p.nchunks;

  // Start item it (the block's unit it / nchunks, chunk it % nchunks) into
  // stage it % nst: with the tensor map thread 0 arms the stage's mbarrier
  // and starts the box's TMA copy (from voxel w0 - 1 rounded down to 4) and
  // the slab's bulk copy; else every thread copies the staged voxels w0 - 1
  // .. w0 + 14 of each row in 4-byte cp.async pieces (zero outside the volume
  // and past Cin) and commits a group, and thread 0 starts the slab's copy.
  auto issue = [&](int it) {
    const int st = it % p.nst;
    const int lu = it / p.nchunks, c = it - lu * p.nchunks;
    const UnitAt at = unit_at(p, int(blockIdx.x) + lu * int(gridDim.x));
    const uint32_t dst = smem_s + uint32_t(st * sb);
    const uint32_t bar = bar0 + 8u * st;
    const int sh = (at.w0 - 1) & 3;  // voxel w0 - 1's place in a staged row
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stage's last reads
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"((p.tma ? p.ck * XCH * 4 : 0) + wbytes)
                   : "memory");
      if (p.tma)
        tma_load_5d(dst, &tx, at.w0 - 1 - sh, at.h0 - 1, at.d0 - 1, c * p.ck, at.b, bar);
      bulk_load(dst + uint32_t(xbytes), p.w + size_t(at.sl * p.nchunks + c) * (wbytes / 4),
                uint32_t(wbytes), bar);
    }
    if (!p.tma) {
      const int per_ch = (p.tile_d + 2) * XH * 16;
#pragma unroll 1
      for (int i = tid; i < p.ck * per_ch; i += THREADS) {
        const int ci = i / per_ch, r = i - ci * per_ch;
        const int row = r >> 4, j = r & 15;
        const int c_in = c * p.ck + ci;
        const int gd = at.d0 - 1 + row / XH, gh = at.h0 - 1 + row % XH, gw = at.w0 - 1 + j;
        const bool in = c_in < p.Cin && gd >= 0 && gd < p.D && gh >= 0 && gh < p.H && gw >= 0 &&
                        gw < p.W;
        const float* src =
            in ? p.x + ((size_t(at.b) * p.Cin + c_in) * p.D + gd) * size_t(p.H) * p.W +
                     size_t(gh) * p.W + gw
               : p.x;
        cp_async4(dst + 4u * uint32_t(ci * XCH + row * XW + sh + j), src, in);
      }
      cp_async_commit();
    }
  };

  for (int it = 0; it < items && it < p.nst; ++it) issue(it);

  float master[MT][NM] = {};  // the unit's sums, chunk after chunk: (row, channel)
  float acc[MT][NA] = {};     // the tensor core's sum of one chunk: (row, kw, channel)
  uint32_t rowmask[MT][2] = {{0u, 0u}, {0u, 0u}};  // PRO: (kd, kh) pairs inside the volume
  int cur_b = -1;
#pragma unroll 1
  for (int it = 0; it < items; ++it) {
    const int st = it % p.nst;
    const int lu = it / p.nchunks, c = it - lu * p.nchunks;
    const UnitAt at = unit_at(p, int(blockIdx.x) + lu * int(gridDim.x));
    if (PRO && c == 0) {
      if (at.b != cur_b) {  // (a, t) of the unit's batch element, 0 past Cin
        // every warp is past the previous item's last barrier: no reads
        if (tid < 64)
          at_s[tid] = tid < p.Cin ? make_float2(p.pa[at.b * p.Cin + tid], p.pt[at.b * p.Cin + tid])
                                  : make_float2(0.0f, 0.0f);
        __syncthreads();
        cur_b = at.b;
      }
      // bit 3 kd + kh of row (mt, v1): the voxel at (kd, kh) of its input
      // voxel w0 - 1 + gq + 8 v1 lies inside the volume
      int vd = 0, vh[MT] = {0, 0};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int gd = at.d0 - 1 + g + k;
        vd |= (gd >= 0 && gd < p.D) << k;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int gh = at.h0 - 1 + 4 * mt + wq + k;
          vh[mt] |= (gh >= 0 && gh < p.H) << k;
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int v1 = 0; v1 < 2; ++v1) {
          const int gw = at.w0 - 1 + gq + 8 * v1;
          uint32_t m = 0;
#pragma unroll
          for (int kd = 0; kd < 3; ++kd)
#pragma unroll
            for (int kh = 0; kh < 3; ++kh)
              if ((vd >> kd) & (vh[mt] >> kh) & 1) m |= 1u << (3 * kd + kh);
          rowmask[mt][v1] = gw >= 0 && gw < p.W ? m : 0u;
        }
    }
    mbar_wait(bar0 + 8u * st, uint32_t(it / p.nst) & 1u);  // the box and the slab landed
    if (!p.tma) {
      cp_async_wait<0>();
      __syncthreads();  // every thread's pieces landed
    }
    const float* xs = reinterpret_cast<const float*>(smem + st * sb) + tbase + ((at.w0 - 1) & 3);
    const uint64_t desc0 = b_desc(smem_s + uint32_t(st * sb + xbytes), N);
    const float2* at_c = at_s + c * p.ck;
    // k step s's table entry for this lane: its two offsets (and, with the
    // prologue, their (1 << pair) | ci << 27)
    auto entry = [&](int s) {
      if (PRO) return table[4 * s + tq];
      const int2 o = reinterpret_cast<const int2*>(table)[2 * (4 * s + tq)];
      return make_int4(o.x, o.y, 0, 0);
    };
    // k step s's raw A values of both m64 tiles (4 staged values each, at
    // the offsets of its table entry e) and the entry of step s + 1
    auto fetch = [&](int s, float (&v)[MT][4], int4& e, int4& next) {
      e = next;
      const float* p0 = xs + e.x;
      const float* p1 = xs + e.y;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        v[mt][0] = p0[4 * XW * mt];
        v[mt][1] = p0[4 * XW * mt + 8];
        v[mt][2] = p1[4 * XW * mt];
        v[mt][3] = p1[4 * XW * mt + 8];
      }
      if (s + 1 < p.ks) next = entry(s + 1);
    };
    // the raw values through the prologue, split into the A fragments' hi
    // and lo (both 19-bit TF32 patterns): hi = v rounded to 10 mantissa bits
    // (to nearest, ties away, as cvt.rna; integer add and mask), lo = v - hi
    // (exact in fp32) cut to its top 19 bits
    auto split = [&](float (&v)[MT][4], const int4& e, uint32_t (&hi)[MT][4],
                     uint32_t (&lo)[MT][4]) {
      if (PRO) {
        const float2 a0 = at_c[uint32_t(e.z) >> 27], a1 = at_c[uint32_t(e.w) >> 27];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 a = i < 2 ? a0 : a1;
            const bool in = (rowmask[mt][i & 1] & uint32_t(i < 2 ? e.z : e.w)) != 0u;
            v[mt][i] = in ? prologue(v[mt][i], a.x, a.y) : 0.0f;
          }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[mt][i] = (__float_as_uint(v[mt][i]) + 0x1000u) & 0xffffe000u;
          lo[mt][i] = __float_as_uint(__fsub_rn(v[mt][i], __uint_as_float(hi[mt][i]))) &
                      0xffffe000u;
        }
    };
    // k step s's wgmmas: lo_a hi_b, hi_a lo_b, hi_a hi_b per m64 tile, into
    // the chunk's accumulator (from zero at the chunk's first k step)
    auto mma = [&](int s, const uint32_t (&hi)[MT][4], const uint32_t (&lo)[MT][4]) {
      const uint64_t dhi = desc0 + uint64_t(s * 4 * N);  // 64 N bytes a k step, >> 4
      const uint64_t dlo = dhi + uint64_t(2 * N);
      wg_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        MMA::mma(acc[mt], lo[mt], dhi, s != 0);
        MMA::mma(acc[mt], hi[mt], dlo, 1);
        MMA::mma(acc[mt], hi[mt], dhi, 1);
      }
      wg_commit();
    };

    // a software pipeline: k step s + 1's loads are in flight while step s's
    // values are split and its wgmmas issue; the A registers are
    // double-buffered, so a step's split waits only for the wgmmas of the
    // step before the last
    uint32_t ah0[MT][4], al0[MT][4], ah1[MT][4], al1[MT][4];
    float v[MT][4];
    int4 e, next = entry(0);
    fetch(0, v, e, next);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
#pragma unroll 1
    for (int s = 0; s < p.ks; s += 2) {
      split(v, e, ah0, al0);  // buffer 0's last reader, k step s - 2, is done
      if (s + 1 < p.ks) fetch(s + 1, v, e, next);
      mma(s, ah0, al0);
      wg_wait<1>();           // k step s - 1 is done: buffer 1 is free
      if (s + 1 < p.ks) {
        split(v, e, ah1, al1);
        if (s + 2 < p.ks) fetch(s + 2, v, e, next);
        mma(s + 1, ah1, al1);
        wg_wait<1>();         // k step s is done: buffer 0 is free
      }
    }
    wg_wait<0>();
    // the chunk's sums: output row r (fragment row r, r = gq + 8 v1) of a
    // channel is ((row r - 1 at kw 0 + row r at kw 1) + row r + 1 at kw 2),
    // the neighbours' rows from the lanes 4 apart (row 7 and row 8 across
    // the halves); then added to the master sums
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      fence_operands(acc[mt]);
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int v0 = 0; v0 < 2; ++v0) {
          const float* a = acc[mt] + 4 * j + v0;  // (kw, v1) at a[4 kw NS / 8 + 2 v1]
          const float l0 = __shfl_sync(0xffffffffu, a[0], (lane + 28) & 31);
          const float l1x = __shfl_sync(0xffffffffu, a[2], (lane + 28) & 31);
          const float r0x = __shfl_sync(0xffffffffu, a[NS + 0], (lane + 4) & 31);
          const float r1 = __shfl_sync(0xffffffffu, a[NS + 2], (lane + 4) & 31);
          const float l1 = gq > 0 ? l1x : l0, r0 = gq < 7 ? r0x : r1;
          const float s0 = __fadd_rn(__fadd_rn(l0, a[NS / 2]), r0);
          const float s1 = __fadd_rn(__fadd_rn(l1, a[NS / 2 + 2]), r1);
          float& m0 = master[mt][4 * j + v0];
          float& m1 = master[mt][4 * j + 2 + v0];
          m0 = c == 0 ? s0 : __fadd_rn(m0, s0);
          m1 = c == 0 ? s1 : __fadd_rn(m1, s1);
        }
    }

    if (c == p.nchunks - 1) {
      // the epilogue: master (mt, 4 j + 2 v1 + v0) is channel sl NS + 8 j +
      // 2 tq + v0 of output voxel w0 + gq + 8 v1 - 1 (rows 1 to 14 only) of
      // row 4 mt + wq of plane g
      const int gd = at.d0 + g;
      const size_t vol = size_t(p.D) * p.H * p.W;
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int v0 = 0; v0 < 2; ++v0) {
          const int cl = 8 * j + 2 * tq + v0, co = at.sl * NS + cl;
          const bool cok = co < p.Cout;
          float bias = 0.0f, ea = 0.0f, et = 0.0f;
          if (cok && (EPI == kBiasRelu || EPI == kBiasStats || (EPI == kCastBias && p.bias)))
            bias = p.bias[co];
          if (cok && EPI == kDxMask) ea = p.ea[at.b * p.Cout + co], et = p.et[at.b * p.Cout + co];
          float r0 = 0.0f, r1 = 0.0f;  // this thread's terms of the two channel sums
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int v1 = 0; v1 < 2; ++v1) {
              const float a = master[mt][4 * j + 2 * v1 + v0];
              const int r = gq + 8 * v1;
              const int gh = at.h0 + 4 * mt + wq, gw = at.w0 + r - 1;
              const bool in = cok && r >= 1 && r <= TILE_W && gd < p.D && gh < p.H && gw < p.W;
              const size_t o = (size_t(at.b) * p.Cout + co) * vol +
                               (size_t(gd) * p.H + gh) * p.W + gw;
              float u;
              if (EPI == kBiasRelu) {
                const float t = __fadd_rn(a, bias);
                u = t < 0.0f ? 0.0f : t;  // ReLU that keeps a NaN
              } else if (EPI == kBiasStats) {
                u = __fadd_rn(a, bias);
                if (in) {
                  r0 = __fadd_rn(r0, u);
                  r1 = __fadd_rn(r1, __fmul_rn(u, u));  // the square rounded, then added
                }
              } else if (EPI == kDxMask) {  // a is dr
                const float xv = in ? __ldg(p.xr + o) : 0.0f;
                const float du = __fadd_rn(__fmul_rn(xv, ea), et) > 0.0f ? a : 0.0f;
                u = __fmul_rn(du, ea);
                if (in) {
                  r0 = __fadd_rn(r0, __fmul_rn(du, xv));  // no FMA contraction into the sum
                  r1 = __fadd_rn(r1, du);
                }
              } else {
                u = p.bias != nullptr ? __fadd_rn(a, bias) : a;
              }
              if (in) p.out[o] = u;
            }
          if (SUMS) {
#pragma unroll
            for (int sh = 4; sh < 32; sh <<= 1) {  // the 8 lanes of channel co
              r0 = __fadd_rn(r0, __shfl_xor_sync(0xffffffffu, r0, sh));
              r1 = __fadd_rn(r1, __shfl_xor_sync(0xffffffffu, r1, sh));
            }
            if (gq == 0) {
              red[(warp * 2) * NS + cl] = r0;
              red[(warp * 2 + 1) * NS + cl] = r1;
            }
          }
        }
      if (SUMS) {
        __syncthreads();
        for (int jj = tid; jj < 2 * NS; jj += THREADS) {  // jj = which sum * NS + channel
          const int cl = jj % NS, k = jj / NS, co = at.sl * NS + cl;
          if (co >= p.Cout) continue;
          float s = red[k * NS + cl];
#pragma unroll
          for (int wp = 1; wp < THREADS / 32; ++wp)
            s = __fadd_rn(s, red[(wp * 2 + k) * NS + cl]);
          // the partials of one output are contiguous: kBiasStats sums over the
          // batch too, (k, co) outputs of (b, tile) partials; kDxMask has
          // (k, b, co) outputs of (tile) partials
          const size_t run = EPI == kBiasStats ? (size_t(k) * p.Cout + co) * p.B + at.b
                                               : (size_t(k) * p.B + at.b) * p.Cout + co;
          p.partial[run * p.nblk + at.blk] = s;
        }
      }
    }
    __syncthreads();  // every warp is done with stage st (and with red)
    if (it + p.nst < items) issue(it + p.nst);
  }
}

// out[r] = the sum of partial[r * len : (r + 1) * len], one block per run,
// in a fixed order: thread i sums elements i, i + 256, ... and a fixed
// tree sums the threads (conv3.cu's conv3_stats_reduce_kernel).
__global__ void __launch_bounds__(RTHREADS)
conv3_f32_stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                              int len) {
  __shared__ float s[RTHREADS];
  const float* run = partial + size_t(blockIdx.x) * len;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < len; i += RTHREADS) acc += run[i];
  s[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int h = RTHREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no link to
// libcuda); null where the driver has none
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The tensor map of x (B, C, D, H, W) fp32 with a box of (ck, XD, XH, XW),
// zero outside the tensor.
bool encode_map(CUtensorMap* map, const float* x, int B, int C, int D, int H, int W, int ck) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[5] = {cuuint64_t(W), cuuint64_t(H), cuuint64_t(D), cuuint64_t(C),
                              cuuint64_t(B)};
  const cuuint64_t row = cuuint64_t(W) * 4;
  const cuuint64_t strides[4] = {row, row * H, row * H * D, row * H * D * C};
  const cuuint32_t box[5] = {cuuint32_t(XW), cuuint32_t(XH), cuuint32_t(XD), cuuint32_t(ck), 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(x), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch, once the wrapper's descriptor (grid, threads, dynamic shared
// memory) is checked against the kernel's own: a wrapper that computed
// another gets cudaErrorInvalidConfiguration and nothing runs. sums: (2,
// Cout) for kBiasStats, (2, B, Cout) for kDxMask, after the reduce; null
// otherwise.
template <int NS, int EPI, bool PRO>
cudaError_t launch(ConvArgs args, float* sums, dim3 grid, int threads, int smem,
                   cudaStream_t stream) {
  args.ck = chunk_channels(args.Cin);
  args.ks = k_steps(args.ck);
  args.nchunks = (args.Cin + args.ck - 1) / args.ck;
  args.nst = ring_stages(args.ck, NS);
  args.nslices = (args.Cout + NS - 1) / NS;
  args.tiles_w = (args.W + TILE_W - 1) / TILE_W;
  args.tiles_h = (args.H + TILE_H - 1) / TILE_H;
  args.tile_d = warpgroups(NS);
  args.nblk = args.tiles_w * args.tiles_h * ((args.D + args.tile_d - 1) / args.tile_d);
  args.nunits = args.B * args.nblk * args.nslices;
  if (threads != 128 * warpgroups(NS) || smem != smem_bytes(args.Cin, args.Cout) || grid.y != 1 ||
      grid.z != 1 || grid.x < 1 || int(grid.x) > args.nunits)
    return cudaErrorInvalidConfiguration;
  CUtensorMap tx{};
  args.tma = args.W % 4 == 0 && (reinterpret_cast<uintptr_t>(args.x) & 15) == 0;
  if (args.tma && !encode_map(&tx, args.x, args.B, args.Cin, args.D, args.H, args.W, args.ck))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(conv3_f32_kernel<NS, EPI, PRO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv3_f32_kernel<NS, EPI, PRO><<<grid.x, threads, smem, stream>>>(args, tx);
  err = cudaGetLastError();
  if (err != cudaSuccess || !(EPI == kBiasStats || EPI == kDxMask)) return err;
  const int runs = EPI == kBiasStats ? 2 * args.Cout : args.B * 2 * args.Cout;
  const int len = EPI == kBiasStats ? args.B * args.nblk : args.nblk;
  conv3_f32_stats_reduce_kernel<<<runs, RTHREADS, 0, stream>>>(args.partial, sums, len);
  return cudaGetLastError();
}

template <int EPI, bool PRO>
int dispatch(ConvArgs args, float* sums, dim3 grid, int threads, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args.Cout < 1 || args.Cout > 64) return int(cudaErrorInvalidValue);
  return slice_channels(args.Cout) == 16 ? launch<16, EPI, PRO>(args, sums, grid, threads, smem, s)
                                         : launch<32, EPI, PRO>(args, sums, grid, threads, smem, s);
}

ConvArgs conv_args(const void* x, const void* w, const void* bias, void* out, int B, int Cin,
                   int Cout, int D, int H, int W) {
  ConvArgs a{};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.B = B, a.Cin = Cin, a.Cout = Cout, a.D = D, a.H = H, a.W = W;
  return a;
}

}  // namespace

// Dynamic shared memory of a conv3_f32_kernel block for Cin = cin and Cout =
// cout (1 to 64): the ring's stages, the k table, the prologue's (a, t),
// the sums' scratch and the mbarriers; 0 for another Cin or Cout.
MMSEG_API int mmseg_conv3_f32_smem_bytes(int cout, int cin) {
  if (cin < 1 || cout < 1 || cout > 64) return 0;
  return smem_bytes(cin, cout);
}

// Kernel 7 in fp32: out = relu(conv(x, w) + bias); grid, threads and smem
// as ops/conv3.py:f32_launch_dims computes them.
MMSEG_API int mmseg_conv3_f32_bias_relu(const void* x, const void* w, const void* bias,
                                        void* out, int B, int Cin, int Cout, int D, int H,
                                        int W, int grid_x, int grid_y, int grid_z, int threads,
                                        int smem, void* stream) {
  if (x == nullptr || w == nullptr || bias == nullptr || out == nullptr || Cin < 1)
    return int(cudaErrorInvalidValue);
  if (B == 0 || D == 0 || H == 0 || W == 0) return int(cudaSuccess);
  return dispatch<kBiasRelu, false>(conv_args(x, w, bias, out, B, Cin, Cout, D, H, W), nullptr,
                                    dim3(grid_x, grid_y, grid_z), threads, smem, stream);
}

// Kernel 1 in fp32: out = conv(x, w) + bias, or conv(x, w) where bias is
// null (its dx, on the flipped and transposed weights); the descriptor as
// for mmseg_conv3_f32_bias_relu.
MMSEG_API int mmseg_conv3_f32(const void* x, const void* w, const void* bias, void* out, int B,
                              int Cin, int Cout, int D, int H, int W, int grid_x, int grid_y,
                              int grid_z, int threads, int smem, void* stream) {
  if (x == nullptr || w == nullptr || out == nullptr || Cin < 1) return int(cudaErrorInvalidValue);
  if (B == 0 || D == 0 || H == 0 || W == 0) return int(cudaSuccess);
  return dispatch<kCastBias, false>(conv_args(x, w, bias, out, B, Cin, Cout, D, H, W), nullptr,
                                    dim3(grid_x, grid_y, grid_z), threads, smem, stream);
}

// Kernel 12 in fp32: out = conv(relu(x * a + t), w) + bias, a, t (B, Cin);
// the descriptor as for mmseg_conv3_f32.
MMSEG_API int mmseg_conv3_f32_prologue(const void* x, const void* w, const void* bias,
                                       const void* a, const void* t, void* out, int B, int Cin,
                                       int Cout, int D, int H, int W, int grid_x, int grid_y,
                                       int grid_z, int threads, int smem, void* stream) {
  if (x == nullptr || w == nullptr || bias == nullptr || a == nullptr || t == nullptr ||
      out == nullptr || Cin < 1)
    return int(cudaErrorInvalidValue);
  if (B == 0 || D == 0 || H == 0 || W == 0) return int(cudaSuccess);
  ConvArgs args = conv_args(x, w, bias, out, B, Cin, Cout, D, H, W);
  args.pa = static_cast<const float*>(a);
  args.pt = static_cast<const float*>(t);
  return dispatch<kCastBias, true>(args, nullptr, dim3(grid_x, grid_y, grid_z), threads, smem,
                                   stream);
}

// Kernel 3 in fp32: out = conv(x, w) + bias and stats (2, Cout) = (sum
// out, sum out^2); partial holds 2 * Cout * B * (blocks per batch element)
// floats; the descriptor as for mmseg_conv3_f32.
MMSEG_API int mmseg_conv3_f32_stats(const void* x, const void* w, const void* bias, void* out,
                                    void* partial, void* stats, int B, int Cin, int Cout, int D,
                                    int H, int W, int grid_x, int grid_y, int grid_z,
                                    int threads, int smem, void* stream) {
  if (x == nullptr || w == nullptr || bias == nullptr || out == nullptr || partial == nullptr ||
      stats == nullptr || Cin < 1 || B < 1 || D < 1 || H < 1 || W < 1)
    return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(x, w, bias, out, B, Cin, Cout, D, H, W);
  args.partial = static_cast<float*>(partial);
  return dispatch<kBiasStats, false>(args, static_cast<float*>(stats),
                                     dim3(grid_x, grid_y, grid_z), threads, smem, stream);
}

// Kernel 4 in fp32: kernel 3 on relu(x * a + t), a, t (B, Cin).
MMSEG_API int mmseg_conv3_f32_prologue_stats(const void* x, const void* w, const void* bias,
                                             const void* a, const void* t, void* out,
                                             void* partial, void* stats, int B, int Cin,
                                             int Cout, int D, int H, int W, int grid_x,
                                             int grid_y, int grid_z, int threads, int smem,
                                             void* stream) {
  if (x == nullptr || w == nullptr || bias == nullptr || a == nullptr || t == nullptr ||
      out == nullptr || partial == nullptr || stats == nullptr || Cin < 1 || B < 1 || D < 1 ||
      H < 1 || W < 1)
    return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(x, w, bias, out, B, Cin, Cout, D, H, W);
  args.pa = static_cast<const float*>(a);
  args.pt = static_cast<const float*>(t);
  args.partial = static_cast<float*>(partial);
  return dispatch<kBiasStats, true>(args, static_cast<float*>(stats),
                                    dim3(grid_x, grid_y, grid_z), threads, smem, stream);
}

// Kernel 5 in fp32: g (B, Cg, D, H, W) with the flipped, transposed
// weights packed for Cin = Cg, Cout = Cx; x (B, Cx, D, H, W) and a, t (B,
// Cx) of the boundary conv -> dy (B, Cx, D, H, W) and dadt (2, B, Cx) =
// (da, dt); partial holds B * 2 * Cx * (blocks per batch element) floats;
// the descriptor as for mmseg_conv3_f32 on g with Cout = Cx.
MMSEG_API int mmseg_conv3_f32_dx_epilogue(const void* g, const void* w, const void* x,
                                          const void* a, const void* t, void* dy,
                                          void* partial, void* dadt, int B, int Cg, int Cx,
                                          int D, int H, int W, int grid_x, int grid_y,
                                          int grid_z, int threads, int smem, void* stream) {
  if (g == nullptr || w == nullptr || x == nullptr || a == nullptr || t == nullptr ||
      dy == nullptr || partial == nullptr || dadt == nullptr || Cg < 1 || B < 1 || D < 1 ||
      H < 1 || W < 1)
    return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(g, w, nullptr, dy, B, Cg, Cx, D, H, W);
  args.xr = static_cast<const float*>(x);
  args.ea = static_cast<const float*>(a);
  args.et = static_cast<const float*>(t);
  args.partial = static_cast<float*>(partial);
  return dispatch<kDxMask, false>(args, static_cast<float*>(dadt), dim3(grid_x, grid_y, grid_z),
                                  threads, smem, stream);
}
