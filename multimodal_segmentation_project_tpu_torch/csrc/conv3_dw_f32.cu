// Weight gradient of the SAME 3x3x3 convolution on channel-first fp32
// volumes, at fp32 accuracy on the tensor cores (3xTF32):
//
//   dW[kd, kh, kw, ci, co] = sum over b, v of x[b, ci, v + (kd, kh, kw) - 1] * g[b, co, v]
//
// with x zero outside the volume (the SAME halo).
//
// Replaces: multimodal_segmentation_project_tpu/ops/pallas_conv.py
//   * _dw_kernel_shared (the dW of conv3x3x3_cf's backward, _conv_dw_shared)
//     on fp32 x and cotangent, as the JAX package runs it under its fp32
//     policy (it stages in x's dtype): conv3_dw_f32_partial_kernel<MW,
//     false>, mmseg_conv3_dw_f32;
//   * _dw_kernel_prologue (the dW of the fused DoubleConv's boundary convs,
//     _conv_dw_prologue) on fp32 x, a, t and cotangent: the input staged as
//     relu(x * a + t) with a, t (B, Cin) fp32 per (batch, channel), the
//     SAME halo kept 0: conv3_dw_f32_partial_kernel<MW, true>,
//     mmseg_conv3_dw_f32_prologue.
//
// Why 3xTF32. An fp32 dW is held to 2e-5 of max |dW|. One TF32 product
// (operands rounded to 10 mantissa bits) errs by about 1e-3 of itself,
// which leaves a dW about 3e-4 of max |dW| off: one TF32 pass misses the
// bound by far (chip_smoke.py's TF32 control shows it). Split each operand
// once, v = hi + lo with hi = tf32(v) and lo = tf32(v - hi) (cvt.rna: round
// to nearest, ties away); then a * b = lo_a hi_b + hi_a lo_b + hi_a hi_b +
// (terms of 2^-22 |a b| and less), so three TF32 products carry a product
// to about fp32's accuracy. The tensor core adds the eight products of an
// m16n8k8 step and its accumulator in its own order, truncating; a chain of
// thousands of such steps would drift toward zero. So each k step's three
// MMAs start from zero (the two small products first, then hi * hi, into
// the same fragment, as CUTLASS's 3xTF32 orders them) and the fragment is
// added to the thread's fp32 accumulators by FADD, which rounds to
// nearest: the sum order is an fp32 sum of k-step fragments, as the FFMA
// body's was of products.
//
// Layout: x (B, Cin, D, H, W) fp32, g (B, Cout, D, H, W) fp32, dW (27, Cin,
// Cout) fp32 = (3, 3, 3, Cin, Cout), all contiguous. The wrapper allocates
// the fp32 scratch `partial` of nblk * 27 * Cin * Cout values
// (ops/conv3.py:dw_f32_operands picks nblk).
//
// Design: an implicit GEMM dW^T[tap] (Cout x Cin) = g (Cout x K) x(tap)^T
// (K x Cin), K = the output voxels, on mma.sync.m16n8k8.row.col.f32.tf32:
// M is 16 output channels (the unshifted cotangent), N is 8 columns, K is 8
// voxels of one output row.
//
//   1. conv3_dw_f32_partial_kernel<MW, PRO>: grid (nblk, ceil(Cin / CIB),
//      ceil(Cout / COB)), DW_THREADS = 576 threads, 18 warps, one block an
//      SM; MW = 1 (Cout <= 16) or 2 m16 tiles of output channels a block.
//      Block (k, i, j) owns input channels [CIB i, CIB i + CIB), output
//      channels [COB j, COB j + COB) and all 27 taps, and walks the output
//      tiles k, k + nblk, ... of the volume (DTD x DTH x DTW = 3 x 3 x 16
//      voxels, W fastest, then H, D and the batch).
//      Staging: a ring of two raw stages. Where W % 4 == 0 and x and g are
//      16-byte aligned, one thread starts two TMA copies a tile
//      (cp.async.bulk.tensor, 5-D boxes of the input's 16 channels x 5 x 5
//      rows x 24 voxels from (c0, d0 - 1, h0 - 1, w0 - 4): a box's first
//      voxel lies on 16 bytes, w0 - 1 does not; and of the
//      cotangent's 16 MW channels x 3 x 3 x 16 voxels; the tensor map's
//      zero fill outside the tensor is the SAME halo and the channels past
//      Cin and Cout), completing on the stage's mbarrier; else every
//      thread copies a staged row in 4-byte cp.async pieces, zero-filled
//      alike. A version whose threads issued 16-byte cp.async pieces spent
//      as long waiting on them as on its MMAs. With the prologue, a and t
//      of the tile's batch element land beside it (cp.async). Tile i + 2's
//      copies are in flight while tile i's MMAs run. Between two barriers
//      a split pass then writes every staged element once into a hi plane
//      and a lo plane (with the prologue, relu(x * a + t) first, rounded
//      after each operation, no FMA contraction, a NaN kept, on the voxels
//      inside the volume only: the halo and the channels past Cin stay 0);
//      nothing is split in the MMA loop.
//      The columns of a block are (kd, kh, ci) with ci fastest: CIB channels
//      a (kd, kh) pair, or, where Cin = 1, the 9 pairs themselves, so that
//      the image's conv fills the warps as the others do. One column's B
//      values for the three kw taps come from one staged row at shifts 0,
//      1, 2: with the k index permuted (lane t holds voxels 2t and 2t + 1
//      of a k step, in A and B alike), a lane reads 4 consecutive floats of
//      a plane (two 8-byte loads) and takes (v0, v1), (v1, v2), (v2, v3) as
//      the B fragments of kw = 0, 1, 2. A's fragment is two 8-byte loads
//      per 8 rows, reused over the warp's 2 column groups x 3 kw.
//      Warp w takes job w % J and k steps w / J, w / J + 18 / J, ... of the
//      tile's 18 (DTD DTH rows x 2 halves): a job is a pair of column groups
//      (one (kd, kh) pair's 16 channels, or every pair where Cin = 1) and
//      one m16 tile: 2 x 3 fragments, 24 fp32 accumulators a thread (18
//      warps leave five on a scheduler and 96 registers a thread; a job of
//      two m16 tiles, 48 accumulators, spilled). J = 9 MW jobs, or MW where
//      Cin = 1: the 18 / J warps of a job split its k steps, and at the end
//      they add their sums in warp order through shared memory. Every entry
//      of every block's partial is written once, a block without tiles
//      writing zeros.
//   2. conv3_dw_f32_reduce_kernel: one thread per dW element sums the nblk
//      partials in block order.
// The split over blocks and warps is fixed by the SM count and the channel
// counts, so the result is the same bits on every run on one card. No
// atomics.
//
// Shared memory: the planes have channel pitches CP = 456 (x) and GP = 152
// (g) floats, both 8 or 24 (mod 32): a fragment's 8-byte loads by the 16
// lanes of a half warp (4 rows x 4 pairs of words) fall on 32 different
// banks. MW = 2: 211216 bytes a block.
//
// What bounds it on an H100 (an fp32 train step's dW shapes, 2-fp32 over
// conv0's and dec1.conv1's, 6-fp32 over conv1's): about 720 GFLOP of fp32
// products, 10.2 ms at 67 TFLOP/s of FFMA; as 3xTF32 three times that on
// the tensor cores, 4.1 ms at 494.7 TFLOP/s dense (about 2.2 and 1.9 ms
// for the two instances), a rate that only wgmma reaches: mma.sync's TF32
// products ran at about 200 TFLOP/s on an H100 (dw_dissect.py --fp32,
// mma_only against mma_only_1x), so the MMA loop alone takes about 7.5 and
// 6.6 ms a step; the bytes, each input read once, about 1.7 GB, 0.5 ms at
// 3.35 TB/s. Per k step a warp issues 18 MMAs for 12 8-byte loads (A's
// fragment 4, the B values of two column groups 8), 171 bytes of shared
// memory an MMA. What is left beside the MMAs is the split pass between its
// two barriers (about a fifth of the time) and the loads (a twentieth).
#include <cuda.h>

#include "conv3_f32_tile.cuh"

namespace {

using conv3f32::cp_async4;
using conv3f32::cp_async_commit;
using conv3f32::cp_async_wait;
using conv3f32::prologue;

constexpr int DTD = 3;                    // output depth planes per tile
constexpr int DTH = 3;                    // output rows per plane
constexpr int DTW = 16;                   // output voxels per row
constexpr int DHR = DTH + 2;              // haloed rows per staged plane
constexpr int XROWS = (DTD + 2) * DHR;    // staged input rows per channel
constexpr int XW = DTW + 2;               // plane row: voxels w0 - 1 .. w0 + 16
constexpr int RAW_PITCH = 24;             // raw input row: voxels w0 - 4 .. w0 + 19
constexpr int RAW_W0 = 4;                 // voxel w0's place in a raw input row
constexpr int ROWS_OUT = DTD * DTH;       // output rows per tile
constexpr int VOX = ROWS_OUT * DTW;       // output voxels per tile
constexpr int KSTEPS = 2 * ROWS_OUT;      // k steps of 8 voxels per tile
constexpr int CIB = 16;                   // input channels per block
constexpr int COB = 32;                   // output channels per block (at most)
constexpr int CP = 456;                   // plane floats per input channel
constexpr int GP = 152;                   // plane floats per output channel
constexpr int PAIRS = 9;                  // (kd, kh) pairs
constexpr int DW_WARPS = 18;
constexpr int DW_THREADS = 576;
constexpr int RTHREADS = 256;             // threads of the reduce
constexpr int NACC = 2 * 3 * 4;           // accumulators per thread
constexpr int XPLANE = CIB * CP;          // one input plane (hi or lo), in floats
constexpr int RX_FLOATS = CIB * XROWS * RAW_PITCH;  // a raw input stage
static_assert(DW_THREADS == 32 * DW_WARPS, "18 warps");
static_assert(CP >= XROWS * XW && GP >= VOX, "a channel's plane holds its tile");
static_assert(CP % 32 == 8 || CP % 32 == 24, "conflict-free 8-byte B loads");
static_assert(GP % 32 == 8 || GP % 32 == 24, "conflict-free 8-byte A loads");
static_assert(CP % 2 == 0 && GP % 4 == 0 && XW % 2 == 0, "aligned fragment loads");
static_assert(RAW_PITCH % 4 == 0 && RAW_W0 % 4 == 0 && RAW_PITCH >= RAW_W0 + DTW + 1,
              "16-byte aligned raw rows holding a plane row");

// MW m16 tiles of output channels (16 MW a block); offsets in floats:
// the planes, then two raw stages (input, cotangent, a and t), then the
// stages' two mbarriers
template <int MW>
struct Cfg {
  static constexpr int COUT = 16 * MW;
  static constexpr int GPLANE = COUT * GP;                   // one cotangent plane
  static constexpr int GHI = 2 * XPLANE;                     // x hi, x lo, g hi, g lo
  static constexpr int PLANES = GHI + 2 * GPLANE;
  static constexpr int RG = RX_FLOATS;                       // in a stage
  static constexpr int RAT = RG + COUT * VOX;
  static constexpr int STAGE = RAT + 2 * CIB;
  static constexpr int BAR = PLANES + 2 * STAGE;
  static constexpr int FLOATS = BAR + 4;
  static constexpr int BYTES = FLOATS * 4;
  static constexpr uint32_t TX_BYTES = 4 * (RX_FLOATS + COUT * VOX);  // a tile's TMA bytes
  // after the last tile: the sums of the warps past the first of each job
  static constexpr int RED = (DW_WARPS - MW) * NACC * 32;
  static_assert(COUT <= COB, "a block's output channels");
  static_assert(PLANES % 32 == 0 && STAGE % 32 == 0 && RG % 32 == 0,
                "128-byte aligned TMA destinations");
  static_assert(RED <= PLANES && BYTES <= 232448, "fits one SM's shared memory");
};

struct DwArgs {
  const float* x;      // (B, Cin, D, H, W)
  const float* g;      // (B, Cout, D, H, W)
  const float* a;      // (B, Cin): the prologue's scale (kernel 6 only)
  const float* t;      // (B, Cin): its shift
  float* partial;      // (nblk, 27, Cin, Cout)
  int Cin, Cout, D, H, W;
  int tiles_w, tiles_h, tiles_d, ntiles;
  int tma;             // the tensor maps are set: W % 4 == 0, x and g 16-byte aligned
};

// The origin of output tile `tile`: its batch element and first voxel.
struct TileAt {
  int b, d0, h0, w0;
};

__device__ __forceinline__ TileAt tile_at(const DwArgs& p, int tile) {
  const int tw = tile % p.tiles_w;
  int r = tile / p.tiles_w;
  const int h0 = (r % p.tiles_h) * DTH;
  r /= p.tiles_h;
  return {r / p.tiles_d, (r % p.tiles_d) * DTD, h0, tw * DTW};
}

// v rounded to TF32 (10 mantissa bits, ties away from zero), as an fp32
__device__ __forceinline__ float tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xffffe000u);
}

// d = a (16x8, row major) * b (8x8, col major) + c, TF32 in, fp32 out
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], float b0, float b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
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

// Start output tile `tile`'s copies into the raw stage at shared address
// st (its mbarrier at bar) and commit a cp.async group: with the tensor
// maps, thread 0 arms the mbarrier and starts the two TMA copies; else
// each thread copies staged rows in 4-byte cp.async pieces: input rows
// (voxels w0 - 1 .. w0 + 16 of channel c0 + r / XROWS, zero outside the
// volume and past Cin), then the COUT ROWS_OUT cotangent rows.
// With the prologue the last 2 CIB threads copy a and t of the tile's
// batch element. The cp.async loops are not unrolled: the accumulators
// stay live through them, under the 96 registers a thread.
template <int MW, bool PRO>
__device__ __forceinline__ void issue_tile(uint32_t st, uint32_t bar, const DwArgs& p,
                                           const CUtensorMap* tx, const CUtensorMap* tg,
                                           int tile, int c0, int o0) {
  using C = Cfg<MW>;
  const TileAt at = tile_at(p, tile);
  const int i = threadIdx.x;
  if (p.tma) {
    if (i == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stage's last reads
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(C::TX_BYTES)
                   : "memory");
      tma_load_5d(st, tx, at.w0 - RAW_W0, at.h0 - 1, at.d0 - 1, c0, at.b, bar);
      tma_load_5d(st + uint32_t(C::RG) * 4u, tg, at.w0, at.h0, at.d0, o0, at.b, bar);
    }
  } else {
#pragma unroll 1
    for (int r = i; r < CIB * XROWS + C::COUT * ROWS_OUT; r += DW_THREADS) {
      if (r < CIB * XROWS) {
        const int c = c0 + r / XROWS, row = r % XROWS;
        const int gd = at.d0 - 1 + row / DHR, gh = at.h0 - 1 + row % DHR;
        const bool ok = c < p.Cin && gd >= 0 && gd < p.D && gh >= 0 && gh < p.H;
        const float* src = ok ? p.x + ((size_t(at.b) * p.Cin + c) * p.D + gd) * size_t(p.H) * p.W +
                                    size_t(gh) * p.W
                              : p.x;
        const uint32_t dst = st + uint32_t(r * RAW_PITCH) * 4u;
#pragma unroll 1
        for (int j = 0; j < XW; ++j) {
          const int w = at.w0 - 1 + j;
          const bool in = ok && w >= 0 && w < p.W;
          cp_async4(dst + 4u * (RAW_W0 - 1 + j), in ? src + w : p.x, in);
        }
      } else {
        const int cr = r - CIB * XROWS;  // channel * ROWS_OUT + output row
        const int co = o0 + cr / ROWS_OUT, orow = cr % ROWS_OUT;
        const int gd = at.d0 + orow / DTH, gh = at.h0 + orow % DTH;
        const bool ok = co < p.Cout && gd < p.D && gh < p.H;
        const float* src = ok ? p.g + ((size_t(at.b) * p.Cout + co) * p.D + gd) * size_t(p.H) *
                                          p.W + size_t(gh) * p.W
                              : p.g;
        const uint32_t dst = st + uint32_t(C::RG + cr * DTW) * 4u;
#pragma unroll 1
        for (int j = 0; j < DTW; ++j) {
          const bool in = ok && at.w0 + j < p.W;
          cp_async4(dst + 4u * j, in ? src + at.w0 + j : p.g, in);
        }
      }
    }
  }
  if (PRO && i >= DW_THREADS - 2 * CIB) {
    const int j = i - (DW_THREADS - 2 * CIB), c = j % CIB, which = j / CIB;  // 0: a, 1: t
    if (c0 + c < p.Cin)
      cp_async4(st + uint32_t(C::RAT + which * CIB + c) * 4u,
                (which ? p.t : p.a) + at.b * p.Cin + c0 + c, true);
  }
  cp_async_commit();
}

// Plane voxels j, j + 1 of an input row (hi: the row in the hi plane)
// from their values v0, v1: through the prologue where PRO and j lies in
// [in_lo, in_hi), then split into hi and lo.
template <bool PRO>
__device__ __forceinline__ void split_pair(float* hi, int j, float v0, float v1, int in_lo,
                                           int in_hi, float a, float t) {
  if (PRO) {
    if (j >= in_lo && j < in_hi) v0 = prologue(v0, a, t);
    if (j + 1 >= in_lo && j + 1 < in_hi) v1 = prologue(v1, a, t);
  }
  const float2 h = make_float2(tf32(v0), tf32(v1));
  reinterpret_cast<float2*>(hi)[j / 2] = h;
  reinterpret_cast<float2*>(hi + XPLANE)[j / 2] = make_float2(tf32(v0 - h.x), tf32(v1 - h.y));
}

// Row u of the landed raw stage rs split into the hi and lo planes: rows
// [0, XROWS nch) the staged input rows (channel, row) = (u / XROWS, u %
// XROWS), plane voxels w0 - 1 .. w0 + 16, through the prologue with PRO
// (the voxels inside the volume only); the next ones the cotangent rows of
// 16 voxels. The planes of the channels past Cin and Cout were zeroed
// once and are never written. (A version that gave a thread two cotangent
// rows, so that MW = 2's 688 rows fit 576 threads, was slower at every
// shape.)
template <int MW, bool PRO>
__device__ __forceinline__ void split_row(const float* rs, float* smem, const DwArgs& p,
                                          const TileAt& at, int nch, int u) {
  using C = Cfg<MW>;
  if (u < nch * XROWS) {
    const int c = u / XROWS, row = u % XROWS;
    const float4* raw = reinterpret_cast<const float4*>(rs + u * RAW_PITCH);
    float* hi = smem + c * CP + row * XW;
    // with the prologue, plane voxels [in_lo, in_hi) lie inside the volume
    int in_lo = XW, in_hi = 0;
    float a = 0.0f, t = 0.0f;
    if (PRO) {
      const int gd = at.d0 - 1 + row / DHR, gh = at.h0 - 1 + row % DHR;
      if (gd >= 0 && gd < p.D && gh >= 0 && gh < p.H) {
        in_lo = at.w0 == 0 ? 1 : 0, in_hi = min(XW, p.W - at.w0 + 1);
        a = rs[C::RAT + c], t = rs[C::RAT + CIB + c];
      }
    }
    // plane voxel j is raw voxel RAW_W0 - 1 + j: the left halo ends raw[0],
    // the row's 16 are raw[1..4], the right halo starts raw[5]
    float prev = raw[RAW_W0 / 4 - 1].w;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 q = raw[RAW_W0 / 4 + k];
      split_pair<PRO>(hi, 4 * k, prev, q.x, in_lo, in_hi, a, t);
      split_pair<PRO>(hi, 4 * k + 2, q.y, q.z, in_lo, in_hi, a, t);
      prev = q.w;
    }
    split_pair<PRO>(hi, XW - 2, prev, raw[RAW_W0 / 4 + 4].x, in_lo, in_hi, a, t);
  } else {
    const int cr = u - nch * XROWS;  // channel * ROWS_OUT + output row
    const float4* src = reinterpret_cast<const float4*>(rs + C::RG + cr * DTW);
    float4* g = reinterpret_cast<float4*>(smem + C::GHI + (cr / ROWS_OUT) * GP +
                                          (cr % ROWS_OUT) * DTW);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v = src[k];
      const float4 h = make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
      g[k] = h;
      g[C::GPLANE / 4 + k] = make_float4(tf32(v.x - h.x), tf32(v.y - h.y), tf32(v.z - h.z),
                                         tf32(v.w - h.w));
    }
  }
}

template <int MW, bool PRO>
__global__ void __launch_bounds__(DW_THREADS, 1)
    conv3_dw_f32_partial_kernel(const DwArgs p, const __grid_constant__ CUtensorMap tx,
                                const __grid_constant__ CUtensorMap tg) {
  using C = Cfg<MW>;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' groupID, threadID_in_group
  const int c0 = blockIdx.y * CIB, o0 = blockIdx.z * COB;
  const int nch = min(CIB, p.Cin - c0), ncout = min(C::COUT, p.Cout - o0);
  const int rows = XROWS * nch + ROWS_OUT * ncout;  // a tile's staged rows
  const int cinb = p.Cin == 1 ? 1 : CIB;            // columns per (kd, kh) pair
  const int npj = cinb == 1 ? 1 : PAIRS;            // pairs of column groups
  const int jobs = npj * MW;
  const int job = warp % jobs, kp = warp / jobs, ksplit = DW_WARPS / jobs;
  const int nj = job % npj, mt = job / npj;         // column groups 2 nj, 2 nj + 1; m16 tile
  const uint32_t smem_s = uint32_t(__cvta_generic_to_shared(smem));
  const uint32_t bar0 = smem_s + uint32_t(C::BAR) * 4u;

  // this lane's plane offsets: B of column groups 2 nj + q (column j = 8
  // (2 nj + q) + gq is (pair j / cinb, channel j % cinb); pairs past 8,
  // where Cin = 1, read pair 8 and are never written), and A of m16 tile mt
  int xoff[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = 8 * (2 * nj + q) + gq;
    const int pair = min(j / cinb, PAIRS - 1);
    xoff[q] = (j % cinb) * CP + ((pair / 3) * DHR + pair % 3) * XW + 2 * tq;
  }
  const int goff = C::GHI + (16 * mt + gq) * GP + 2 * tq;

  float acc[2][3][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][kw][e] = 0.0f;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  // the planes zeroed, the mbarriers set up, tiles first and first + nblk
  // started
  for (int i = tid; i < C::PLANES / 4; i += DW_THREADS)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8u));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int first = blockIdx.x, step = gridDim.x;
  for (int k = 0; k < 2; ++k) {
    if (first + k * step < p.ntiles)
      issue_tile<MW, PRO>(smem_s + uint32_t(C::PLANES + k * C::STAGE) * 4u, bar0 + 8u * k, p,
                          &tx, &tg, first + k * step, c0, o0);
    else
      cp_async_commit();
  }

  int n = 0;  // the block's tile count: tile n is in raw stage n % 2
  for (int tile = first; tile < p.ntiles; tile += step, ++n) {
    const int s = n & 1;
    cp_async_wait<1>();  // this thread's copies of tile n (tile n + 1's may be in flight)
    if (p.tma) mbar_wait(bar0 + 8u * s, (n >> 1) & 1);
    __syncthreads();  // tile n has landed; the MMAs of tile n - 1 are done
    const float* rs = smem + C::PLANES + s * C::STAGE;
    const TileAt at = tile_at(p, tile);
#pragma unroll 1
    for (int u = tid; u < rows; u += DW_THREADS) split_row<MW, PRO>(rs, smem, p, at, nch, u);
    __syncthreads();  // the planes are split; raw stage s is free
    if (tile + 2 * step < p.ntiles)
      issue_tile<MW, PRO>(smem_s + uint32_t(C::PLANES + s * C::STAGE) * 4u, bar0 + 8u * s, p,
                          &tx, &tg, tile + 2 * step, c0, o0);
    else
      cp_async_commit();
#pragma unroll 1
    for (int ks = kp; ks < KSTEPS; ks += ksplit) {
      const int r = ks >> 1, h = ks & 1;  // output row, its half
      const float* gh = smem + goff + r * DTW + 8 * h;
      const float2 h0 = *reinterpret_cast<const float2*>(gh);
      const float2 h8 = *reinterpret_cast<const float2*>(gh + 8 * GP);
      const float2 l0 = *reinterpret_cast<const float2*>(gh + C::GPLANE);
      const float2 l8 = *reinterpret_cast<const float2*>(gh + C::GPLANE + 8 * GP);
      const float ahi[4] = {h0.x, h8.x, h0.y, h8.y};
      const float alo[4] = {l0.x, l8.x, l0.y, l8.y};
      const int xk = ((r / DTH) * DHR + r % DTH) * XW + 8 * h;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* xh = smem + xoff[q] + xk;
        const float2 h01 = *reinterpret_cast<const float2*>(xh);
        const float2 h23 = *reinterpret_cast<const float2*>(xh + 2);
        const float2 l01 = *reinterpret_cast<const float2*>(xh + XPLANE);
        const float2 l23 = *reinterpret_cast<const float2*>(xh + XPLANE + 2);
        const float bh[4] = {h01.x, h01.y, h23.x, h23.y};
        const float bl[4] = {l01.x, l01.y, l23.x, l23.y};
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float d[4];
          mma_tf32(d, alo, bh[kw], bh[kw + 1], zero);
          mma_tf32(d, ahi, bl[kw], bl[kw + 1], d);
          mma_tf32(d, ahi, bh[kw], bh[kw + 1], d);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][kw][e] += d[e];
        }
      }
    }
  }

  // the warps of a job past the first hand their sums over; the first adds
  // them in warp order and writes the job's slice of the block's partial
  __syncthreads();  // every warp is done with the planes
  float* red = smem + job * NACC * 32 + lane;
  if (kp > 0) {
    float* mine = red + (kp - 1) * jobs * NACC * 32;
    int e = 0;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int i = 0; i < 4; ++i, ++e) mine[e * 32] = acc[q][kw][i];
  }
  __syncthreads();
  if (kp > 0) return;
  for (int k = 1; k < ksplit; ++k) {
    const float* theirs = red + (k - 1) * jobs * NACC * 32;
    int e = 0;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int i = 0; i < 4; ++i, ++e) acc[q][kw][i] += theirs[e * 32];
  }
  float* out = p.partial + size_t(blockIdx.x) * 27 * p.Cin * p.Cout;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int co = o0 + 16 * mt + gq + 8 * (i >> 1);
        const int j = 8 * (2 * nj + q) + 2 * tq + (i & 1);
        const int pair = j / cinb, ci = c0 + j % cinb;
        if (pair < PAIRS && ci < p.Cin && co < p.Cout)
          out[(size_t(3 * pair + kw) * p.Cin + ci) * p.Cout + co] = acc[q][kw][i];
      }
}

__global__ void __launch_bounds__(RTHREADS)
conv3_dw_f32_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int nblk,
                           int n_out) {
  const int i = blockIdx.x * RTHREADS + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += partial[size_t(k) * n_out + i];
  dw[i] = s;
}

// m16 tiles of a block's output channels: 1 where Cout <= 16, else 2 (a
// block of COB channels, the last one's past Cout zero)
int m_tiles(int cout) { return cout <= 16 ? 1 : 2; }

int smem_bytes(int cout) { return m_tiles(cout) == 1 ? Cfg<1>::BYTES : Cfg<2>::BYTES; }

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

// The tensor map of t (B, C, D, H, W) fp32 with a box of (box_c, box_d,
// box_h, box_w), zero outside the tensor.
bool encode_map(CUtensorMap* map, const float* t, int B, int C, int D, int H, int W, int box_c,
                int box_d, int box_h, int box_w) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[5] = {cuuint64_t(W), cuuint64_t(H), cuuint64_t(D), cuuint64_t(C),
                              cuuint64_t(B)};
  const cuuint64_t row = cuuint64_t(W) * 4;
  const cuuint64_t strides[4] = {row, row * H, row * H * D, row * H * D * C};
  const cuuint32_t box[5] = {cuuint32_t(box_w), cuuint32_t(box_h), cuuint32_t(box_d),
                             cuuint32_t(box_c), 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(t), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MW, bool PRO>
cudaError_t start(const DwArgs& args, const CUtensorMap& tx, const CUtensorMap& tg, dim3 grid,
                  int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(conv3_dw_f32_partial_kernel<MW, PRO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv3_dw_f32_partial_kernel<MW, PRO><<<grid, DW_THREADS, smem, s>>>(args, tx, tg);
  return cudaGetLastError();
}

// Check the descriptor against the kernel's own, then the two passes.
template <bool PRO>
int launch(const void* x, const void* g, const void* a, const void* t, void* partial, void* dw,
           int B, int Cin, int Cout, int D, int H, int W, int grid_x, int grid_y, int grid_z,
           int threads, int smem, void* stream) {
  if (x == nullptr || g == nullptr || partial == nullptr || dw == nullptr || Cin < 1 ||
      Cout < 1 || grid_x < 1 || (PRO && (a == nullptr || t == nullptr)))
    return int(cudaErrorInvalidValue);
  if (threads != DW_THREADS || smem != smem_bytes(Cout) || grid_y != (Cin + CIB - 1) / CIB ||
      grid_z != (Cout + COB - 1) / COB)
    return int(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DwArgs args{};
  args.x = static_cast<const float*>(x);
  args.g = static_cast<const float*>(g);
  args.a = static_cast<const float*>(a);
  args.t = static_cast<const float*>(t);
  args.partial = static_cast<float*>(partial);
  args.Cin = Cin, args.Cout = Cout, args.D = D, args.H = H, args.W = W;
  args.tiles_w = (W + DTW - 1) / DTW, args.tiles_h = (H + DTH - 1) / DTH;
  args.tiles_d = (D + DTD - 1) / DTD;
  args.ntiles = B * args.tiles_d * args.tiles_h * args.tiles_w;
  const int mw = m_tiles(Cout);
  CUtensorMap tx{}, tg{};
  args.tma = W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
             (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (args.tma &&
      !(encode_map(&tx, args.x, B, Cin, D, H, W, CIB, DTD + 2, DTH + 2, RAW_PITCH) &&
        encode_map(&tg, args.g, B, Cout, D, H, W, 16 * mw, DTD, DTH, DTW)))
    return int(cudaErrorNotSupported);
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaError_t err = mw == 1 ? start<1, PRO>(args, tx, tg, grid, smem, s)
                            : start<2, PRO>(args, tx, tg, grid, smem, s);
  if (err != cudaSuccess) return int(err);
  const int n_out = 27 * Cin * Cout;
  conv3_dw_f32_reduce_kernel<<<(n_out + RTHREADS - 1) / RTHREADS, RTHREADS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), grid_x, n_out);
  return int(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of a conv3_dw_f32_partial_kernel block for Cout
// output channels: the hi and lo planes of CIB input channels and 16 MW
// cotangent channels, two raw stages, their mbarriers.
MMSEG_API int mmseg_conv3_dw_f32_smem_bytes(int cout) { return smem_bytes(cout); }

// Kernel 2 in fp32: dW (27, Cin, Cout) from x (B, Cin, D, H, W) and g (B,
// Cout, D, H, W), through partial, an fp32 scratch of nblk * 27 * Cin *
// Cout; grid (nblk, ceil(Cin / CIB), ceil(Cout / COB)), threads and smem as
// ops/conv3.py:dw_f32_launch_dims computes them, checked against the
// kernel's own (another gets cudaErrorInvalidConfiguration and nothing
// runs).
MMSEG_API int mmseg_conv3_dw_f32(const void* x, const void* g, void* partial, void* dw, int B,
                                 int Cin, int Cout, int D, int H, int W, int grid_x, int grid_y,
                                 int grid_z, int threads, int smem, void* stream) {
  return launch<false>(x, g, nullptr, nullptr, partial, dw, B, Cin, Cout, D, H, W, grid_x,
                       grid_y, grid_z, threads, smem, stream);
}

// Kernel 6 in fp32: the dW of the conv of relu(x * a + t), a, t (B, Cin);
// the scratch and the descriptor as for mmseg_conv3_dw_f32.
MMSEG_API int mmseg_conv3_dw_f32_prologue(const void* x, const void* g, const void* a,
                                          const void* t, void* partial, void* dw, int B,
                                          int Cin, int Cout, int D, int H, int W, int grid_x,
                                          int grid_y, int grid_z, int threads, int smem,
                                          void* stream) {
  return launch<true>(x, g, a, t, partial, dw, B, Cin, Cout, D, H, W, grid_x, grid_y, grid_z,
                      threads, smem, stream);
}
