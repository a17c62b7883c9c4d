// SAME 3x3x3 convolution on channel-first bf16 volumes: one implicit-GEMM
// body with a compile-time input prologue and a compile-time epilogue.
//
// Replaces: multimodal_segmentation_project_tpu/ops/pallas_conv.py
//   * _fwd_bias_act_kernel (public op conv3x3x3_cf_relu, the eval forward,
//     BatchNorm folded into w and b by the caller): epilogue kBiasRelu,
//     out = bf16(relu(acc + bias)) with the fp32 bias;
//   * _fwd_kernel (public op conv3x3x3_cf, the training forward, and the dx
//     of its backward): epilogue kCastBias, out = bf16(acc) and then, when
//     a bias is given, bf16(out + bf16(bias)): the bias is added in the
//     working dtype after the conv's one cast, as conv3x3x3_cf rounds. The
//     dx is this kernel on the cotangent with the weights flipped
//     spatially and Cin/Cout swapped (the wrapper packs them), no bias;
//   * _fwd_stats_kernel (conv3x3x3_cf_stats, conv0 of the fused training
//     DoubleConv): epilogue kBiasStats, y = bf16(acc + bias) with the fp32
//     bias added before the one cast, and per channel the sums of float(y)
//     and float(y)^2 of that rounded value;
//   * _fwd_prologue_stats_kernel (conv3x3x3_cf_boundary_stats, conv1 of the
//     fused DoubleConv): kBiasStats with the prologue on: the input is
//     staged as bf16(relu(x * a + t)) (conv3_fwd_tile.cuh), a, t fp32 per
//     (batch, channel), the halo kept 0;
//   * _fwd_prologue_kernel (conv3x3x3_cf_boundary): kCastBias with the
//     prologue on;
//   * _dx_epilogue_kernel (the backward of both boundary ops): epilogue
//     kDxMask on the dx conv of the cotangent (flipped, transposed
//     weights). With the conv's fp32 result dr, the boundary conv's raw
//     input x and its affine (a, t) at the output coordinates:
//     u = x * a + t, du = u > 0 ? dr : 0, dy = bf16(du * a), and per
//     (batch, channel) the sums of du * x (da) and of du (dt). Its output
//     channels are the boundary conv's INPUT channels; a, t, x are indexed
//     by them.
//
// Layout: x (B, Cin, D, H, W) bf16, bias (Cout,) fp32 or null (kCastBias
// only), out (B, Cout, D, H, W) bf16, a, t (B, Cin) fp32 for the prologue,
// xr (B, Cout, D, H, W) bf16 and a, t (B, Cout) fp32 for kDxMask, all
// contiguous. The weights arrive packed by the wrapper
// (ops/conv3.py:pack_weights) as the kernel's shared-memory image, one slab
// per chunk of 16 input channels: (ceil(Cin/16), 27, Cout16, 16) bf16,
// zero-padded in Cin and in Cout (Cout16 = Cout rounded up to 16).
//
// Design: an implicit GEMM with M = output voxels, N = Cout16 (at most 64)
// and K = 27 * Cin, on the tensor cores through mma.sync.m16n8k16 (bf16
// in, fp32 accumulators in registers), its operands read from shared
// memory by ldmatrix. One block of 16 warps computes a (TD=4) x (TH=8) x
// (TW=16) output tile for every output channel (conv3_fwd_tile.cuh): 512
// voxels, a TW that divides 48, 96 and 192, and 1080 staged voxels for
// 512 outputs (2.1 reads per output voxel). Warp w owns output rows 2w and
// 2w + 1 (two m16 tiles) for all Cout16 channels: 16 fp32 accumulators a
// thread per 16 channels. The K loop runs over chunks of 16 input
// channels through a two-stage ring in shared memory: while the MMAs of
// chunk c read stage c % 2, the weight slab of chunk c + 1 (27 * Cout16
// rows of 32 bytes, 55 KB at Cout = 64) and its haloed input tile (as a
// W-minor raw tile) fly in by cp.async, zero-filled outside the volume;
// after the MMAs one transform pass writes the raw tile channel-minor
// into the other stage, through the prologue when it is on. Each of the
// 27 taps is an address shift of the A rows: no im2col copy. Rows of both
// operands are 32 bytes, their 16-byte halves swizzled on bit 2 of the
// row, so ldmatrix and the transform's stores are free of bank conflicts.
// With one chunk (Cin <= 16) the second stage is not allocated, and at
// Cout = 16 the registers are capped at 64 a thread, so that two blocks
// share an SM and one block's loads and epilogue overlap the other's
// MMAs. Cin = 1 (the first encoder conv) is a chunk with 15 zero
// channels: 16x the tensor-core work K = 27 needs, 0.1 ms at the bf16
// peak for 1->16 @192^3, which the kernel does not approach.
//
// Epilogue: the accumulators go to an fp32 stage in shared memory (pitch
// TM + 4 words: the fragment stores are conflict-free), aliasing the
// ring. Each thread then takes 8 consecutive voxels along W of one
// channel: it reads them as two 16-byte words, computes the epilogue
// exactly as the plain version rounds, writes 16 bytes (2-byte stores at
// a ragged edge or an unaligned W), and sums its terms of the channel
// sums in registers before one 5-step shuffle tree per sum.
//
// Channel sums across blocks: the TPU kernels carry them across a
// sequential grid; here blocks run in parallel. Each block reduces its
// tile per channel in a fixed order (8 voxels a thread, a warp tree, the
// two warps of the channel in order) and writes one partial per (sum,
// channel[, batch]); conv3_stats_reduce_kernel then sums each run of
// partials in a fixed order (one block per run, a strided sum per thread
// and a fixed tree). The result is the same bits on every run, as
// conv3_dw.cu's two passes.
//
// What bounds it on an H100: at the 192^3 level the tensor-core work is
// small (98 GFLOP for a 16->16 conv, ~0.1 ms at the bf16 peak), and a
// 16->16 conv must move about 453 MB (x and y, 0.135 ms at 3.35 TB/s); the
// dx epilogue reads g and x and writes dy, about 680 MB (0.203 ms). The
// prologue and the epilogues add a few fp32 operations per staged or
// written element and nothing to the bytes: their point is that the
// activated input, and the dx conv's fp32 dr, never exist in device
// memory. The kernel is bound by its shared-memory traffic instead: each
// m16 x k16 A fragment (512 bytes through ldmatrix) serves Cout16 / 8
// MMAs, so at Cout = 16 the MMA loop reads about 384 bytes of shared
// memory per MMA, which caps it near 3 cycles per MMA per SM, 0.3 ms for
// a 16->16 conv at 192^3; the staging and the epilogue add their passes
// on top, and at Cout >= 32 one block per SM leaves a one-chunk tile's
// load latency exposed. wgmma (operands read by the tensor cores from
// shared memory) and TMA are later work.
#include "conv3_fwd_tile.cuh"

using namespace conv3f;

namespace {

enum Epilogue { kBiasRelu = 0, kCastBias = 1, kBiasStats = 2, kDxMask = 3 };

constexpr int RTHREADS = 256;      // threads of the cross-block reduce
constexpr int LDS = TM + 4;        // fp32 stage pitch: 4 (mod 16) words, no bank conflicts
constexpr int GROUPS = TM / 8;     // 8-voxel groups of one channel in the epilogue
constexpr int CO_STEP = THREADS / GROUPS;
static_assert(THREADS % GROUPS == 0, "the epilogue gives each thread 8 voxels of one channel");

template <int COUT>
struct ConvSmem {
  static constexpr size_t w_bytes = size_t(27) * COUT * ROW_BYTES;  // one weight slab
  static constexpr size_t x_bytes = size_t(X_VOX) * ROW_BYTES;      // one haloed input tile
  static constexpr size_t region_bytes = w_bytes + x_bytes;         // one stage of the ring
  // after the K loop: the fp32 accumulators, then per channel, per half of
  // its groups (one warp each), the two sums of kBiasStats / kDxMask
  static constexpr size_t stage_bytes = size_t(COUT) * LDS * sizeof(float);
  static constexpr size_t red_bytes = size_t(COUT) * 2 * 2 * sizeof(float);
  // the raw tile follows the ring: its second stage only with two or more
  // chunks, so that a one-chunk conv at Cout = 16 fits two blocks per SM
  __host__ __device__ static constexpr size_t raw_at(int nchunks) {
    return (nchunks > 1 ? 2 : 1) * region_bytes;
  }
  __host__ __device__ static constexpr size_t bytes(int nchunks) {
    return raw_at(nchunks) + RAW_BYTES > stage_bytes + red_bytes ? raw_at(nchunks) + RAW_BYTES
                                                                 : stage_bytes + red_bytes;
  }
};

// Blocks per SM the registers are capped for: two at Cout = 16, where a
// one-chunk conv's shared memory allows it, one otherwise.
__host__ __device__ constexpr int blocks_per_sm(int cout) { return cout == 16 ? 2 : 1; }

struct ConvArgs {
  const bf16* x;      // (B, Cin, D, H, W)
  const bf16* w;      // packed weights
  const float* bias;  // (Cout,) or null
  bf16* out;          // (B, Cout, D, H, W)
  const float* pa;    // prologue: (B, Cin)
  const float* pt;
  const bf16* xr;     // kDxMask: the boundary conv's raw input, (B, Cout, D, H, W)
  const float* ea;    // kDxMask: its affine, (B, Cout)
  const float* et;
  float* partial;     // kBiasStats, kDxMask: one value per (run, block)
  int B, Cin, Cout, D, H, W, tiles_w;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row major) * b (16x8, col major), bf16 in, fp32 out
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copy the weight slab of `chunk` into ring stage `dst` (a shared address),
// each 32-byte (tap, cout) row swizzled as the ldmatrix reads expect.
template <int COUT>
__device__ __forceinline__ void copy_weights(uint32_t dst, const bf16* __restrict__ w, int chunk) {
  constexpr int W_VECS = 27 * COUT * 2;  // 16-byte vectors per slab
  const bf16* src = w + size_t(chunk) * 27 * COUT * CK;
  for (int i = threadIdx.x; i < W_VECS; i += THREADS)
    cp_async16(dst + swz(i >> 1, i & 1), src + 8 * i, true);
  cp_async_commit();
}

template <int COUT, int EPI, bool PRO>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(COUT)) conv3_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = ConvSmem<COUT>;
  constexpr bool SUMS = EPI == kBiasStats || EPI == kDxMask;
  constexpr int NP = COUT / 16;  // pairs of n8 tiles
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int th_i = blockIdx.x / p.tiles_w;
  const int h0 = th_i * TH;
  const int w0 = (blockIdx.x - th_i * p.tiles_w) * TW;
  const int d0 = blockIdx.y * TD;
  const int b = blockIdx.z;
  const int nchunks = (p.Cin + CK - 1) / CK;
  const uint32_t smem_s = uint32_t(__cvta_generic_to_shared(smem));
  const uint32_t raw_at = uint32_t(S::raw_at(nchunks));
  unsigned char* const raw_g = smem + raw_at;
  TileAt at{b, 0, p.Cin, p.D, p.H, p.W, d0, h0, w0};
  const bool vec = p.W % 8 == 0 && aligned16(p.x);

  // ldmatrix row of this lane. A: matrix q = lane / 8 of the m16 x k16
  // tile holds rows 8 (q & 1) .. + 7 and channel half q >> 1. B: matrix q
  // of an n16 x k16 pair holds couts 8 (q >> 1) .. + 7 and channel half q & 1.
  const int a_half = lane >> 4;
  int a_vox[MF];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
    const int orow = warp * MF + mf;
    a_vox[mf] = ((orow / TH) * HR + orow % TH) * WR + (lane & 7) + ((lane >> 3) & 1) * 8;
  }
  // the (tap, cout) row is a multiple of 16 plus b_n, so bit 2 is b_n's
  const uint32_t b_off = swz((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);

  float acc[MF][2 * NP][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nt][e] = 0.0f;

  // The K loop runs over chunks of 16 input channels through a two-stage
  // ring: while the MMAs of chunk c read stage c % 2, the weights of chunk
  // c + 1 land in the other stage and its input in the raw tile, which the
  // transform then writes into the other stage.
  load_raw(smem_s + raw_at, raw_g, p.x, at, vec);
  copy_weights<COUT>(smem_s, p.w, 0);
  cp_async_wait_all();
  __syncthreads();
  transform<PRO>(smem + S::w_bytes, raw_g, p.pa, p.pt, at);
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    const int s = c & 1;
    const bool more = c + 1 < nchunks;
    if (more) {
      at.c0 = (c + 1) * CK;
      load_raw(smem_s + raw_at, raw_g, p.x, at, vec);
      copy_weights<COUT>(smem_s + (s ^ 1) * uint32_t(S::region_bytes), p.w, c + 1);
    }
    const uint32_t ws = smem_s + s * uint32_t(S::region_bytes);
    const uint32_t xs = ws + uint32_t(S::w_bytes);
#pragma unroll 1
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int tap = (kd * 3 + kh) * 3 + kw;
          const int shift = (kd * HR + kh) * WR + kw;
          uint32_t af[MF][4];
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) ldsm_x4(af[mf], xs + swz(a_vox[mf] + shift, a_half));
#pragma unroll
          for (int np = 0; np < NP; ++np) {
            uint32_t bf[4];
            ldsm_x4(bf, ws + b_off + uint32_t(tap * COUT + 16 * np) * ROW_BYTES);
#pragma unroll
            for (int mf = 0; mf < MF; ++mf) {
              mma16816(acc[mf][2 * np], af[mf], bf[0], bf[1]);
              mma16816(acc[mf][2 * np + 1], af[mf], bf[2], bf[3]);
            }
          }
        }
      }
    }
    if (more) {
      cp_async_wait_all();
      __syncthreads();  // chunk c + 1 has landed in the raw tile and stage s ^ 1
      transform<PRO>(smem + (s ^ 1) * S::region_bytes + S::w_bytes, raw_g, p.pa, p.pt, at);
    }
    __syncthreads();  // stage s ^ 1 is ready; stage s and the raw tile are free
  }

  // accumulators -> stage[co][m]; the stage aliases the ring, which every
  // warp is done with (the last barrier of the K loop)
  float* stage = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + S::stage_bytes);
  {
    const int fr = lane >> 2, fc = 2 * (lane & 3);
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      const int m = (warp * MF + mf) * TW + fr;
#pragma unroll
      for (int nt = 0; nt < 2 * NP; ++nt) {
        float* s = stage + (nt * 8 + fc) * LDS + m;
        s[0] = acc[mf][nt][0];
        s[LDS] = acc[mf][nt][1];
        s[8] = acc[mf][nt][2];
        s[LDS + 8] = acc[mf][nt][3];
      }
    }
  }
  __syncthreads();

  // thread: voxels [8 g, 8 g + 8) of the tile (along W) of channels co,
  // co + CO_STEP, ...; a warp holds 32 groups of one channel
  const int D = p.D, H = p.H, W = p.W, Cout = p.Cout;
  const int g = tid % GROUPS;
  const int orow = g >> 1;
  const int gd = d0 + orow / TH, gh = h0 + orow % TH, gw = w0 + (g & 1) * 8;
  const int n_in = gd < D && gh < H ? min(max(W - gw, 0), 8) : 0;
  const size_t hw = size_t(H) * W;
  const size_t vol = hw * D;
  const size_t voxel = size_t(gd) * hw + size_t(gh) * W + gw;
  const bool vec_out = n_in == 8 && W % 8 == 0 && aligned16(p.out) &&
                       (EPI != kDxMask || aligned16(p.xr));
  for (int co = tid / GROUPS; co < COUT && co < Cout; co += CO_STEP) {  // warp-uniform
    const float4 lo = *reinterpret_cast<const float4*>(stage + co * LDS + 8 * g);
    const float4 hi = *reinterpret_cast<const float4*>(stage + co * LDS + 8 * g + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t o = (size_t(b) * Cout + co) * vol + voxel;
    float xv[8];
    if (EPI == kDxMask) {
      const unsigned short* xr = reinterpret_cast<const unsigned short*>(p.xr) + o;
      uint32_t w4[4] = {0u, 0u, 0u, 0u};
      if (vec_out) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(xr));
        w4[0] = q.x, w4[1] = q.y, w4[2] = q.z, w4[3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < n_in) w4[e >> 1] |= uint32_t(xr[e]) << (16 * (e & 1));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        xv[e] = __uint_as_float((w4[e >> 1] >> (16 * (e & 1))) << 16);
    }
    float bias = 0.0f, ea = 0.0f, et = 0.0f;
    if (EPI == kBiasRelu || EPI == kBiasStats) bias = p.bias[co];
    if (EPI == kCastBias && p.bias != nullptr)
      bias = __bfloat162float(__float2bfloat16(p.bias[co]));  // the bias in the working dtype
    if (EPI == kDxMask) ea = p.ea[b * Cout + co], et = p.et[b * Cout + co];
    uint32_t y[4] = {0u, 0u, 0u, 0u};
    float r0 = 0.0f, r1 = 0.0f;  // this thread's terms of the two channel sums
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e >= n_in) continue;
      bf16 out;
      if (EPI == kBiasRelu) {
        float u = v[e] + bias;
        u = u < 0.0f ? 0.0f : u;  // ReLU that keeps a NaN, as jnp.maximum does
        out = __float2bfloat16(u);
      } else if (EPI == kCastBias) {
        out = __float2bfloat16(v[e]);
        if (p.bias != nullptr) out = __float2bfloat16(__bfloat162float(out) + bias);
      } else if (EPI == kBiasStats) {
        out = __float2bfloat16(v[e] + bias);
        const float yf = __bfloat162float(out);
        r0 += yf;
        r1 += yf * yf;  // the square is exact: 8 significant bits squared
      } else {  // kDxMask: v is dr
        const float du = __fadd_rn(__fmul_rn(xv[e], ea), et) > 0.0f ? v[e] : 0.0f;
        out = __float2bfloat16(__fmul_rn(du, ea));
        r0 += __fmul_rn(du, xv[e]);  // no FMA contraction into the sum
        r1 += du;
      }
      y[e >> 1] |= uint32_t(__bfloat16_as_ushort(out)) << (16 * (e & 1));
    }
    if (vec_out) {
      *reinterpret_cast<uint4*>(p.out + o) = make_uint4(y[0], y[1], y[2], y[3]);
    } else {
      unsigned short* dst = reinterpret_cast<unsigned short*>(p.out) + o;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n_in) dst[e] = (unsigned short)(y[e >> 1] >> (16 * (e & 1)));
    }
    if (SUMS) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        r0 += __shfl_xor_sync(0xffffffffu, r0, s);
        r1 += __shfl_xor_sync(0xffffffffu, r1, s);
      }
      if (lane == 0) {
        red[(co * 2 + (g >> 5)) * 2] = r0;
        red[(co * 2 + (g >> 5)) * 2 + 1] = r1;
      }
    }
  }

  if (SUMS) {
    __syncthreads();
    const int nblk = gridDim.x * gridDim.y;
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    for (int j = tid; j < 2 * Cout; j += THREADS) {  // j = which sum * Cout + channel
      const int co = j % Cout, k = j / Cout;
      const float s = red[(co * 2) * 2 + k] + red[(co * 2 + 1) * 2 + k];
      // the partials of one output are contiguous: kBiasStats sums over the
      // batch too, (k, co) outputs of (b, block) partials; kDxMask has
      // (k, b, co) outputs of (block) partials
      const size_t run =
          EPI == kBiasStats ? size_t(j) * p.B + b : (size_t(k) * p.B + b) * Cout + co;
      p.partial[run * nblk + blk] = s;
    }
  }
}
// out[r] = the sum of partial[r * len : (r + 1) * len], one block per run,
// in a fixed order: thread i sums elements i, i + 256, ... and a fixed
// tree sums the threads.
__global__ void __launch_bounds__(RTHREADS)
conv3_stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int len) {
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

// sums: (2, Cout) for kBiasStats, (2, B, Cout) for kDxMask; null otherwise
template <int COUT, int EPI, bool PRO>
cudaError_t launch(const ConvArgs& args, float* sums, cudaStream_t stream) {
  const int smem = int(ConvSmem<COUT>::bytes((args.Cin + CK - 1) / CK));
  cudaError_t err = cudaFuncSetAttribute(conv3_kernel<COUT, EPI, PRO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (args.H + TH - 1) / TH;
  dim3 grid(args.tiles_w * tiles_h, (args.D + TD - 1) / TD, args.B);
  conv3_kernel<COUT, EPI, PRO><<<grid, THREADS, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || !(EPI == kBiasStats || EPI == kDxMask)) return err;
  const int nblk = int(grid.x * grid.y);
  const int runs = EPI == kBiasStats ? 2 * args.Cout : args.B * 2 * args.Cout;
  const int len = EPI == kBiasStats ? args.B * nblk : nblk;
  conv3_stats_reduce_kernel<<<runs, RTHREADS, 0, stream>>>(args.partial, sums, len);
  return cudaGetLastError();
}

template <int EPI, bool PRO>
int dispatch(ConvArgs args, float* sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  args.tiles_w = (args.W + TW - 1) / TW;
  switch ((args.Cout + 15) / 16) {
    case 1: return launch<16, EPI, PRO>(args, sums, s);
    case 2: return launch<32, EPI, PRO>(args, sums, s);
    case 3: return launch<48, EPI, PRO>(args, sums, s);
    case 4: return launch<64, EPI, PRO>(args, sums, s);
    default: return int(cudaErrorInvalidValue);
  }
}

ConvArgs conv_args(const void* x, const void* w, const void* bias, void* out, int B, int Cin,
                   int Cout, int D, int H, int W) {
  ConvArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.B = B, a.Cin = Cin, a.Cout = Cout, a.D = D, a.H = H, a.W = W;
  return a;
}

}  // namespace

// Dynamic shared memory of a conv3_kernel block for Cout16 = cout16 (16,
// 32, 48 or 64) and nchunks chunks of 16 input channels; 0 for another Cout16.
MMSEG_API int mmseg_conv3_smem_bytes(int cout16, int nchunks) {
  switch (cout16) {
    case 16: return int(ConvSmem<16>::bytes(nchunks));
    case 32: return int(ConvSmem<32>::bytes(nchunks));
    case 48: return int(ConvSmem<48>::bytes(nchunks));
    case 64: return int(ConvSmem<64>::bytes(nchunks));
    default: return 0;
  }
}

MMSEG_API int mmseg_conv3_bias_relu(const void* x, const void* w, const void* bias, void* out,
                                    int B, int Cin, int Cout, int D, int H, int W,
                                    void* stream) {
  if (bias == nullptr) return int(cudaErrorInvalidValue);
  return dispatch<kBiasRelu, false>(conv_args(x, w, bias, out, B, Cin, Cout, D, H, W), nullptr,
                                    stream);
}

// bias may be null (the dx use): then out = bf16(acc).
MMSEG_API int mmseg_conv3(const void* x, const void* w, const void* bias, void* out, int B,
                          int Cin, int Cout, int D, int H, int W, void* stream) {
  return dispatch<kCastBias, false>(conv_args(x, w, bias, out, B, Cin, Cout, D, H, W), nullptr,
                                    stream);
}

// Kernel 12: the conv of bf16(relu(x * a + t)), cast, then the bias in bf16.
MMSEG_API int mmseg_conv3_prologue(const void* x, const void* w, const void* bias,
                                   const void* a, const void* t, void* out, int B, int Cin,
                                   int Cout, int D, int H, int W, void* stream) {
  if (bias == nullptr || a == nullptr || t == nullptr) return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(x, w, bias, out, B, Cin, Cout, D, H, W);
  args.pa = static_cast<const float*>(a);
  args.pt = static_cast<const float*>(t);
  return dispatch<kCastBias, true>(args, nullptr, stream);
}

// Kernel 3: y = bf16(conv + bias) and stats (2, Cout) = (sum y, sum y^2);
// partial holds 2 * Cout * B * (blocks per batch element) floats.
MMSEG_API int mmseg_conv3_stats(const void* x, const void* w, const void* bias, void* out,
                                void* partial, void* stats, int B, int Cin, int Cout, int D,
                                int H, int W, void* stream) {
  if (bias == nullptr) return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(x, w, bias, out, B, Cin, Cout, D, H, W);
  args.partial = static_cast<float*>(partial);
  return dispatch<kBiasStats, false>(args, static_cast<float*>(stats), stream);
}

// Kernel 4: kernel 3 on bf16(relu(x * a + t)).
MMSEG_API int mmseg_conv3_prologue_stats(const void* x, const void* w, const void* bias,
                                         const void* a, const void* t, void* out,
                                         void* partial, void* stats, int B, int Cin, int Cout,
                                         int D, int H, int W, void* stream) {
  if (bias == nullptr || a == nullptr || t == nullptr) return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(x, w, bias, out, B, Cin, Cout, D, H, W);
  args.pa = static_cast<const float*>(a);
  args.pt = static_cast<const float*>(t);
  args.partial = static_cast<float*>(partial);
  return dispatch<kBiasStats, true>(args, static_cast<float*>(stats), stream);
}

// Kernel 5: g (B, Cg, D, H, W) with the flipped, transposed weights packed
// for Cin = Cg, Cout = Cx; x (B, Cx, D, H, W) and a, t (B, Cx) of the
// boundary conv -> dy (B, Cx, D, H, W) and dadt (2, B, Cx) = (da, dt);
// partial holds B * 2 * Cx * (blocks per batch element) floats.
MMSEG_API int mmseg_conv3_dx_epilogue(const void* g, const void* w, const void* x,
                                      const void* a, const void* t, void* dy, void* partial,
                                      void* dadt, int B, int Cg, int Cx, int D, int H, int W,
                                      void* stream) {
  if (x == nullptr || a == nullptr || t == nullptr) return int(cudaErrorInvalidValue);
  ConvArgs args = conv_args(g, w, nullptr, dy, B, Cg, Cx, D, H, W);
  args.xr = static_cast<const bf16*>(x);
  args.ea = static_cast<const float*>(a);
  args.et = static_cast<const float*>(t);
  args.partial = static_cast<float*>(partial);
  return dispatch<kDxMask, false>(args, static_cast<float*>(dadt), stream);
}
