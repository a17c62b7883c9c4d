// Weight gradient of the SAME 3x3x3 convolution on channel-first bf16
// volumes, in fp32:
//
//   dW[kd, kh, kw, ci, co] = sum over b, v of x[b, ci, v + (kd, kh, kw) - 1] * g[b, co, v]
//
// with x zero outside the volume (the SAME halo).
//
// Replaces: multimodal_segmentation_project_tpu/ops/pallas_conv.py
//   * _dw_kernel_shared (the dW of conv3x3x3_cf's backward, _conv_dw_shared,
//     and of conv3x3x3_cf_stats's): conv3_dw_partial_kernel<.., false>;
//   * _dw_kernel_prologue (the dW of the fused boundary ops,
//     _conv_dw_prologue): conv3_dw_partial_kernel<.., true>, the same
//     product with the input staged as bf16(relu(x * a + t)), a, t fp32 per
//     (batch, channel), the halo kept 0.
//
// Layout: x (B, Cin, D, H, W) bf16, g (B, Cout, D, H, W) bf16, a, t (B, Cin)
// fp32 (prologue only), dW (27, Cin, Cout) fp32 = (3, 3, 3, Cin, Cout), all
// contiguous. The wrapper allocates the fp32 scratch `partial` of nblk *
// ceil(Cin/16) * 27 * 16 * Cout16 values (ops/conv3.py:dw_partial_blocks
// picks nblk).
//
// Design: a GEMM with M = 16 input channels (one chunk) per tap, N = Cout16
// and K = the output voxels, on the tensor cores through mma.sync.m16n8k16
// (bf16 in, fp32 accumulators in registers), its operands read from shared
// memory by ldmatrix. The tile and the input staging are the forward body's
// (conv3_fwd_tile.cuh): an output tile of TD x TH x TW = 4 x 8 x 16 voxels,
// its haloed input tile of one 16-channel chunk landed W-minor by cp.async
// (2-byte loads for W % 8 != 0 or an unaligned input) and written
// channel-minor by one transform pass, through the prologue when it is on,
// as 32-byte voxel rows whose 16-byte halves swap on bit 2 of the row. For
// tap (kd, kh, kw) and one output row of 16 voxels, the A fragment (16
// channels x 16 voxels) is 16 consecutive staged rows from the tap's
// shifted row, read by ldmatrix.x4.trans: conflict-free at every shift.
// The cotangent tile is [Cout16][512 voxels], W-minor as in global memory
// (the .col layout of the B operand), filled by 16-byte cp.async pieces
// (zero past Cout and outside the volume; the same 2-byte path), with a
// pitch of 1040 bytes so that ldmatrix's eight rows fall on eight different
// groups of banks. One B fragment serves the three kw taps of a warp.
//
//   1. conv3_dw_partial_kernel: grid (nblk, Cin chunks of 16), 18 warps.
//      Block k walks the output tiles k, k + nblk, k + 2 nblk, ... of the
//      volume (the tile loop is the GEMM's K loop) through a two-stage
//      ring: while the MMAs of tile i read the staged input and cotangent
//      stage i % 2, the cotangent of tile i + 1 lands in the other stage
//      and its input in the raw tile; after the MMAs one transform pass
//      writes it channel-minor. Warp w owns the (kd, kh) pair w % 9 and its
//      three kw taps; the two warps of a pair split the tile's 32 output
//      rows (even, odd) at Cout <= 32, or the n8 tiles at Cout >= 48, so
//      that each warp holds 3 x 2..4 fragments (24..48 fp32 registers)
//      and the 27 taps split evenly. At the end the second warp of a row
//      split hands its sums to the first through shared memory, which adds
//      them in a fixed order, and each block writes its (27, 16, Cout16)
//      partial sums once.
//   2. conv3_dw_reduce_kernel: one thread per dW element sums the nblk
//      partials in block order. With the split fixed by the SM count and
//      the chunk count, the result is the same bits on every run; no
//      atomics.
//
// What bounds it on an H100: at 16 -> 16 on a 192^3 volume it does 98
// GFLOP on the tensor cores and reads 453 MB once, a bound of about 0.14
// ms. As in the forward, each m16 x k16 A fragment (512 bytes through
// ldmatrix) serves Cout16 / 8 MMAs (at Cout >= 48, half of them per warp),
// so at Cout = 16 the MMA loop reads about 340 bytes of shared memory per
// MMA, near 2.7 cycles per MMA per SM. The staging adds its own traffic
// through the same load/store pipe: 3840 cp.async pieces of the raw tile
// per tile (half of them 4-byte halo pairs, each its own sector), the
// cotangent's, and the transform's loads and stores. dw_dissect.py times
// the body with parts removed: the staging alone takes about two thirds of
// the whole and the MMA loop alone about half; a version with a second
// tile's loads in flight was no faster, which points at the pipe's traffic
// rather than the loads' latency. One block of 18 warps holds an SM: five warps share a quarter
// of the register file, 96 registers a thread (two blocks would cap a
// thread at 56, which spills at Cout = 16). The prologue adds two fp32
// operations and a cast per staged element and no bytes: the activated
// input of the boundary conv is never written to device memory.
#include "conv3_fwd_tile.cuh"

using namespace conv3f;

namespace {

constexpr int PAIRS_KDKH = 9;                   // (kd, kh) pairs; a warp owns one
constexpr int DW_WARPS = 2 * PAIRS_KDKH;        // two warps per pair
constexpr int DW_THREADS = 32 * DW_WARPS;
constexpr int ROWS = TD * TH;                   // output rows (16-voxel K steps) per tile
constexpr int G_PITCH = 2 * TM + 16;            // bytes per staged cotangent channel
constexpr int RTHREADS = 256;                   // threads of the reduce
static_assert(DW_THREADS >= THREADS, "load_raw and transform take THREADS threads");
static_assert(G_PITCH % 128 == 16, "ldmatrix rows of the cotangent fall 4 banks apart");

template <int COUT>
struct DwCfg {
  static constexpr int NT = COUT / 8;              // n8 tiles
  static constexpr bool KSPLIT = NT <= 4;          // the pair splits the rows, else the n8 tiles
  static constexpr int NW = KSPLIT ? NT : NT / 2;  // n8 tiles per warp
  static constexpr int g_bytes = COUT * G_PITCH;   // one cotangent stage
  static constexpr int x_at = 2 * g_bytes;         // the channel-minor input tile
  static constexpr int raw_at = x_at + X_VOX * ROW_BYTES;
  static constexpr int ring_bytes = raw_at + RAW_BYTES;
  // after the last tile: the second warps' sums of a row split
  static constexpr int red_bytes = KSPLIT ? DW_WARPS / 2 * 3 * NW * 4 * 32 * 4 : 0;
  static constexpr int bytes = ring_bytes > red_bytes ? ring_bytes : red_bytes;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// The A fragments of a warp's three kw taps and its NW B fragments for
// output row r of the tile: A from the staged input (gs, xs shared
// addresses; a_vox, a_half this lane's ldmatrix row), B from the cotangent
// stage at this lane's row offset.
template <int NW>
struct Frags {
  uint32_t a[3][4];
  uint32_t b[NW][2];

  __device__ __forceinline__ void load(uint32_t gs, uint32_t xs, int r, int a_vox, int a_half) {
#pragma unroll
    for (int j = 0; j + 1 < NW; j += 2) {
      uint32_t q[4];
      ldsm_x4(q, gs + uint32_t(j * 8) * G_PITCH + r * TW * 2);
      b[j][0] = q[0], b[j][1] = q[1], b[j + 1][0] = q[2], b[j + 1][1] = q[3];
    }
    if (NW % 2 == 1) {
      uint32_t q[2];
      ldsm_x2(q, gs + uint32_t((NW - 1) * 8) * G_PITCH + r * TW * 2);
      b[NW - 1][0] = q[0], b[NW - 1][1] = q[1];
    }
    const int vox = ((r / TH) * HR + r % TH) * WR + a_vox;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) ldsm_x4_trans(a[kw], xs + swz(vox + kw, a_half));
  }

  __device__ __forceinline__ void mma(float (&acc)[3][NW][4]) const {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int j = 0; j < NW; ++j) mma16816(acc[kw][j], a[kw], b[j][0], b[j][1]);
  }
};

struct Tiles {
  int w, h, d, n;  // tiles along W, H, D; all tiles of the batch
};

// The corner and batch element of output tile `tile` (W fastest).
__device__ __forceinline__ void tile_at(TileAt& t, int tile, const Tiles& nt) {
  const int tw = tile % nt.w;
  int r = tile / nt.w;
  const int th = r % nt.h;
  r /= nt.h;
  t.d0 = (r % nt.d) * TD;
  t.b = r / nt.d;
  t.h0 = th * TH;
  t.w0 = tw * TW;
}

// Start the copies of the cotangent tile [COUT][TM voxels] of output tile t into
// gs (a shared address, gs_g the same memory for plain stores): per
// channel and output row two 16-byte pieces, zero past Cout and outside
// the volume. vec: W is a multiple of 8 and g is 16-byte aligned, so each
// piece lies wholly inside or wholly outside the volume; otherwise 2-byte
// loads and stores.
template <int COUT>
__device__ __forceinline__ void load_g(uint32_t gs, unsigned char* gs_g,
                                       const bf16* __restrict__ g, const TileAt& t, int Cout,
                                       bool vec) {
  const unsigned short* gu = reinterpret_cast<const unsigned short*>(g);
  for (int u = threadIdx.x; u < COUT * ROWS * 2; u += DW_THREADS) {
    const int piece = u & 1, orow = (u >> 1) % ROWS, co = (u >> 1) / ROWS;
    const int gd = t.d0 + orow / TH, gh = t.h0 + orow % TH, w_first = t.w0 + 8 * piece;
    const bool ok = co < Cout && gd < t.D && gh < t.H;
    const unsigned short* src =
        ok ? gu + ((size_t(t.b) * Cout + co) * t.D + gd) * size_t(t.H) * t.W + size_t(gh) * t.W
           : gu;
    const uint32_t dst = uint32_t(co) * G_PITCH + uint32_t(orow * TW + 8 * piece) * 2;
    if (vec) {
      const bool in = ok && w_first < t.W;
      cp_async16(gs + dst, in ? src + w_first : gu, in);
    } else {
      unsigned short* d = reinterpret_cast<unsigned short*>(gs_g + dst);
      for (int e = 0; e < 8; ++e) {
        const int gw = w_first + e;
        d[e] = ok && gw < t.W ? src[gw] : (unsigned short)0;
      }
    }
  }
  cp_async_commit();
}

template <int COUT, bool PRO>
__global__ void __launch_bounds__(DW_THREADS, 1)
conv3_dw_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                        const float* __restrict__ pa, const float* __restrict__ pt,
                        float* __restrict__ partial, int Cin, int Cout, int D, int H, int W,
                        Tiles nt) {
  extern __shared__ __align__(128) unsigned char smem[];
  using C = DwCfg<COUT>;
  constexpr int NW = C::NW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pair = warp % PAIRS_KDKH;  // (kd, kh) = (pair / 3, pair % 3)
  const int half = warp / PAIRS_KDKH;  // rows of this parity, or this half of the n8 tiles
  const int chunk = blockIdx.y;
  const uint32_t smem_s = uint32_t(__cvta_generic_to_shared(smem));
  const uint32_t xs = smem_s + C::x_at;
  unsigned char* const raw_g = smem + C::raw_at;
  TileAt at{0, chunk * CK, Cin, D, H, W, 0, 0, 0};
  const bool vec = W % 8 == 0 && aligned16(x) && aligned16(g);
  const bool stager = tid < THREADS;  // load_raw and transform take THREADS threads

  // ldmatrix row of this lane. A (.trans): matrix q = lane / 8 holds voxels
  // 8 (q >> 1) .. + 7 of channel half q & 1, at the pair's (kd, kh) shift.
  // B: matrix q holds couts 8 (q >> 1) .. + 7 at voxels 8 (q & 1) .. + 7.
  const int a_half = (lane >> 3) & 1;
  const int a_vox = (lane & 7) + ((lane >> 4) << 3) + ((pair / 3) * HR + pair % 3) * WR;
  const int n0 = C::KSPLIT ? 0 : half * NW * 8;  // first cout of this warp
  const uint32_t b_off =
      uint32_t(n0 + (lane & 7) + ((lane >> 4) << 3)) * G_PITCH + ((lane >> 3) & 1) * 16;

  float acc[3][NW][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kw][j][e] = 0.0f;

  if (int(blockIdx.x) < nt.n) {  // block-uniform; a block without tiles writes zeros
    tile_at(at, blockIdx.x, nt);
    if (stager) load_raw(smem_s + C::raw_at, raw_g, x, at, vec);
    load_g<COUT>(smem_s, smem, g, at, Cout, vec);
    cp_async_wait_all();
    __syncthreads();
    if (stager) transform<PRO>(smem + C::x_at, raw_g, pa, pt, at);
    __syncthreads();

    int s = 0;
    for (int tile = blockIdx.x; tile < nt.n; tile += gridDim.x, s ^= 1) {
      const bool more = tile + int(gridDim.x) < nt.n;
      if (more) {  // tile + nblk: its input to the raw tile, its cotangent to stage s ^ 1
        tile_at(at, tile + gridDim.x, nt);
        if (stager) load_raw(smem_s + C::raw_at, raw_g, x, at, vec);
        load_g<COUT>(smem_s + (s ^ 1) * C::g_bytes, smem + (s ^ 1) * C::g_bytes, g, at, Cout,
                     vec);
      }
      // per output row (K step): all fragments, then the MMAs
      const uint32_t gs = smem_s + s * C::g_bytes + b_off;
      Frags<NW> f;
#pragma unroll 2
      for (int r = C::KSPLIT ? half : 0; r < ROWS; r += C::KSPLIT ? 2 : 1) {
        f.load(gs, xs, r, a_vox, a_half);
        f.mma(acc);
      }
      if (more) {
        cp_async_wait_all();
        __syncthreads();  // tile + nblk has landed; every warp is done with the input tile
        if (stager) transform<PRO>(smem + C::x_at, raw_g, pa, pt, at);
      }
      __syncthreads();  // the input tile is ready; stage s is free
    }
  }

  const int ci = lane >> 2, co_l = 2 * (lane & 3);  // this lane's accumulator entries
  if (C::KSPLIT) {  // the odd rows' sums to the even rows' warp, added in a fixed order
    float* red = reinterpret_cast<float*>(smem) + pair * (3 * NW * 4 * 32) + lane;
    __syncthreads();  // every warp is done with the ring
    if (half == 1) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((kw * NW + j) * 4 + e) * 32] = acc[kw][j][e];
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[kw][j][e] += red[((kw * NW + j) * 4 + e) * 32];
  }
  float* out = partial + (size_t(blockIdx.x) * gridDim.y + chunk) * 27 * CK * COUT;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int tap = pair * 3 + kw;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      float* o = out + (size_t(tap) * CK + ci) * COUT + n0 + j * 8 + co_l;
      *reinterpret_cast<float2*>(o) = make_float2(acc[kw][j][0], acc[kw][j][1]);
      *reinterpret_cast<float2*>(o + 8 * COUT) = make_float2(acc[kw][j][2], acc[kw][j][3]);
    }
  }
}

__global__ void __launch_bounds__(RTHREADS)
conv3_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int nblk,
                       int nchunk, int Cin, int Cout, int cout16) {
  const int i = blockIdx.x * RTHREADS + threadIdx.x;
  if (i >= 27 * Cin * Cout) return;
  const int co = i % Cout;
  const int r = i / Cout;
  const int ci = r % Cin;
  const int tap = r / Cin;
  const size_t stride = size_t(nchunk) * 27 * CK * cout16;  // one block's partials
  const float* p = partial + ((size_t(ci / CK) * 27 + tap) * CK + ci % CK) * cout16 + co;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += p[k * stride];
  dw[i] = s;
}

template <int COUT, bool PRO>
cudaError_t launch(const void* x, const void* g, const void* a, const void* t, void* partial,
                   void* dw, int B, int Cin, int Cout, int D, int H, int W, int nblk,
                   cudaStream_t stream) {
  const int smem = DwCfg<COUT>::bytes;
  cudaError_t err = cudaFuncSetAttribute(conv3_dw_partial_kernel<COUT, PRO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Tiles nt{(W + TW - 1) / TW, (H + TH - 1) / TH, (D + TD - 1) / TD, 0};
  nt.n = B * nt.d * nt.h * nt.w;
  const int nchunk = (Cin + CK - 1) / CK;
  conv3_dw_partial_kernel<COUT, PRO><<<dim3(nblk, nchunk), DW_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const float*>(a),
      static_cast<const float*>(t), static_cast<float*>(partial), Cin, Cout, D, H, W, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = 27 * Cin * Cout;
  conv3_dw_reduce_kernel<<<(n_out + RTHREADS - 1) / RTHREADS, RTHREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), nblk, nchunk, Cin, Cout,
      COUT);
  return cudaGetLastError();
}

template <bool PRO>
int dispatch(const void* x, const void* g, const void* a, const void* t, void* partial,
             void* dw, int B, int Cin, int Cout, int D, int H, int W, int nblk, void* stream) {
  if (nblk < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((Cout + 15) / 16) {
    case 1: return launch<16, PRO>(x, g, a, t, partial, dw, B, Cin, Cout, D, H, W, nblk, s);
    case 2: return launch<32, PRO>(x, g, a, t, partial, dw, B, Cin, Cout, D, H, W, nblk, s);
    case 3: return launch<48, PRO>(x, g, a, t, partial, dw, B, Cin, Cout, D, H, W, nblk, s);
    case 4: return launch<64, PRO>(x, g, a, t, partial, dw, B, Cin, Cout, D, H, W, nblk, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dynamic shared memory of a conv3_dw_partial_kernel block for Cout16 =
// cout16 (16, 32, 48 or 64); 0 for another Cout16.
MMSEG_API int mmseg_conv3_dw_smem_bytes(int cout16) {
  switch (cout16) {
    case 16: return DwCfg<16>::bytes;
    case 32: return DwCfg<32>::bytes;
    case 48: return DwCfg<48>::bytes;
    case 64: return DwCfg<64>::bytes;
    default: return 0;
  }
}

MMSEG_API int mmseg_conv3_dw(const void* x, const void* g, void* partial, void* dw, int B,
                             int Cin, int Cout, int D, int H, int W, int nblk, void* stream) {
  return dispatch<false>(x, g, nullptr, nullptr, partial, dw, B, Cin, Cout, D, H, W, nblk,
                         stream);
}

// Kernel 6: dW of the conv of bf16(relu(x * a + t)), a, t (B, Cin) fp32.
MMSEG_API int mmseg_conv3_dw_prologue(const void* x, const void* g, const void* a,
                                      const void* t, void* partial, void* dw, int B, int Cin,
                                      int Cout, int D, int H, int W, int nblk, void* stream) {
  if (a == nullptr || t == nullptr) return int(cudaErrorInvalidValue);
  return dispatch<true>(x, g, a, t, partial, dw, B, Cin, Cout, D, H, W, nblk, stream);
}
