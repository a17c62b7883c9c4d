// SAME 3x3x3 convolution on channel-first fp32 volumes, in full fp32 on the
// CUDA cores: an implicit-GEMM body with a compile-time epilogue (and a
// compile-time input prologue, which no instance takes yet).
//
// Replaces: multimodal_segmentation_project_tpu/ops/pallas_conv.py
//   * _fwd_bias_act_kernel (public op conv3x3x3_cf_relu) on an fp32 x, as
//     the JAX package runs it under its fp32 policy: the eval forward's
//     conv, BatchNorm folded into w and b by the caller, epilogue
//     kBiasRelu, out = relu(acc + bias) in fp32 (mmseg_conv3_f32_bias_relu).
// The training kernels' fp32 instances (1, 1-dx, 3, 4, 5, 12) are further
// epilogues and the prologue of this body; they are not written yet, and
// the kernel refuses any other instance at compile time.
//
// Why a body of its own, and no MMA: conv3.cu runs mma.sync on bf16
// operands. A TF32 MMA keeps 10 mantissa bits, about 5e-4 relative error
// per product, where an fp32 conv is held to 2e-5 of max |out|. So this
// body multiplies and adds in fp32 FFMA.
//
// Layout: x (B, Cin, D, H, W) fp32, bias (Cout,) fp32, out (B, Cout, D, H,
// W) fp32, all contiguous. The weights arrive packed by the wrapper
// (ops/conv3.py:pack_weights_f32) as (ceil(Cin/CK), CK, 27, Cout16) fp32,
// zero-padded in Cin and Cout (Cout16 = Cout rounded up to 16): one
// chunk's slab is its shared-memory image.
//
// Design: an implicit GEMM with M = output voxels, N = Cout16 (at most 64)
// and K = 27 * Cin. A block of 256 threads computes conv3.cu's TD x TH x
// TW = 4 x 8 x 16 output tile (a TW that divides 48, 96 and 192) for every
// output channel. Thread (channel group g, unit u) holds RM = 8 consecutive
// output voxels along W (half an output row) times RN = Cout16 / 4
// channels: 8 RN fp32 accumulators. The 64 units of a group are the tile's
// 32 rows times 2 halves; warps 2g and 2g + 1 form group g, so the lanes
// of a warp share their channels and read each weight as one broadcast.
// The K loop runs over chunks of CK = 8 input channels through a two-stage
// cp.async ring in shared memory (one stage where there is one chunk):
// while the FMAs of chunk c read one stage, chunk c + 1 lands in the other.
// A stage holds the chunk's haloed input tile, W-minor as in device memory
// (so cp.async copies it as it is: 16 bytes a piece where W % 4 == 0 and x
// is aligned, else 4), row (channel, plane, row) at a pitch of PITCH = 20
// floats: voxels [w0, w0 + 16) at 0..15, w0 - 1 at 16, w0 + 16 at 17,
// zero-filled outside the volume (the SAME halo) and past Cin; then the
// chunk's weight slab, [CK][27][Cout16]. A stage is 38.4 KB of input and
// 13.8-55.3 KB of weights: at Cout = 16 two blocks share an SM.
//
// Per (input channel, kd, kh) a thread reads its 10-voxel window of one
// staged row once (two 16-byte reads and two 4-byte reads) and uses it for
// all three kw taps (a sliding window: output voxel m takes window voxel
// m + kw), and reads 3 * RN weights as 16-byte broadcasts; then 24 RN FMAs.
// The 16-byte reads of a quarter warp fall on 8 consecutive staged rows of
// one plane, whose pitch (5 x 16 bytes) puts them on 8 different groups of
// banks. The sum runs over the chunks in order, in each over the channels
// in order, then kd, kh, kw. A chunk's channel loop stops at Cin, so Cin =
// 1 (the first encoder conv) costs 1/8 of a full chunk.
//
// Epilogue: from the registers, bias added after the whole sum, ReLU that
// keeps a NaN (as jnp.maximum does), two 16-byte stores per channel (4-byte
// stores at a ragged edge or an unaligned output).
//
// What bounds it on an H100: the fp32 operations. The eval forward's eleven
// convs do about 679 GFLOP (10.1 ms at 67 TFLOP/s of FFMA) and move about
// 5.7 GB (1.7 ms at 3.35 TB/s). A 3xTF32 MMA path or wgmma is later work.
#include "common.cuh"

namespace {

enum Epilogue { kBiasRelu = 0 };  // conv3.cu's numbering; 1-3 are the training epilogues

constexpr int TD = 4;               // output depth planes per block
constexpr int TH = 8;               // output rows per plane
constexpr int TW = 16;              // output columns per row
constexpr int DR = TD + 2;          // haloed tile planes
constexpr int HR = TH + 2;          // haloed tile rows
constexpr int ROWS = DR * HR;       // staged rows per input channel
constexpr int CK = 8;               // input channels per chunk
constexpr int PITCH = 20;           // floats per staged row
constexpr int LEFT = 16;            // the staged row's voxel w0 - 1
constexpr int RIGHT = 17;           // and w0 + 16
constexpr int THREADS = 256;
constexpr int GROUPS = 4;           // output channel groups of a block
constexpr int RM = 8;               // output voxels per thread along W
static_assert(TD * TH * (TW / RM) * GROUPS == THREADS, "one unit of each group per thread");
static_assert(PITCH % 4 == 0 && (PITCH / 4) % 2 == 1, "16-byte rows on distinct bank groups");

template <int COUT>
struct Smem {
  static constexpr int x_floats = CK * ROWS * PITCH;  // one haloed input tile
  static constexpr int w_floats = CK * 27 * COUT;     // one weight slab
  static constexpr int stage_floats = x_floats + w_floats;
  __host__ __device__ static constexpr size_t bytes(int nchunks) {
    return size_t(nchunks > 1 ? 2 : 1) * stage_floats * sizeof(float);
  }
};

struct ConvArgs {
  const float* x;     // (B, Cin, D, H, W)
  const float* w;     // packed weights
  const float* bias;  // (Cout,)
  float* out;         // (B, Cout, D, H, W)
  int B, Cin, Cout, D, H, W, tiles_w;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue chunk `chunk` (input channels [CK chunk, CK chunk + CK)) of the
// block's tile into the stage at shared address `st`. vec: W % 4 == 0 and
// x is 16-byte aligned, so each 16-byte piece lies wholly inside or
// outside the volume.
template <int COUT>
__device__ __forceinline__ void issue_chunk(uint32_t st, const ConvArgs& p, int chunk, int b,
                                            int d0, int h0, int w0, bool vec) {
  const int c0 = chunk * CK;
  // per staged row: pieces 0..3 the voxels w0 + 4 k .. w0 + 4 k + 3, 4 the
  // voxel w0 - 1, 5 the voxel w0 + 16
  for (int i = threadIdx.x; i < CK * ROWS * 6; i += THREADS) {
    const int piece = i % 6, cr = i / 6;  // cr = channel * ROWS + row
    const int c = c0 + cr / ROWS, row = cr % ROWS;
    const int gd = d0 - 1 + row / HR, gh = h0 - 1 + row % HR;
    const bool ok = c < p.Cin && gd >= 0 && gd < p.D && gh >= 0 && gh < p.H;
    const float* src =
        ok ? p.x + ((size_t(b) * p.Cin + c) * p.D + gd) * size_t(p.H) * p.W + size_t(gh) * p.W
           : p.x;
    const uint32_t dst = st + uint32_t(cr * PITCH) * 4u;
    if (piece < 4) {
      const int w = w0 + 4 * piece;
      if (vec) {
        const bool in = ok && w < p.W;
        cp_async16(dst + 16u * piece, in ? src + w : p.x, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = ok && w + e < p.W;
          cp_async4(dst + 4u * (4 * piece + e), in ? src + w + e : p.x, in);
        }
      }
    } else {
      const int w = piece == 4 ? w0 - 1 : w0 + TW;
      const bool in = ok && w >= 0 && w < p.W;
      cp_async4(dst + 4u * (piece == 4 ? LEFT : RIGHT), in ? src + w : p.x, in);
    }
  }
  const float* ws = p.w + size_t(chunk) * Smem<COUT>::w_floats;
  const uint32_t wdst = st + uint32_t(Smem<COUT>::x_floats) * 4u;
  for (int i = threadIdx.x; i < Smem<COUT>::w_floats / 4; i += THREADS)
    cp_async16(wdst + 16u * i, ws + 4 * i, true);
  cp_async_commit();
}

template <int COUT, int EPI, bool PRO>
__global__ void __launch_bounds__(THREADS, COUT == 16 ? 2 : 1) conv3_f32_kernel(const ConvArgs p) {
  static_assert(EPI == kBiasRelu && !PRO,
                "only the eval conv's bias+ReLU epilogue is written for the fp32 body");
  using S = Smem<COUT>;
  constexpr int RN = COUT / GROUPS;  // output channels per thread
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = warp >> 1;                                // channel group
  const int od = (warp & 1) * 2 + ((lane >> 3) & 1);     // output plane in the tile
  const int oh = lane & 7;                                // output row in the plane
  const int half = lane >> 4;                             // voxels [8 half, 8 half + 8) of the row
  const int th_i = blockIdx.x / p.tiles_w;
  const int h0 = th_i * TH;
  const int w0 = (blockIdx.x - th_i * p.tiles_w) * TW;
  const int d0 = blockIdx.y * TD;
  const int b = blockIdx.z;
  const int nchunks = (p.Cin + CK - 1) / CK;
  const uint32_t smem_s = uint32_t(__cvta_generic_to_shared(smem));
  const bool vec = p.W % 4 == 0 && aligned16(p.x);

  // the window: staged-row offsets of voxel w0 - 1 + 8 half (a0), of the 8
  // voxels after it (two 16-byte reads at v4) and of the last (a9)
  const int a0 = half ? 7 : LEFT;
  const int v4 = 8 * half;
  const int a9 = half ? RIGHT : 8;

  float acc[RM][RN];
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int n = 0; n < RN; ++n) acc[m][n] = 0.0f;

  issue_chunk<COUT>(smem_s, p, 0, b, d0, h0, w0, vec);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      issue_chunk<COUT>(smem_s + uint32_t(((c + 1) & 1) * S::stage_floats) * 4u, p, c + 1, b, d0,
                        h0, w0, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c has landed
    const float* xs = smem + (c & 1) * S::stage_floats;
    const float* wsl = xs + S::x_floats + g * RN;
    const int nci = min(CK, p.Cin - c * CK);
#pragma unroll 1
    for (int ci = 0; ci < nci; ++ci) {
#pragma unroll 1
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float* row = xs + (ci * ROWS + (od + kd) * HR + oh + kh) * PITCH;
          float v[RM + 2];
          v[0] = row[a0];
          const float4 lo = *reinterpret_cast<const float4*>(row + v4);
          const float4 hi = *reinterpret_cast<const float4*>(row + v4 + 4);
          v[1] = lo.x, v[2] = lo.y, v[3] = lo.z, v[4] = lo.w;
          v[5] = hi.x, v[6] = hi.y, v[7] = hi.z, v[8] = hi.w;
          v[9] = row[a9];
          const float* wt = wsl + (ci * 27 + (kd * 3 + kh) * 3) * COUT;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            float wv[RN];
#pragma unroll
            for (int j = 0; j < RN / 4; ++j) {
              const float4 q = *reinterpret_cast<const float4*>(wt + kw * COUT + 4 * j);
              wv[4 * j] = q.x, wv[4 * j + 1] = q.y, wv[4 * j + 2] = q.z, wv[4 * j + 3] = q.w;
            }
#pragma unroll
            for (int m = 0; m < RM; ++m)
#pragma unroll
              for (int n = 0; n < RN; ++n) acc[m][n] = fmaf(v[m + kw], wv[n], acc[m][n]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  // epilogue, from the registers: voxels [gw, gw + 8) of one output row
  const int gd = d0 + od, gh = h0 + oh, gw = w0 + 8 * half;
  if (gd >= p.D || gh >= p.H || gw >= p.W) return;
  const int n_in = min(p.W - gw, RM);
  const size_t vol = size_t(p.D) * p.H * p.W;
  const size_t voxel = (size_t(gd) * p.H + gh) * p.W + gw;
  const bool vec_out = n_in == RM && p.W % 4 == 0 && aligned16(p.out);
#pragma unroll
  for (int n = 0; n < RN; ++n) {
    const int co = g * RN + n;
    if (co >= p.Cout) break;
    const float bias = p.bias[co];
    float u[RM];
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      const float t = acc[m][n] + bias;
      u[m] = t < 0.0f ? 0.0f : t;  // ReLU that keeps a NaN
    }
    float* o = p.out + (size_t(b) * p.Cout + co) * vol + voxel;
    if (vec_out) {
      reinterpret_cast<float4*>(o)[0] = make_float4(u[0], u[1], u[2], u[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(u[4], u[5], u[6], u[7]);
    } else {
#pragma unroll
      for (int m = 0; m < RM; ++m)
        if (m < n_in) o[m] = u[m];
    }
  }
}

// The launch, once the wrapper's descriptor (grid, threads, dynamic shared
// memory) is checked against the kernel's own: a wrapper that computed
// another gets cudaErrorInvalidConfiguration and nothing runs.
template <int COUT, int EPI, bool PRO>
cudaError_t launch(const ConvArgs& args, dim3 grid, int threads, int smem, cudaStream_t stream) {
  const int nchunks = (args.Cin + CK - 1) / CK;
  const dim3 want(args.tiles_w * ((args.H + TH - 1) / TH), (args.D + TD - 1) / TD, args.B);
  if (threads != THREADS || smem != int(Smem<COUT>::bytes(nchunks)) || grid.x != want.x ||
      grid.y != want.y || grid.z != want.z)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(conv3_f32_kernel<COUT, EPI, PRO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv3_f32_kernel<COUT, EPI, PRO><<<grid, THREADS, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int EPI, bool PRO>
int dispatch(ConvArgs args, dim3 grid, int threads, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  args.tiles_w = (args.W + TW - 1) / TW;
  switch ((args.Cout + 15) / 16) {
    case 1: return launch<16, EPI, PRO>(args, grid, threads, smem, s);
    case 2: return launch<32, EPI, PRO>(args, grid, threads, smem, s);
    case 3: return launch<48, EPI, PRO>(args, grid, threads, smem, s);
    case 4: return launch<64, EPI, PRO>(args, grid, threads, smem, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dynamic shared memory of a conv3_f32_kernel block for Cout16 = cout16
// (16, 32, 48 or 64) and nchunks chunks of CK input channels; 0 for
// another Cout16.
MMSEG_API int mmseg_conv3_f32_smem_bytes(int cout16, int nchunks) {
  switch (cout16) {
    case 16: return int(Smem<16>::bytes(nchunks));
    case 32: return int(Smem<32>::bytes(nchunks));
    case 48: return int(Smem<48>::bytes(nchunks));
    case 64: return int(Smem<64>::bytes(nchunks));
    default: return 0;
  }
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
  ConvArgs a{};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.B = B, a.Cin = Cin, a.Cout = Cout, a.D = D, a.H = H, a.W = W;
  return dispatch<kBiasRelu, false>(a, dim3(grid_x, grid_y, grid_z), threads, smem, stream);
}
