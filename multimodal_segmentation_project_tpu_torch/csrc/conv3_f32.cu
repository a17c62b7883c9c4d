// SAME 3x3x3 convolution on channel-first fp32 volumes, in full fp32 on the
// CUDA cores: an implicit-GEMM body with a compile-time epilogue and a
// compile-time input prologue.
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
//     the fused block): kBiasStats with the prologue on, the input staged
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
// Why a body of its own, and no MMA: conv3.cu runs mma.sync on bf16
// operands. A TF32 MMA keeps 10 mantissa bits, about 5e-4 relative error
// per product, where an fp32 conv is held to 2e-5 of max |out|. So this
// body multiplies and adds in fp32 FFMA.
//
// Layout: x (B, Cin, D, H, W) fp32, bias (Cout,) fp32 or null (kCastBias),
// out (B, Cout, D, H, W) fp32, a, t (B, Cin) fp32 for the prologue, xr
// (B, Cout, D, H, W) fp32 and a, t (B, Cout) fp32 for kDxMask, all
// contiguous. The weights arrive packed by the wrapper
// (ops/conv3.py:pack_weights_f32) as (ceil(Cin/CK), CK, 27, Cout16) fp32,
// zero-padded in Cin and Cout (Cout16 = Cout rounded up to 16): one
// chunk's slab is its shared-memory image.
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
// A stage holds the chunk's haloed input tile as conv3_f32_tile.cuh stages
// it (W-minor rows of PITCH = 20 floats, zero outside the volume and past
// Cin), then the chunk's weight slab, [CK][27][Cout16]. A stage is 38.4 KB
// of input and 13.8-55.3 KB of weights: at Cout = 16 two blocks share an
// SM. The prologue (PRO): once a chunk has landed, one pass rewrites its
// staged input in place as relu(x * a + t) (conv3_f32_tile.cuh), and a
// barrier then hands the stage to the FMAs.
//
// Per (input channel, kd, kh) a thread reads its 10-voxel window of one
// staged row once (two 16-byte reads and two 4-byte reads) and uses it for
// all three kw taps (a sliding window: output voxel m takes window voxel
// m + kw), and reads 3 * RN weights as 16-byte broadcasts; then 24 RN FMAs.
// The 16-byte reads of a quarter warp fall on 8 consecutive staged rows of
// one plane, on 8 different groups of banks. The sum runs over the chunks in order, in each over the channels
// in order, then kd, kh, kw. A chunk's channel loop stops at Cin, so Cin =
// 1 (the first encoder conv) costs 1/8 of a full chunk.
//
// Epilogue: from the registers, one channel at a time, bias added after
// the whole sum (kBiasRelu: then ReLU that keeps a NaN, as jnp.maximum
// does), two 16-byte stores per channel (4-byte stores at a ragged edge or
// an unaligned output). kBiasStats and kDxMask also sum per channel, as
// conv3.cu does and in a fixed order: each thread its 8 voxels in order
// (a square, or the product du * xr, rounded before it is added: no
// contraction), a shuffle tree over the warp, then the group's two warps
// in order through shared memory (the ring is free after the K loop); one
// partial per (sum, channel, batch, block), which
// conv3_f32_stats_reduce_kernel sums in block order (one block per run, a
// strided sum per thread and a fixed tree). No atomics: the same bits on
// every run.
//
// What bounds it on an H100: the fp32 operations. The eval forward's eleven
// convs do about 679 GFLOP (10.1 ms at 67 TFLOP/s of FFMA) and move about
// 5.7 GB (1.7 ms at 3.35 TB/s); an fp32 train step runs the same eleven
// forward and ten of them again as dx (673 GFLOP). The prologue and the
// epilogues add a few fp32 operations per staged or written element and no
// bytes of their own: their point is that the activated input, and the dx
// conv's dr, never exist in device memory. A 3xTF32 MMA path or wgmma is
// later work.
#include "conv3_f32_tile.cuh"

using namespace conv3f32;

namespace {

enum Epilogue { kBiasRelu = 0, kCastBias = 1, kBiasStats = 2, kDxMask = 3 };  // conv3.cu's

constexpr int CK = 8;               // input channels per chunk
constexpr int GROUPS = 4;           // output channel groups of a block
constexpr int RM = 8;               // output voxels per thread along W
constexpr int RTHREADS = 256;       // threads of the cross-block reduce
static_assert(TD * TH * (TW / RM) * GROUPS == THREADS, "one unit of each group per thread");

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
  const float* bias;  // (Cout,); null for a kCastBias conv without one (the dx)
  float* out;         // (B, Cout, D, H, W)
  const float* pa;    // prologue: (B, Cin)
  const float* pt;
  const float* xr;    // kDxMask: the boundary conv's raw input, (B, Cout, D, H, W)
  const float* ea;    // kDxMask: its affine, (B, Cout)
  const float* et;
  float* partial;     // kBiasStats, kDxMask: one value per (run, block)
  int B, Cin, Cout, D, H, W, tiles_w;
};

// Issue chunk `chunk` (input channels [CK chunk, CK chunk + CK)) of the
// block's tile and its weight slab into the stage at shared address `st`.
template <int COUT>
__device__ __forceinline__ void issue_chunk(uint32_t st, const ConvArgs& p, int chunk, int b,
                                            int d0, int h0, int w0, bool vec) {
  issue_input<CK>(st, p.x, p.Cin, p.D, p.H, p.W, b, chunk * CK, d0, h0, w0, vec);
  const float* ws = p.w + size_t(chunk) * Smem<COUT>::w_floats;
  const uint32_t wdst = st + uint32_t(Smem<COUT>::x_floats) * 4u;
  for (int i = threadIdx.x; i < Smem<COUT>::w_floats / 4; i += THREADS)
    cp_async16(wdst + 16u * i, ws + 4 * i, true);
  cp_async_commit();
}

template <int COUT, int EPI, bool PRO>
__global__ void __launch_bounds__(THREADS, COUT == 16 ? 2 : 1) conv3_f32_kernel(const ConvArgs p) {
  using S = Smem<COUT>;
  constexpr bool SUMS = EPI == kBiasStats || EPI == kDxMask;
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
    float* xs = smem + (c & 1) * S::stage_floats;
    if (PRO) {
      prologue_input<CK>(xs, p.pa, p.pt, p.Cin, p.D, p.H, p.W, b, c * CK, d0, h0, w0);
      __syncthreads();  // the activated chunk is in place
    }
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

  // epilogue, from the registers, one channel at a time: voxels [gw, gw +
  // 8) of one output row; a thread outside the volume still takes its part
  // in the sums' shuffle trees
  const int gd = d0 + od, gh = h0 + oh, gw = w0 + 8 * half;
  const int n_in = gd < p.D && gh < p.H ? min(max(p.W - gw, 0), RM) : 0;
  if (!SUMS && n_in == 0) return;
  const size_t vol = size_t(p.D) * p.H * p.W;
  const size_t voxel = (size_t(gd) * p.H + gh) * p.W + gw;
  const bool vec_out = n_in == RM && p.W % 4 == 0 && aligned16(p.out) &&
                       (EPI != kDxMask || aligned16(p.xr));
  float* red = smem;  // the sums: [channel][warp of the group][sum], aliasing the free ring
#pragma unroll
  for (int n = 0; n < RN; ++n) {
    const int co = g * RN + n;
    if (co >= p.Cout) break;  // warp-uniform
    const size_t o = (size_t(b) * p.Cout + co) * vol + voxel;
    float u[RM];
    float r0 = 0.0f, r1 = 0.0f;  // this thread's terms of the two channel sums
    if (EPI == kBiasRelu) {
      const float bias = p.bias[co];
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        const float t = acc[m][n] + bias;
        u[m] = t < 0.0f ? 0.0f : t;  // ReLU that keeps a NaN
      }
    } else if (EPI == kBiasStats) {
      const float bias = p.bias[co];
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        u[m] = acc[m][n] + bias;
        if (m < n_in) {
          r0 += u[m];
          r1 += __fmul_rn(u[m], u[m]);  // the square rounded, then added
        }
      }
    } else if (EPI == kDxMask) {  // acc is dr
      const float ea = p.ea[b * p.Cout + co], et = p.et[b * p.Cout + co];
      float xv[RM];
      if (vec_out) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(p.xr + o));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(p.xr + o) + 1);
        xv[0] = lo.x, xv[1] = lo.y, xv[2] = lo.z, xv[3] = lo.w;
        xv[4] = hi.x, xv[5] = hi.y, xv[6] = hi.z, xv[7] = hi.w;
      } else {
#pragma unroll
        for (int m = 0; m < RM; ++m) xv[m] = m < n_in ? __ldg(p.xr + o + m) : 0.0f;
      }
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        const float du = __fadd_rn(__fmul_rn(xv[m], ea), et) > 0.0f ? acc[m][n] : 0.0f;
        u[m] = __fmul_rn(du, ea);
        if (m < n_in) {
          r0 += __fmul_rn(du, xv[m]);  // no FMA contraction into the sum
          r1 += du;
        }
      }
    } else if (p.bias != nullptr) {
      const float bias = p.bias[co];
#pragma unroll
      for (int m = 0; m < RM; ++m) u[m] = acc[m][n] + bias;
    } else {
#pragma unroll
      for (int m = 0; m < RM; ++m) u[m] = acc[m][n];
    }
    float* out = p.out + o;
    if (vec_out) {
      reinterpret_cast<float4*>(out)[0] = make_float4(u[0], u[1], u[2], u[3]);
      reinterpret_cast<float4*>(out)[1] = make_float4(u[4], u[5], u[6], u[7]);
    } else {
#pragma unroll
      for (int m = 0; m < RM; ++m)
        if (m < n_in) out[m] = u[m];
    }
    if (SUMS) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        r0 += __shfl_xor_sync(0xffffffffu, r0, s);
        r1 += __shfl_xor_sync(0xffffffffu, r1, s);
      }
      if (lane == 0) {
        red[(co * 2 + (warp & 1)) * 2] = r0;
        red[(co * 2 + (warp & 1)) * 2 + 1] = r1;
      }
    }
  }

  if (SUMS) {
    __syncthreads();
    const int nblk = gridDim.x * gridDim.y;
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    for (int j = tid; j < 2 * p.Cout; j += THREADS) {  // j = which sum * Cout + channel
      const int co = j % p.Cout, k = j / p.Cout;
      const float s = red[(co * 2) * 2 + k] + red[(co * 2 + 1) * 2 + k];
      // the partials of one output are contiguous: kBiasStats sums over the
      // batch too, (k, co) outputs of (b, block) partials; kDxMask has
      // (k, b, co) outputs of (block) partials
      const size_t run =
          EPI == kBiasStats ? size_t(j) * p.B + b : (size_t(k) * p.B + b) * p.Cout + co;
      p.partial[run * nblk + blk] = s;
    }
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

// The launch, once the wrapper's descriptor (grid, threads, dynamic shared
// memory) is checked against the kernel's own: a wrapper that computed
// another gets cudaErrorInvalidConfiguration and nothing runs. sums: (2,
// Cout) for kBiasStats, (2, B, Cout) for kDxMask, after the reduce; null
// otherwise.
template <int COUT, int EPI, bool PRO>
cudaError_t launch(const ConvArgs& args, float* sums, dim3 grid, int threads, int smem,
                   cudaStream_t stream) {
  const int nchunks = (args.Cin + CK - 1) / CK;
  const dim3 want(args.tiles_w * ((args.H + TH - 1) / TH), (args.D + TD - 1) / TD, args.B);
  if (threads != THREADS || smem != int(Smem<COUT>::bytes(nchunks)) || grid.x != want.x ||
      grid.y != want.y || grid.z != want.z)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(conv3_f32_kernel<COUT, EPI, PRO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv3_f32_kernel<COUT, EPI, PRO><<<grid, THREADS, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || !(EPI == kBiasStats || EPI == kDxMask)) return err;
  const int nblk = int(grid.x * grid.y);
  const int runs = EPI == kBiasStats ? 2 * args.Cout : args.B * 2 * args.Cout;
  const int len = EPI == kBiasStats ? args.B * nblk : nblk;
  conv3_f32_stats_reduce_kernel<<<runs, RTHREADS, 0, stream>>>(args.partial, sums, len);
  return cudaGetLastError();
}

template <int EPI, bool PRO>
int dispatch(ConvArgs args, float* sums, dim3 grid, int threads, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  args.tiles_w = (args.W + TW - 1) / TW;
  switch ((args.Cout + 15) / 16) {
    case 1: return launch<16, EPI, PRO>(args, sums, grid, threads, smem, s);
    case 2: return launch<32, EPI, PRO>(args, sums, grid, threads, smem, s);
    case 3: return launch<48, EPI, PRO>(args, sums, grid, threads, smem, s);
    case 4: return launch<64, EPI, PRO>(args, sums, grid, threads, smem, s);
    default: return int(cudaErrorInvalidValue);
  }
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
