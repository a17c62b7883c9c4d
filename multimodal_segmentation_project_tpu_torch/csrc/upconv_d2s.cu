// 2x2x2 stride-2 transpose convolution (ConvTranspose3d, kernel == stride)
// on channel-first bf16 volumes, written straight into depth-to-space order:
//
//   out[b, o, 2d+a, 2h+p, 2w+q] = bias[o] + sum_i x[b, i, d, h, w] * K[a, p, q, i, o]
//
// with bf16 products summed in fp32, the fp32 bias added last, and one
// rounding to bf16, as the TPU kernel rounds.
//
// Replaces: multimodal_segmentation_project_tpu/ops/upconv.py _d2s_kernel
//   (public op upconv2x_cf, forward).
//
// Layout: x (B, Cin, D, H, W) bf16, bias (Cout,) fp32, out (B, Cout, 2D,
// 2H, 2W) bf16, all contiguous. The weights arrive packed by the wrapper
// (ops/upconv.py:pack_kernel) as (8, Cout16, Cin16) bf16: row (phase, o)
// holds the Cin input channels of output channel o at phase (a, p, q),
// K-contiguous and zero-padded to multiples of 16 in both Cin and Cout.
//
// Design: with kernel == stride every output voxel receives one tap, so
// the op is a GEMM per tile of input voxels with M = the tile's voxels,
// N = 8 phases x 16 output channels and K = Cin, on the tensor cores
// through mma.sync.m16n8k16 (bf16 in, fp32 accumulators), its operands
// read from shared memory by ldmatrix. A tile is TM = 64 consecutive
// voxels of one batch element's flattened volume (x is W-minor, so a
// channel's 64 voxels are 128 contiguous bytes); grid y picks one group
// of 16 output channels, and the block keeps that group's weights (8 *
// 16 rows of Cin16) in shared memory for all its tiles: block k walks the
// tiles k, k + nblk, ... (the wrapper picks nblk). The A tile is staged
// [channel][64 voxels] at a 144-byte pitch by 16-byte cp.async pieces
// (zero past Cin and past the volume; 2-byte loads where V % 8 != 0 or x
// is not 16-byte aligned) in a two-stage ring: the next tile lands while
// this one's MMAs run. A fragments come from ldmatrix.trans (rows are K),
// B fragments from ldmatrix on the (phase, o) rows; both pitches put the
// eight rows of an 8x8 matrix on eight different groups of banks. Warp w
// owns the (a, p) pair w / 2, both of its q phases, and 32 of the 64
// voxels: 2 m16 x 4 n8 tiles, 32 fp32 accumulators a thread.
//
// Epilogue, the depth-to-space store: a thread holds (voxel m, channel o)
// at q = 0 and q = 1, which are neighbours in the output row (o, 2d+a,
// 2h+p). It adds the bias, rounds, packs the pair into one 32-bit word and
// writes it to a shared [a][p][o][64 voxels] stage (pitch 272 bytes: the
// warp's 32 words land on 32 banks). Each thread then copies one (o, four
// voxels) piece of each (a, p) row: 16 bytes, four voxels' q pairs, one
// aligned 16-byte store where W % 4 == 0 (four aligned voxels never cross
// an input row); otherwise one 4-byte store per voxel. A warp writes two
// runs of 256 contiguous bytes per (a, p).
//
// What bounds it on an H100: device-memory bandwidth. At the
// full-resolution level (32 -> 16, 96^3 -> 192^3) it reads 57 MB and writes
// 226 MB for 7.2 GFLOP, 0.084 ms at 3.35 TB/s; 80 % of the bytes are the
// output's stores, which are what the kernel's time should be made of.
#include "common.cuh"

namespace {

constexpr int TM = 64;                  // input voxels per tile (the GEMM's M)
constexpr int OG = 16;                  // output channels per block (grid y)
constexpr int NPH = 8;                  // depth-to-space phases (a, p, q)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int A_PITCH = 2 * TM + 16;    // bytes per staged input channel
constexpr int S_PITCH = 4 * TM + 16;    // bytes per staged output row (a, p, o)
constexpr int S_BYTES = 4 * OG * S_PITCH;
static_assert(THREADS == OG * (TM / 4), "the store loop: one (o, four voxels) piece a thread");
static_assert(WARPS == 4 * (TM / 32), "a warp per (a, p) pair and half of the tile");

__host__ __device__ constexpr int b_pitch(int cin16) { return 2 * cin16 + 16; }

__host__ __device__ constexpr int smem_bytes(int cin16) {
  return NPH * OG * b_pitch(cin16) + 2 * cin16 * A_PITCH + S_BYTES;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

// d += a (16x16, row major) * b (16x8, col major), bf16 in, fp32 out
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

struct Shape {
  int Cin, Cout, D, H, W;
  int V;            // D * H * W, the input voxels of one batch element
  int tiles_per_b;  // ceil(V / TM)
  int ntiles;       // B * tiles_per_b
};

// Stage the input tile `tile` ([Cin16][TM voxels], zero past Cin and past
// the volume) at shared address as (as_g: the same memory for plain
// stores). vec: V % 8 == 0 and x is 16-byte aligned, so each 8-voxel piece
// is aligned and lies wholly inside or wholly outside the volume.
__device__ __forceinline__ void load_a(uint32_t as, unsigned char* as_g,
                                       const bf16* __restrict__ x, const Shape& s, int cin16,
                                       int tile, bool vec) {
  const int b = tile / s.tiles_per_b;
  const int v0 = (tile - b * s.tiles_per_b) * TM;
  const int valid = min(TM, s.V - v0);
  const bf16* xb = x + size_t(b) * s.Cin * s.V + v0;
  if (vec) {
    for (int u = threadIdx.x; u < cin16 * (TM / 8); u += THREADS) {
      const int c = u / (TM / 8), piece = u % (TM / 8);
      const bool in = c < s.Cin && piece * 8 < valid;
      cp_async16(as + c * A_PITCH + piece * 16, in ? xb + size_t(c) * s.V + piece * 8 : x, in);
    }
  } else {
    const unsigned short* xu = reinterpret_cast<const unsigned short*>(xb);
    for (int u = threadIdx.x; u < cin16 * TM; u += THREADS) {
      const int c = u / TM, m = u % TM;
      *reinterpret_cast<unsigned short*>(as_g + c * A_PITCH + 2 * m) =
          c < s.Cin && m < valid ? xu[size_t(c) * s.V + m] : (unsigned short)0;
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 2)
upconv_d2s_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kp,
                  const float* __restrict__ bias, bf16* __restrict__ out, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (int(blockIdx.x) >= s.ntiles) return;  // block-uniform
  const int cin16 = (s.Cin + 15) & ~15;
  const int cout16 = (s.Cout + 15) & ~15;
  const int bp = b_pitch(cin16);
  const int a_stage = cin16 * A_PITCH;
  const uint32_t bs = uint32_t(__cvta_generic_to_shared(smem));
  const uint32_t as0 = bs + NPH * OG * bp;
  unsigned char* const as0_g = smem + NPH * OG * bp;
  unsigned char* const stg = as0_g + 2 * a_stage;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int og0 = blockIdx.y * OG;
  const bool vec_in = s.V % 8 == 0 && aligned16(x);
  const bool vec_out = s.W % 4 == 0 && aligned16(out);

  // the block's weights: row ph * OG + o <- packed row (ph, og0 + o)
  for (int u = tid; u < NPH * OG * (cin16 / 8); u += THREADS) {
    const int row = u / (cin16 / 8), piece = u % (cin16 / 8);
    const int ph = row / OG, o = row % OG;
    cp_async16(bs + row * bp + piece * 16,
               kp + (size_t(ph) * cout16 + og0 + o) * cin16 + piece * 8, true);
  }
  load_a(as0, as0_g, x, s, cin16, blockIdx.x, vec_in);  // commits the weights with it

  // ldmatrix rows of this lane. A (.trans): matrix q = lane / 8 holds
  // channels 8 (q >> 1) .. + 7 (its rows) at voxels 8 (q & 1) .. + 7.
  // B: matrix q holds the (phase, o) rows 8 (q >> 1) .. + 7 at channels
  // 8 (q & 1) .. + 7.
  const int ap = warp >> 1, mh = warp & 1;
  const uint32_t a_off =
      uint32_t((lane & 7) + ((lane >> 4) << 3)) * A_PITCH + (32 * mh + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t b_off = bs + uint32_t(32 * ap + (lane & 7) + ((lane >> 4) << 3)) * bp +
                         ((lane >> 3) & 1) * 16;
  // this thread's store piece: channel ol of the group, voxels 4 g .. 4 g + 3
  const int ol = tid >> 4, g = tid & 15;
  const bool o_ok = og0 + ol < s.Cout;
  const int HW = s.H * s.W;
  float bo[2][2];  // the bias of this lane's accumulator columns o = 8 j + 2 (lane & 3) + e
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = og0 + 8 * j + 2 * (lane & 3) + e;
      bo[j][e] = o < s.Cout ? bias[o] : 0.0f;
    }

  int st = 0;
  for (int tile = blockIdx.x; tile < s.ntiles; tile += gridDim.x, st ^= 1) {
    const int next = tile + gridDim.x;
    if (next < s.ntiles) {
      load_a(as0 + (st ^ 1) * a_stage, as0_g + (st ^ 1) * a_stage, x, s, cin16, next, vec_in);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // this tile's input (and the weights) have landed

    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
    const uint32_t a_base = as0 + st * a_stage + a_off;
    for (int k0 = 0; k0 < cin16; k0 += 16) {
      uint32_t a[2][4], q0[4], q1[4];
      ldsm_x4_trans(a[0], a_base + k0 * A_PITCH);
      ldsm_x4_trans(a[1], a_base + k0 * A_PITCH + 32);
      ldsm_x4(q0, b_off + k0 * 2);            // q = 0: o 0..7, 8..15
      ldsm_x4(q1, b_off + 16 * bp + k0 * 2);  // q = 1
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma16816(acc[mt][0], a[mt], q0[0], q0[1]);
        mma16816(acc[mt][1], a[mt], q0[2], q0[3]);
        mma16816(acc[mt][2], a[mt], q1[0], q1[1]);
        mma16816(acc[mt][3], a[mt], q1[2], q1[3]);
      }
    }

    // bias, one rounding, the q pair as one word: stage [a p][o][voxel]
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 8 * j + 2 * (lane & 3) + (e & 1);
        const float b_o = bo[j][e & 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int m = 32 * mh + 16 * mt + (lane >> 2) + 8 * (e >> 1);
          *reinterpret_cast<uint32_t*>(stg + (ap * OG + o) * S_PITCH + 4 * m) =
              pack_bf16x2(acc[mt][j][e] + b_o, acc[mt][j + 2][e] + b_o);
        }
      }
    __syncthreads();  // the stage is complete

    const int b = tile / s.tiles_per_b;
    const int v0 = (tile - b * s.tiles_per_b) * TM;
    const int valid = min(TM, s.V - v0);
    bf16* const ob = out + (size_t(b) * s.Cout + og0 + ol) * (size_t(8) * s.V);
    const unsigned char* const sp = stg + ol * S_PITCH;
    if (o_ok && vec_out) {
      if (4 * g < valid) {  // valid % 4 == 0: W % 4 == 0
        const int v = v0 + 4 * g, d = v / HW, h = (v - d * HW) / s.W, w = v - d * HW - h * s.W;
#pragma unroll
        for (int a2 = 0; a2 < 4; ++a2) {  // (a, p)
          const size_t row = (size_t(2 * d + (a2 >> 1)) * 2 * s.H + 2 * h + (a2 & 1)) * 2 * s.W;
          *reinterpret_cast<uint4*>(ob + row + 2 * w) =
              *reinterpret_cast<const uint4*>(sp + a2 * OG * S_PITCH + 16 * g);
        }
      }
    } else if (o_ok) {
      for (int i = 0; i < 4; ++i) {
        const int m = 4 * g + i;
        if (m >= valid) break;
        const int v = v0 + m, d = v / HW, h = (v - d * HW) / s.W, w = v - d * HW - h * s.W;
#pragma unroll
        for (int a2 = 0; a2 < 4; ++a2) {
          const size_t row = (size_t(2 * d + (a2 >> 1)) * 2 * s.H + 2 * h + (a2 & 1)) * 2 * s.W;
          *reinterpret_cast<uint32_t*>(ob + row + 2 * w) =
              *reinterpret_cast<const uint32_t*>(sp + a2 * OG * S_PITCH + 4 * m);
        }
      }
    }
  }
}

}  // namespace

// Dynamic shared memory of an upconv_d2s_kernel block for Cin input channels.
MMSEG_API int mmseg_upconv_smem_bytes(int cin) { return smem_bytes((cin + 15) & ~15); }

// out (B, Cout, 2D, 2H, 2W) from x (B, Cin, D, H, W), the packed weights
// kp (8, Cout16, Cin16) and bias (Cout,); nblk blocks per channel group.
MMSEG_API int mmseg_upconv_d2s(const void* x, const void* kp, const void* bias, void* out, int B,
                               int Cin, int Cout, int D, int H, int W, int nblk, void* stream) {
  const long long V = (long long)D * H * W;
  if (V == 0 || B == 0) return int(cudaSuccess);
  if (Cin < 1 || Cout < 1 || nblk < 1 || B * ((V + TM - 1) / TM) * TM >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0)
    return int(cudaErrorInvalidValue);
  Shape s{Cin, Cout, D, H, W, int(V), int((V + TM - 1) / TM), 0};
  s.ntiles = B * s.tiles_per_b;
  const int smem = smem_bytes((Cin + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(upconv_d2s_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  dim3 grid(unsigned(nblk < s.ntiles ? nblk : s.ntiles), unsigned((Cout + OG - 1) / OG));
  upconv_d2s_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(kp), static_cast<const float*>(bias),
      static_cast<bf16*>(out), s);
  return int(cudaGetLastError());
}
