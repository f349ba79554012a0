// Fused 3x3 stride-1 SAME conv + per-channel scale/bias + ReLU for Hopper
// (sm_90a), NHWC x HWIO.
//
// Replaces the TPU kernel ocrjax/ops/pallas/conv_fused.py::conv3x3_bn_relu
// (body _kernel). It computes what
// ocrjax_torch.ops.conv_fused.conv_bn_relu_torch computes: x and w rounded to
// bf16, the 9*Cin products of every output summed in float32, then
// max(acc * scale + bias, 0) cast to x's dtype (float32 or bf16).
//
// Three kernels; ocrjax_torch/ops/conv_fused.py picks (conv_path, conv_plan)
// and the C functions below check the choice again.
//
// 1. wgmma path (conv3x3_wgmma_kernel): Cin % 8 == 0 and Cout % 8 == 0, all
// production shapes with Cin >= 64. The function is a GEMM of M = B*H*W
// pixels, N = Cout, K = 9*Cin whose A operand is never materialised.
//   * A block owns 128 output pixels (a TH x TW patch: 8x16, 4x32 or 2x64,
//     or 4x16 of two images; the host picks the one that pads the fewest
//     pixels, so a 4 x 80 CRNN map fills its tiles) times BN output channels
//     (128, 64 or 24: Cout 24 is an n24 product, nothing is padded to 32).
//     Two consumer warpgroups take 64 pixels each and run wgmma.mma_async
//     m64nBNk16 with A and B both in shared memory and the float32 sums in
//     registers.
//   * A ring of 2-6 stages in shared memory, a "full" and an "empty" mbarrier
//     per stage, one producer thread that keeps TMA loads in flight, and
//     wgmma.wait_group 1 in the consumers, so that the tensor cores always
//     have the next stage's products queued behind the running ones.
//   * How A gets there. x is described to TMA as a 4-D bf16 tensor
//     (C, W, H, B). A stage is one 32-channel chunk of Cin and one column
//     shift dx: the box {32, TW, TH + 2, images} at (c0, ox0 + dx - 1,
//     oy0 - 1, b0) lands as images * (TH + 2) * TW rows of 64 B with the
//     64-byte swizzle,
//     which is the K-major layout wgmma reads. Coordinates outside the
//     tensor, negative ones included, are filled with zeros, which is SAME
//     padding: no predicates and no padded copy of x. Because TW is a
//     multiple of 8, the three row shifts dy are the same stage at a start
//     address moved by dy * TW * 64 B, a multiple of the swizzle's 512-byte
//     period, so one load serves three taps: x comes 3 * (TH + 2) / TH times
//     from L2 per Cout tile instead of 9 times with a box per tap. (One halo
//     tile with nine views would read it once, but a shift by one pixel row
//     breaks the swizzle's phase; the unswizzled layout needs 16-byte
//     pieces.) Chunks of 32 channels and not 64 keep a stage small enough
//     for a ring of 4 under 256 pixels a block (next point); with 64-channel
//     stages only 2 fit and the loads no longer hide behind the products.
//   * With MI = 2 (at BN 128) a block takes the same patch of twice as many
//     images, 256 pixels (each warpgroup two m64 tiles, 128 accumulator
//     registers a thread, the producer's warpgroup handing its registers
//     over with setmaxnreg): a weight tile pulled from L2 then serves 256
//     pixels.
//     The loads are what the kernel waits for (with the products switched
//     off it takes most of its time), so bytes pulled per product count.
//   * B: a pre-kernel rewrites w per call as bf16 [tap][Cout][Cin], K-major,
//     zero padded to (BN, 32); a stage takes the three {32, BN} boxes of taps
//     (dy, dx), dy = 0..2, with the same swizzle.
//   * A ragged last chunk (Cin 8 or 24 mod 32) is zero filled by TMA and an
//     all-zero k16 step is skipped.
//   * Blocks are persistent (one or two an SM, each walking the output tiles
//     i, i + gridDim.x, ...) and the ring runs on across tiles: while the
//     consumers finish a tile the producer already loads the next one.
//   * Epilogue from registers: scale, bias, ReLU, cast, staged per warp in
//     its own shared memory (padded rows, conflict free, 64 channels at a
//     time) and stored 16 bytes a lane, a pixel's channels contiguous.
//   * float32 x: a cast pre-kernel writes a bf16 copy into scratch that the
//     wrapper allocates, then the same kernel runs with float32 stores.
//
// 2. small-Cin path (conv3x3_small_cin_kernel): Cin <= 4 and Cout % 8 == 0
// (crnn.conv0, Cin 1). That shape is bytes, not products (67 times more
// output than input), so it is SIMT: the bf16-rounded weights sit in shared
// memory, a thread owns 8 output channels and computes them for two
// neighbouring pixels at a time (shared loads of x and w, 9*Cin fused
// multiply-adds an output) and stores 16 (bf16) or 32 (float32) bytes a
// pixel, neighbouring threads neighbouring addresses.
//
// 3. general path (conv3x3_kernel, the first version of this file): any
// shape, ragged channels and unaligned pointers included. 4 warps own 128
// pixels x 64 (or 32) channels, walk Cin in chunks of 16 staged synchronously
// in shared memory, and run nvcuda::wmma 16x16x16 tiles. It stays as the path
// for what the two above do not take, and as the yardstick they are timed
// against.
//
// Bound. At the production shapes the function is bound by the tensor-core
// rate for Cin, Cout >= 128 and by bytes below (x read once, y written once).
// By kernel time the wgmma path reaches 0.5 to 0.8 of that bound on the
// operation-bound shapes and 0.3 on the byte-bound ones (NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md has the table).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kChunk = 16;           // input channels per step
constexpr int kWarps = 4;            // each warp owns 2 rows x 16 columns
constexpr int kThreads = kWarps * 32;
constexpr int kTilePixels = kWarps * 2 * 16;

// w (3, 3, Cin, Cout) float32 -> wp (9, cin_pad, cout_pad) bf16, zero filled.
__global__ void pack_weights_kernel(const float* __restrict__ w,
                                    __nv_bfloat16* __restrict__ wp, int Cin,
                                    int Cout, int cin_pad, int cout_pad) {
  const int64_t total = static_cast<int64_t>(9) * cin_pad * cout_pad;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(i % cout_pad);
    const int64_t r = i / cout_pad;
    const int c = static_cast<int>(r % cin_pad);
    const int tap = static_cast<int>(r / cin_pad);
    float v = 0.0f;
    if (c < Cin && n < Cout)
      v = w[(static_cast<int64_t>(tap) * Cin + c) * Cout + n];
    wp[i] = __float2bfloat16(v);
  }
}

// 8 consecutive channels at p as bf16 (n of them valid, the rest zero).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int n,
                                       bool vec) {
  if (vec && n == 8) return *reinterpret_cast<const uint4*>(p);
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < n ? p[i] : __float2bfloat16(0.0f);
  return *reinterpret_cast<const uint4*>(v);
}

__device__ __forceinline__ uint4 load8(const float* p, int n, bool vec) {
  __align__(16) __nv_bfloat16 v[8];
  if (vec && n == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = __float2bfloat16(a.x);
    v[1] = __float2bfloat16(a.y);
    v[2] = __float2bfloat16(a.z);
    v[3] = __float2bfloat16(a.w);
    v[4] = __float2bfloat16(b.x);
    v[5] = __float2bfloat16(b.y);
    v[6] = __float2bfloat16(b.z);
    v[7] = __float2bfloat16(b.w);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __float2bfloat16(i < n ? p[i] : 0.0f);
  }
  return *reinterpret_cast<const uint4*>(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  __align__(16) __nv_bfloat16 o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
}

// TH output rows x (kTilePixels / TH) output columns per block; NFRAG
// 16-channel blocks per warp: the block's channel tile is 16 * NFRAG.
template <typename T, int NFRAG, int TH>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ y, int H, int W, int Cin, int Cout,
               int cin_pad, int cout_pad, int tiles_x, int tiles_per_image,
               int vec_in, int vec_out) {
  constexpr int BN = 16 * NFRAG;
  constexpr int kWsLd = BN + 8;      // padded row of the weight tile
  constexpr int kTileH = TH;
  constexpr int kTileW = kTilePixels / TH;
  constexpr int kHaloH = kTileH + 2;
  constexpr int kHaloW = kTileW + 2;
  constexpr int kRowPairs = TH / 2;  // warp -> (row pair, 16-column block)
  __shared__ __align__(32) __nv_bfloat16 xs[kHaloH * kHaloW * kChunk];
  __shared__ __align__(32) __nv_bfloat16 ws[9 * kChunk * kWsLd];
  __shared__ __align__(32) float stage[kWarps][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = 2 * (warp % kRowPairs);   // the warp's first tile row
  const int wcol = 16 * (warp / kRowPairs);  // and first tile column
  const int b = blockIdx.x / tiles_per_image;
  const int t = blockIdx.x - b * tiles_per_image;
  const int oy0 = (t / tiles_x) * kTileH;
  const int ox0 = (t % tiles_x) * kTileW;
  const int n0 = blockIdx.y * BN;
  const T* xb = x + static_cast<int64_t>(b) * H * W * Cin;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NFRAG];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int f = 0; f < NFRAG; ++f) wmma::fill_fragment(acc[r][f], 0.0f);

  for (int c0 = 0; c0 < cin_pad; c0 += kChunk) {
    if (c0 > 0) __syncthreads();     // the previous chunk's tiles are read
    // halo tile of x: (kHaloH x kHaloW) pixels x 16 channels, in two halves
    for (int i = tid; i < kHaloH * kHaloW * 2; i += kThreads) {
      const int pix = i >> 1;
      const int half = i & 1;
      const int gy = oy0 + pix / kHaloW - 1;
      const int gx = ox0 + pix % kHaloW - 1;
      const int c = c0 + half * 8;
      int n = Cin - c;
      n = n < 0 ? 0 : (n > 8 ? 8 : n);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n > 0 && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = load8(xb + (static_cast<int64_t>(gy) * W + gx) * Cin + c, n,
                  vec_in != 0);
      *reinterpret_cast<uint4*>(xs + pix * kChunk + half * 8) = v;
    }
    // weight slice: 9 taps x 16 channels x BN outputs
    for (int i = tid; i < 9 * kChunk * (BN / 8); i += kThreads) {
      const int row = i / (BN / 8);  // tap * kChunk + k
      const int j = i % (BN / 8);
      const int tap = row / kChunk;
      const int k = row % kChunk;
      const __nv_bfloat16* src =
          wp + (static_cast<int64_t>(tap) * cin_pad + c0 + k) * cout_pad + n0 +
          j * 8;
      *reinterpret_cast<uint4*>(ws + row * kWsLd + j * 8) =
          *reinterpret_cast<const uint4*>(src);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        wmma::load_matrix_sync(
            a[r], xs + ((wrow + r + dy) * kHaloW + wcol + dx) * kChunk,
            kChunk);
#pragma unroll
      for (int f = 0; f < NFRAG; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, ws + tap * kChunk * kWsLd + f * 16, kWsLd);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wmma::mma_sync(acc[r][f], a[r], bf, acc[r][f]);
      }
    }
  }

  // epilogue: a lane takes 8 consecutive channels of one pixel
  const int px = lane >> 1;
  const int c8 = (lane & 1) * 8;
  const int ox = ox0 + wcol + px;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int oy = oy0 + wrow + r;
#pragma unroll
    for (int f = 0; f < NFRAG; ++f) {
      wmma::store_matrix_sync(stage[warp], acc[r][f], 16, wmma::mem_row_major);
      __syncwarp();
      const int n = n0 + f * 16 + c8;
      if (oy < H && ox < W && n < Cout) {
        float v[8];
        const int nv = Cout - n < 8 ? Cout - n : 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float o = 0.0f;
          if (j < nv)
            o = fmaxf(stage[warp][px * 16 + c8 + j] * scale[n + j] +
                          bias[n + j], 0.0f);
          v[j] = o;
        }
        T* dst = y + ((static_cast<int64_t>(b) * H + oy) * W + ox) * Cout + n;
        if (vec_out && nv == 8) {
          store8(dst, v);
        } else {
          for (int j = 0; j < nv; ++j) store1(dst + j, v[j]);
        }
      }
      __syncwarp();
    }
  }
}

template <typename T, int NFRAG, int TH>
int launch_tile(const void* x, const void* wp, const void* scale,
                const void* bias, void* y, int B, int H, int W, int Cin,
                int Cout, int cin_pad, int cout_pad, int vec_in, int vec_out,
                cudaStream_t stream) {
  constexpr int kTileW = kTilePixels / TH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + TH - 1) / TH;
  const int64_t blocks = static_cast<int64_t>(B) * tiles_x * tiles_y;
  const int cout_tiles = cout_pad / (16 * NFRAG);
  if (blocks > 2147483647LL || cout_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(cout_tiles));
  conv3x3_kernel<T, NFRAG, TH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(y), H, W, Cin, Cout, cin_pad, cout_pad, tiles_x,
      tiles_x * tiles_y, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// Pixels a tile shape covers, the padding of ragged tiles included.
int64_t padded_pixels(int H, int W, int th) {
  const int tw = kTilePixels / th;
  return static_cast<int64_t>((H + th - 1) / th) * th *
         (static_cast<int64_t>((W + tw - 1) / tw) * tw);
}

template <typename T, int NFRAG>
int launch(const void* x, const void* wp, const void* scale, const void* bias,
           void* y, int B, int H, int W, int Cin, int Cout, int cin_pad,
           int cout_pad, int vec_in, int vec_out, cudaStream_t stream) {
  // the tile shape that wastes the fewest pixels; ties go to the taller
  int th = 8;
  if (padded_pixels(H, W, 4) < padded_pixels(H, W, th)) th = 4;
  if (padded_pixels(H, W, 2) < padded_pixels(H, W, th)) th = 2;
  if (th == 8)
    return launch_tile<T, NFRAG, 8>(x, wp, scale, bias, y, B, H, W, Cin, Cout,
                                    cin_pad, cout_pad, vec_in, vec_out,
                                    stream);
  if (th == 4)
    return launch_tile<T, NFRAG, 4>(x, wp, scale, bias, y, B, H, W, Cin, Cout,
                                    cin_pad, cout_pad, vec_in, vec_out,
                                    stream);
  return launch_tile<T, NFRAG, 2>(x, wp, scale, bias, y, B, H, W, Cin, Cout,
                                  cin_pad, cout_pad, vec_in, vec_out, stream);
}

}  // namespace

// The general path. x, y (B, H, W, Cin / Cout) contiguous, float32
// (x_is_bf16 = 0) or bf16; w (3, 3, Cin, Cout), scale, bias (Cout,) float32;
// wp: scratch of 9 * cin_pad * cout_pad bf16, where cin_pad rounds Cin up to
// 16 and cout_pad rounds Cout up to `cout_tile` (32 or 64). Launches on
// `stream`; returns the first CUDA error, 0 if none.
extern "C" int ocj_conv3x3_bn_relu(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* y, void* wp, int B, int H, int W,
                                   int Cin, int Cout, int cout_tile,
                                   int x_is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (Cin <= 0 || (cout_tile != 32 && cout_tile != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cin_pad = (Cin + kChunk - 1) / kChunk * kChunk;
  const int cout_pad = (Cout + cout_tile - 1) / cout_tile * cout_tile;
  const int64_t total = static_cast<int64_t>(9) * cin_pad * cout_pad;
  int pack_blocks = static_cast<int>((total + 255) / 256);
  if (pack_blocks > 4096) pack_blocks = 4096;
  pack_weights_kernel<<<pack_blocks, 256, 0, s>>>(
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(wp), Cin, Cout,
      cin_pad, cout_pad);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // 16-byte vector loads and stores need 16-byte aligned rows
  const int elem = x_is_bf16 ? 2 : 4;
  const int per16 = 16 / elem;
  const int vec_in = (Cin % 8 == 0) && (Cin % per16 == 0) &&
                     (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int vec_out = (Cout % 8 == 0) && (Cout % per16 == 0) &&
                      (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (x_is_bf16) {
    return cout_tile == 64
        ? launch<__nv_bfloat16, 4>(x, wp, scale, bias, y, B, H, W, Cin, Cout,
                                   cin_pad, cout_pad, vec_in, vec_out, s)
        : launch<__nv_bfloat16, 2>(x, wp, scale, bias, y, B, H, W, Cin, Cout,
                                   cin_pad, cout_pad, vec_in, vec_out, s);
  }
  return cout_tile == 64
      ? launch<float, 4>(x, wp, scale, bias, y, B, H, W, Cin, Cout, cin_pad,
                         cout_pad, vec_in, vec_out, s)
      : launch<float, 2>(x, wp, scale, bias, y, B, H, W, Cin, Cout, cin_pad,
                         cout_pad, vec_in, vec_out, s);
}

// ---------------------------------------------------------------------------
// wgmma path
// ---------------------------------------------------------------------------

namespace {

constexpr int kBK = 32;               // channels a stage: one 64-byte row
constexpr uint32_t kRowBytes = kBK * 2;
constexpr int kKSteps = kBK / 16;     // k16 products a row holds
constexpr int kConsumerThreads = 256; // two warpgroups, 64 pixels each
constexpr int kWgThreads = 384;       // and the producer's warpgroup
constexpr int kMaxStages = 6;
constexpr int kSharedLimit = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase with this parity has completed. A phase
// that does not complete within about two seconds is a fault in the ring's
// bookkeeping: the kernel traps (the launch then fails) rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  long long t0 = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (++spins & 1023u) == 0) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > 4000000000LL) __trap();
    }
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor: K-major rows of 64 B, 64-byte swizzle
// (layout type 2), 512 B from one group of 8 rows to the next; the leading
// offset is not read for a swizzled K-major operand.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * kRowBytes / 16) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N, float32, in the warpgroup's registers) += A (64 x 16) * B
// (16 x N), both bf16 in shared memory, K-major.
template <int N>
struct Mma;

template <>
struct Mma<24> {
  static __device__ __forceinline__ void run(float (&d)[12], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11}, "
        "%12, %13, p, 1, 1, 0, 0;\n"
        "}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// What a block needs to know of the output tile t: tiles are numbered with
// the Cout tile fastest, so that the blocks that read the same x run together.
struct Tile {
  int b0, oy0, ox0, n0;
};

__device__ __forceinline__ Tile tile_at(int t, int n_ctiles,
                                        int tiles_per_image, int tiles_x,
                                        int th, int tw, int bn, int images) {
  Tile o;
  o.n0 = (t % n_ctiles) * bn;
  const int pt = t / n_ctiles;
  o.b0 = (pt / tiles_per_image) * images;
  const int r = pt % tiles_per_image;
  o.oy0 = (r / tiles_x) * th;
  o.ox0 = (r % tiles_x) * tw;
  return o;
}

// MI m64 tiles a warpgroup, 2 * MI a block: 1 (128 pixels a block) or 2 (256
// pixels, so that a weight tile loaded from L2 serves twice as many). A
// patch of 128 pixels is two m64 tiles of one image, a patch of 64 pixels
// (4 x 16, `halves` = 1) one: the block takes `images` = 2 * MI / halves
// images, the same patch of each.
// Blocks are persistent: block i takes the tiles i, i + gridDim.x, ... and
// the ring runs on across tiles, so the producer is already loading the next
// tile while the consumers scale, stage and store the current one.
template <int BN, int MI, typename TOut>
__global__ void __launch_bounds__(kWgThreads, (MI * BN <= 64) ? 2 : 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, TOut* __restrict__ y,
                     int B, int H, int W, int Cin, int Cout, int cout_pad,
                     int th, int tw_log2, int halves, int tiles_x,
                     int tiles_per_image, int n_ctiles, int total_tiles,
                     int stages) {
  // accumulators past 64 registers a thread need the producer's registers
  constexpr bool kRealloc = MI * BN > 128;
  constexpr int kOut = static_cast<int>(sizeof(TOut));
  constexpr int kStageCols = BN < 64 ? BN : 64;  // channels staged at a time
  constexpr int kPitch = kStageCols * kOut + 16; // bytes a staged pixel row
  extern __shared__ uint8_t smem_raw[];
  // the ring wants 1024-byte aligned stages (a multiple of the swizzle's
  // period); after it the consumer warps' output staging, then the barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tw = 1 << tw_log2;
  const uint32_t img_bytes = static_cast<uint32_t>((th + 2) * tw) * kRowBytes;
  const int images = 2 * MI / halves;
  const uint32_t a_bytes = images * img_bytes;
  constexpr uint32_t kTapBytes = BN * kRowBytes;
  constexpr uint32_t kTileBytes = 64 * kRowBytes;   // one m64 tile of A
  const uint32_t stage_bytes = a_bytes + 3u * kTapBytes;
  const uint32_t ring_bytes = static_cast<uint32_t>(stages) * stage_bytes;
  constexpr uint32_t kStagingBytes = (kConsumerThreads / 32) * 16 * kPitch;
  const uint32_t bars = base + ring_bytes + kStagingBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kMaxStages + s)

  const int tid = threadIdx.x;
  const int chunks = (Cin + kBK - 1) / kBK;
  const int n_it = chunks * 3;                   // (chunk, dx) stages a tile

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8u * s, 1u);
      mbar_init(bars + 8u * (kMaxStages + s), kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ===== producer: one thread keeps the ring full =====
    if (kRealloc) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumerThreads) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < total_tiles; t += gridDim.x) {
        const Tile tile =
            tile_at(t, n_ctiles, tiles_per_image, tiles_x, th, tw, BN, images);
        for (int it = 0; it < n_it; ++it) {
          const int chunk = it / 3;
          const int dx = it - chunk * 3;
          const uint32_t full = bars + 8u * s;
          const uint32_t sa = base + static_cast<uint32_t>(s) * stage_bytes;
          mbar_wait(bars + 8u * (kMaxStages + s), ph ^ 1u);
          mbar_expect_tx(full, stage_bytes);
          tma_load_4d(sa, &map_x, full, chunk * kBK, tile.ox0 + dx - 1,
                      tile.oy0 - 1, tile.b0);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            tma_load_2d(sa + a_bytes + dy * kTapBytes, &map_w, full,
                        chunk * kBK, (dy * 3 + dx) * cout_pad + tile.n0);
          if (++s == stages) {
            s = 0;
            ph ^= 1u;
          }
        }
      }
    }
  } else {
    // ===== consumers: two warpgroups, MI m64 tiles x BN channels each =====
    if (kRealloc) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wgi = tid >> 7;
    const int warp = tid >> 5;                   // 0..7
    const int lane = tid & 31;
    // m64 tile q of the block (this warpgroup's are wgi * MI + m) is half
    // q % halves of image q / halves
    const uint32_t a_wg = ((wgi * MI) / halves) * img_bytes +
                          ((wgi * MI) % halves) * kTileBytes;
    const uint32_t a_m = halves == 2 ? kTileBytes : img_bytes;
    // this warp's staging: 16 pixel rows x kStageCols channels
    uint8_t* stg =
        smem_raw + (base - raw) + ring_bytes + warp * 16 * kPitch;
    const int colq = (lane & 3) * 2;
    const int r0 = lane >> 2;
    constexpr int kPerRow = kStageCols * kOut / 16;  // 16-byte pieces a row
    constexpr int kPer16 = 16 / kOut;
    uint8_t* yb = reinterpret_cast<uint8_t*>(y);

    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < total_tiles; t += gridDim.x) {
      const Tile tile =
          tile_at(t, n_ctiles, tiles_per_image, tiles_x, th, tw, BN, images);
      float acc[MI][BN / 2];
#pragma unroll
      for (int m = 0; m < MI; ++m)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.0f;

      int prev = 0;
      for (int it = 0; it < n_it; ++it) {
        const int chunk = it / 3;
        // k16 steps that hold channels of x; the rest of a ragged chunk is 0
        int ksteps = (Cin - chunk * kBK + 15) >> 4;
        ksteps = ksteps > kKSteps ? kKSteps : ksteps;
        const uint32_t sa = base + static_cast<uint32_t>(s) * stage_bytes;
        mbar_wait(bars + 8u * s, ph);
        wgmma_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint32_t a0 =
              sa + a_wg + static_cast<uint32_t>(dy * tw) * kRowBytes;
          const uint32_t w0 = sa + a_bytes + dy * kTapBytes;
#pragma unroll
          for (int k = 0; k < kKSteps; ++k)
            if (k < ksteps) {
              const uint64_t db = smem_desc(w0 + k * 32u);
#pragma unroll
              for (int m = 0; m < MI; ++m)
                Mma<BN>::run(acc[m], smem_desc(a0 + m * a_m + k * 32u), db);
            }
        }
        wgmma_commit();
        if (it > 0) {
          wgmma_wait<1>();               // the stage before this one is read
          if (lane == 0) mbar_arrive(bars + 8u * (kMaxStages + prev));
        }
        prev = s;
        if (++s == stages) {
          s = 0;
          ph ^= 1u;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(bars + 8u * (kMaxStages + prev));

      // epilogue, a warp on its own 16 pixel rows of each m64 tile: scale,
      // bias, ReLU and the cast from registers into the warp's staging
      // (padded rows, conflict free), then 16 bytes a lane to y, a pixel's
      // channels contiguous
#pragma unroll
      for (int m = 0; m < MI; ++m) {
        const int q = wgi * MI + m;
        const int b = tile.b0 + q / halves;
        const int p0 = (q % halves) * 64 + (warp & 3) * 16;
#pragma unroll
        for (int h = 0; h < BN / kStageCols; ++h) {
#pragma unroll
          for (int jj = 0; jj < kStageCols / 8; ++jj) {
            const int j = h * (kStageCols / 8) + jj;
            const int col = 8 * jj + colq;
            const int n = tile.n0 + 8 * j + colq;
            float2 sc = make_float2(0.0f, 0.0f), bi = make_float2(0.0f, 0.0f);
            if (n < Cout) {
              sc = *reinterpret_cast<const float2*>(scale + n);
              bi = *reinterpret_cast<const float2*>(bias + n);
            }
            put2(reinterpret_cast<TOut*>(stg + r0 * kPitch) + col,
                 fmaxf(acc[m][4 * j] * sc.x + bi.x, 0.0f),
                 fmaxf(acc[m][4 * j + 1] * sc.y + bi.y, 0.0f));
            put2(reinterpret_cast<TOut*>(stg + (r0 + 8) * kPitch) + col,
                 fmaxf(acc[m][4 * j + 2] * sc.x + bi.x, 0.0f),
                 fmaxf(acc[m][4 * j + 3] * sc.y + bi.y, 0.0f));
          }
          __syncwarp();
          for (int i = lane; i < 16 * kPerRow; i += 32) {
            const int row = i / kPerRow;
            const int q = i - row * kPerRow;
            const int p = p0 + row;
            const int oy = tile.oy0 + (p >> tw_log2);
            const int ox = tile.ox0 + (p & (tw - 1));
            const int n = tile.n0 + h * kStageCols + q * kPer16;
            if (b < B && oy < H && ox < W && n < Cout) {
              const int64_t at =
                  ((static_cast<int64_t>(b) * H + oy) * W + ox) * Cout + n;
              *reinterpret_cast<uint4*>(yb + at * kOut) =
                  *reinterpret_cast<const uint4*>(stg + row * kPitch + q * 16);
            }
          }
          __syncwarp();
        }
      }
      // the warpgroup's four warps enter the next tile's products together
      if (wgi == 0)
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
      else
        asm volatile("bar.sync 2, 128;\n" ::: "memory");
    }
  }
}

// w (3, 3, Cin, Cout) float32 -> wp (9, cout_pad, cin_pad) bf16, K-major,
// zero filled: a 32 x 32 transpose through shared memory, so that both the
// reads (along Cout) and the writes (along Cin) are contiguous.
__global__ void pack_weights_kmajor_kernel(const float* __restrict__ w,
                                           __nv_bfloat16* __restrict__ wp,
                                           int Cin, int Cout, int cin_pad,
                                           int cout_pad) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.z;
  const int c0 = blockIdx.x * 32;
  const int n0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i;
    const int n = n0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (c < Cin && n < Cout)
            ? w[(static_cast<int64_t>(tap) * Cin + c) * Cout + n]
            : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int n = n0 + i;
    const int c = c0 + threadIdx.x;
    if (n < cout_pad && c < cin_pad)
      wp[(static_cast<int64_t>(tap) * cout_pad + n) * cin_pad + c] =
          __float2bfloat16(tile[threadIdx.x][i]);
  }
}

// float32 -> bf16, 8 values a thread; n is a multiple of 8.
__global__ void cast_bf16_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ out, int64_t n8) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n8; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 c = reinterpret_cast<const float4*>(x)[2 * i + 1];
    __align__(16) __nv_bfloat162 o[4] = {
        __floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
        __floats2bfloat162_rn(c.x, c.y), __floats2bfloat162_rn(c.z, c.w)};
    reinterpret_cast<uint4*>(out)[i] = *reinterpret_cast<const uint4*>(o);
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the
// runtime, so that the library links without -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                  &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 tensor map with the 64-byte swizzle; dims, strides (bytes, from
// the second dimension on) and box innermost first.
int encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
         dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Streaming multiprocessors of the current device.
int sm_count(int dev) {
  static int count[64] = {};
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

template <int BN, int MI, typename TOut>
int launch_wgmma(const CUtensorMap& map_x, const CUtensorMap& map_w,
                 const void* scale, const void* bias, void* y, int B, int H,
                 int W, int Cin, int Cout, int cout_pad, int th, int tw,
                 int stages, cudaStream_t stream) {
  const int halves = th * tw / 64;               // m64 tiles a patch
  const int images = 2 * MI / halves;
  const int tiles_x = (W + tw - 1) / tw;
  const int tiles_y = (H + th - 1) / th;
  const int n_ctiles = cout_pad / BN;
  const int64_t tiles = static_cast<int64_t>((B + images - 1) / images) *
                        tiles_x * tiles_y * n_ctiles;
  if (tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int stage_bytes =
      (images * (th + 2) * tw + 3 * BN) * static_cast<int>(kRowBytes);
  const int staging = (kConsumerThreads / 32) * 16 *
                      ((BN < 64 ? BN : 64) * static_cast<int>(sizeof(TOut)) +
                       16);
  const int smem = 1024 + stages * stage_bytes + staging + 16 * kMaxStages;
  if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv3x3_wgmma_kernel<BN, MI, TOut>;
  // the attribute is per device and kernel instance: raised when needed
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) smem_set[dev] = smem;
  }
  // persistent blocks: as many as fit the card at once
  const int per_sm = (MI * BN <= 64 && 2 * (smem + 1024) <= kSharedLimit)
                         ? 2 : 1;
  const int64_t fit = static_cast<int64_t>(sm_count(dev)) * per_sm;
  const int blocks = static_cast<int>(tiles < fit ? tiles : fit);
  int tw_log2 = 0;
  while ((1 << tw_log2) < tw) ++tw_log2;
  kernel<<<blocks, kWgThreads, smem, stream>>>(
      map_x, map_w, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TOut*>(y), B, H, W, Cin,
      Cout, cout_pad, th, tw_log2, halves, tiles_x, tiles_x * tiles_y,
      n_ctiles, static_cast<int>(tiles), stages);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ void fma8(float (&a)[8], float x, const float4& w0,
                                     const float4& w1) {
  a[0] = fmaf(x, w0.x, a[0]);
  a[1] = fmaf(x, w0.y, a[1]);
  a[2] = fmaf(x, w0.z, a[2]);
  a[3] = fmaf(x, w0.w, a[3]);
  a[4] = fmaf(x, w1.x, a[4]);
  a[5] = fmaf(x, w1.y, a[5]);
  a[6] = fmaf(x, w1.z, a[6]);
  a[7] = fmaf(x, w1.w, a[7]);
}

template <typename T>
__device__ __forceinline__ void scale_bias_relu_store8(
    T* dst, const float (&a)[8], const float (&sc)[8], const float (&bi)[8]) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = fmaxf(a[j] * sc[j] + bi[j], 0.0f);
  store8(dst, v);
}

// The block is (Cout / 8) x P threads: threadIdx.x owns 8 output channels
// (its scale and bias stay in registers), threadIdx.y walks pairs of
// neighbouring pixels of one image row, so that the two pixels share their
// loads of x and of the weights (rounded to bf16, in shared memory) and no
// thread divides per pixel. Blocks stride over the B * H rows.
template <typename T>
__global__ void __launch_bounds__(256)
conv3x3_small_cin_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ y,
                         int H, int W, int Cin, int Cout, int rows) {
  extern __shared__ __align__(16) float ws[];    // [9 * Cin][Cout]
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < 9 * Cin * Cout;
       i += nthreads)
    ws[i] = __bfloat162float(__float2bfloat16(w[i]));
  __syncthreads();
  const int n = threadIdx.x * 8;
  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = scale[n + j];
    bi[j] = bias[n + j];
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int oy = row % H;
    const T* xrow = x + static_cast<int64_t>(row) * W * Cin;
    T* yrow = y + static_cast<int64_t>(row) * W * Cout + n;
    for (int ox = 2 * threadIdx.y; ox < W; ox += 2 * blockDim.y) {
      float a0[8], a1[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a0[j] = a1[j] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int gy = oy + dy - 1;
        if (gy < 0 || gy >= H) continue;
        const T* xr = xrow + static_cast<int64_t>(dy - 1) * W * Cin;
        for (int c = 0; c < Cin; ++c) {
          float xv[4];                           // columns ox - 1 .. ox + 2
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int gx = ox - 1 + k;
            xv[k] = (gx >= 0 && gx < W)
                        ? __bfloat162float(__float2bfloat16(
                              static_cast<float>(xr[gx * Cin + c])))
                        : 0.0f;
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* wt = ws + ((dy * 3 + dx) * Cin + c) * Cout + n;
            const float4 w0 = *reinterpret_cast<const float4*>(wt);
            const float4 w1 = *reinterpret_cast<const float4*>(wt + 4);
            fma8(a0, xv[dx], w0, w1);
            fma8(a1, xv[dx + 1], w0, w1);
          }
        }
      }
      scale_bias_relu_store8(yrow + static_cast<int64_t>(ox) * Cout, a0, sc,
                             bi);
      if (ox + 1 < W)
        scale_bias_relu_store8(yrow + static_cast<int64_t>(ox + 1) * Cout, a1,
                               sc, bi);
    }
  }
}

}  // namespace

// The weight pre-kernel of the wgmma path alone: w (3, 3, Cin, Cout) float32
// -> wp (9, cout_pad, cin_pad) bf16, zero filled.
extern "C" int ocj_pack_weights_kmajor(const void* w, void* wp, int Cin,
                                       int Cout, int cin_pad, int cout_pad,
                                       void* stream) {
  if (Cin <= 0 || Cout <= 0 || cin_pad < Cin || cout_pad < Cout)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cin_pad + 31) / 32, (cout_pad + 31) / 32, 9);
  pack_weights_kmajor_kernel<<<grid, dim3(32, 8), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(wp), Cin,
      Cout, cin_pad, cout_pad);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma path. x, y (B, H, W, Cin / Cout) contiguous and 16-byte aligned,
// float32 (x_is_bf16 = 0) or bf16; Cin and Cout multiples of 8. wp: scratch
// of 9 * cout_pad * cin_pad bf16 (cin_pad a multiple of 32, cout_pad of bn);
// x_bf16: scratch of B * H * W * Cin bf16 for float32 x, else unused. The
// plan (bn in {24, 64, 128}; th x tw = 8x16, 4x32, 2x64 or 4x16; `images`
// a block: 128 or, only with bn 128, 256 pixels over th x tw; 2-6 stages) is
// ocrjax_torch.ops.conv_fused.conv_plan's. Launches on `stream`; returns the
// first CUDA error, 0 if none.
extern "C" int ocj_conv3x3_wgmma(const void* x, const void* w,
                                 const void* scale, const void* bias, void* y,
                                 void* wp, void* x_bf16, int B, int H, int W,
                                 int Cin, int Cout, int cin_pad, int cout_pad,
                                 int bn, int th, int tw, int images,
                                 int stages, int x_is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  const bool tile_ok = (th == 8 && tw == 16) || (th == 4 && tw == 32) ||
                       (th == 2 && tw == 64) || (th == 4 && tw == 16);
  // m64 tiles a warpgroup: images a block x m64 tiles a patch / 2
  const int mi = tile_ok ? images * (th * tw / 64) / 2 : 0;
  if (Cin <= 0 || Cin % 8 != 0 || Cout % 8 != 0 || !tile_ok ||
      (bn != 24 && bn != 64 && bn != 128) || cout_pad % bn != 0 ||
      cout_pad < Cout || cin_pad % kBK != 0 || cin_pad < Cin || stages < 2 ||
      images < 1 || images * (th * tw / 64) != 2 * mi ||
      (mi != 1 && (mi != 2 || bn != 128)) ||
      stages > kMaxStages || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0 ||
      (!x_is_bf16 && reinterpret_cast<uintptr_t>(x_bf16) % 16 != 0) ||
      (!x_is_bf16 && x_bf16 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = ocj_pack_weights_kmajor(w, wp, Cin, Cout, cin_pad, cout_pad,
                                    stream);
  if (err != 0) return err;
  const void* xb = x;
  if (!x_is_bf16) {
    const int64_t n8 = static_cast<int64_t>(B) * H * W * Cin / 8;
    int blocks = static_cast<int>((n8 + 255) / 256);
    if (blocks > 132 * 16) blocks = 132 * 16;
    cast_bf16_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<__nv_bfloat16*>(x_bf16), n8);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    xb = x_bf16;
  }
  CUtensorMap map_x, map_w;
  {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cin),
                                static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(Cin) * 2,
        static_cast<cuuint64_t>(W) * Cin * 2,
        static_cast<cuuint64_t>(H) * W * Cin * 2};
    const cuuint32_t box[4] = {kBK, static_cast<cuuint32_t>(tw),
                               static_cast<cuuint32_t>(th + 2),
                               static_cast<cuuint32_t>(images)};
    err = encode_bf16(&map_x, xb, 4, dims, strides, box);
    if (err != 0) return err;
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cin_pad),
                                static_cast<cuuint64_t>(9) * cout_pad};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cin_pad) * 2};
    const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(bn)};
    err = encode_bf16(&map_w, wp, 2, dims, strides, box);
    if (err != 0) return err;
  }
#define OCJ_WGMMA(BN_, MI_)                                                \
  (x_is_bf16                                                               \
       ? launch_wgmma<BN_, MI_, __nv_bfloat16>(map_x, map_w, scale, bias, y, \
                                               B, H, W, Cin, Cout, cout_pad, \
                                               th, tw, stages, s)          \
       : launch_wgmma<BN_, MI_, float>(map_x, map_w, scale, bias, y, B, H, \
                                       W, Cin, Cout, cout_pad, th, tw,     \
                                       stages, s))
  if (mi == 2) return OCJ_WGMMA(128, 2);
  if (bn == 128) return OCJ_WGMMA(128, 1);
  if (bn == 64) return OCJ_WGMMA(64, 1);
  return OCJ_WGMMA(24, 1);
#undef OCJ_WGMMA
}

// The small-Cin path: Cin <= 4, Cout a multiple of 8 and at most 2048,
// y 16-byte aligned, 9 * Cin * Cout floats of shared memory within 48 KB.
// Reads w as it is (no scratch). Launches on `stream`; returns the first
// CUDA error, 0 if none.
extern "C" int ocj_conv3x3_small_cin(const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     void* y, int B, int H, int W, int Cin,
                                     int Cout, int x_is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  const int64_t rows = static_cast<int64_t>(B) * H;
  const int64_t smem = static_cast<int64_t>(9) * Cin * Cout * 4;
  if (Cin <= 0 || Cin > 4 || Cout % 8 != 0 || Cout > 2048 ||
      rows > 2147483647LL || smem > 48 * 1024 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = Cout / 8;
  const dim3 block(groups, 256 / groups > 0 ? 256 / groups : 1);
  const int blocks = rows < 132 * 16 ? static_cast<int>(rows) : 132 * 16;
  if (x_is_bf16) {
    conv3x3_small_cin_kernel<__nv_bfloat16><<<blocks, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(y), H, W, Cin, Cout,
        static_cast<int>(rows));
  } else {
    conv3x3_small_cin_kernel<float><<<blocks, block, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(y), H, W, Cin, Cout, static_cast<int>(rows));
  }
  return static_cast<int>(cudaGetLastError());
}
