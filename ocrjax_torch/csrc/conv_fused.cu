// Fused 3x3 stride-1 SAME conv + per-channel scale/bias + ReLU for Hopper
// (sm_90a), NHWC x HWIO.
//
// Replaces the TPU kernel ocrjax/ops/pallas/conv_fused.py::conv3x3_bn_relu
// (body _kernel). It computes what
// ocrjax_torch.ops.conv_fused.conv_bn_relu_torch computes: x and w rounded to
// bf16, the 9*Cin products of every output summed in float32, then
// max(acc * scale + bias, 0) cast to x's dtype (float32 or bf16).
//
// Design. The TPU kernel pads x in HBM and copies whole-width row bands with
// the full Cout into its large fast memory; a Hopper block has 227 KB and
// wants many blocks in flight, so the work is cut the other way. A block of
// 4 warps owns a tile of 128 output pixels (8 rows x 16 columns, or 4 x 32
// or 2 x 64 for short images: the host picks the shape that wastes the
// fewest pixels, so a 4-row CRNN feature map does not half-fill its tiles)
// times a tile of 64 (or 32) output channels. It walks Cin in chunks of 16:
// per chunk it stages the halo tile of x (rounded to bf16 on load, zeros
// outside the image, so SAME padding is a predicate and not a padded copy
// of x) and the matching 9 x 16 x 64 slice of the weights in shared memory,
// then every warp runs bf16 tensor-core tiles (nvcuda::wmma 16x16x16,
// float32 accumulate): a warp's A tile for tap (dy, dx) is 16 neighbouring
// pixels of one halo row shifted by dx, its B tiles are the tap's 16 x 16
// weight blocks. Each warp keeps 2 pixel rows x 4 channel blocks of
// accumulators in registers and applies scale, bias, ReLU and the cast from
// registers through a 1 KB per-warp staging tile. The weights are first
// rewritten once per call by a small kernel into bf16 with Cin padded to 16
// and Cout to the channel tile, zero filled, so ragged Cin (1) and Cout (24)
// need guards only at the loads of x and the stores of y.
//
// Bound. At the production shapes the function is bound by the tensor-core
// rate for Cin, Cout >= 128 and by bytes below (x read once, y written
// once). This kernel is a first, simple version and sits well above either
// bound: synchronous loads into shared memory (no cp.async/TMA pipeline),
// mma.sync-class tiles instead of wgmma, a 2-way bank conflict on the A
// tiles, and x read again for every tile of 64 output channels. Those are
// the redesign's work; the arithmetic and the contract stay.

#include <cstdint>
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

// x, y (B, H, W, Cin / Cout) contiguous, float32 (x_is_bf16 = 0) or bf16;
// w (3, 3, Cin, Cout), scale, bias (Cout,) float32; wp: scratch of
// 9 * cin_pad * cout_pad bf16, where cin_pad rounds Cin up to 16 and
// cout_pad rounds Cout up to `cout_tile` (32 or 64). Launches on `stream`;
// returns the first CUDA error, 0 if none.
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
