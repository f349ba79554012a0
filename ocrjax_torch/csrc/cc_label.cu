// Fixed-sweep 8-connected component labeling for Hopper (sm_90a).
//
// Replaces the TPU kernel
// ocrjax/ops/pallas/cc_label.py::label_components_pallas
// (body _ccl_kernel, helpers _seg_scan_dir, _run_min, _neighbor_min). It
// computes exactly what ocrjax_torch.ops.cc_label.label_components_torch
// computes, bit for bit: labels start as the linear pixel index on
// foreground and 2**30 on background, then each of `n_iters` sweeps does
//   1. a segmented run-min along every row,
//   2. the same along every column,
//   3. a 3x3 neighbourhood min, out of place in effect.
// It is NOT a converged CCL: union-find would give other labels wherever a
// component needs more than n_iters sweeps, and the box extractor relies on
// the fixed-sweep labels.
//
// Three kernels; ocrjax_torch/ops/cc_label.py picks (ccl_path, a pure
// function of H and W) and this file checks the choice again.
//
// Shared path (cc_label_shared_kernel): grids of at most 65,535 pixels, the
// 240x240 and 128x128 grids of the OCR lanes among them. The labels live in
// the block's shared memory for all sweeps as uint16 linear indices with
// 0xFFFF as background; the bitmap is read once from global memory and the
// int32 labels (0xFFFF -> 2**30) are written once, which is all the traffic
// the byte bound counts. Byte budget: one buffer of H x Ws x 2 B, Ws = W
// rounded up to 8 so that a row is a whole number of 16-byte chunks of 8
// pixels (padding pixels are background): 115,200 B at 240x240, at most
// 147,456 B (kMaxChunks chunks), of the 232,448 B a block may use. A second
// uint16 buffer would fit at 240x240 (230,400 B) but not at 255x257, and an
// int32 buffer doubles the shared-memory traffic, so there is one uint16
// buffer and the 3x3 min goes through registers: every thread computes the
// 3x3 mins of its chunks (at most kMaxChunksPerThread x 8 pixels, packed in
// pairs), the block synchronises, then every thread writes them back, so a
// sweep can never hop more than one pixel diagonally.
//   Rows: a warp takes a row, a lane 8 consecutive pixels in registers. The
// lane scans its pixels, the lanes combine (tail of the open run, "no
// background in my pixels") with a segmented shuffle scan, and the carry is
// applied in a second local pass: a forward scan gives every pixel its run's
// prefix min, the backward scan over those spreads the run's min. Rows wider
// than 256 pixels take several rounds with a carry between them.
//   Columns: one thread walks two neighbouring columns as one packed 32-bit
// word of shared memory (__vminu2), loads batched 8 rows ahead of the
// dependent min chain so that a step costs a few cycles, not a round trip.
// That is the simple choice of the two (row bands with carries would use
// more than Ws/2 threads); the column phase is a few microseconds a sweep.
//   3x3: per chunk three 16-byte row loads and six halfword neighbour loads,
// vertical then horizontal packed mins.
//
// Cluster path (cc_label_cluster_kernel): the grids past the shared path,
// the C5 tile grids (512x512, 512x192, 448x512, 448x192) among them, where
// int32 labels are needed (1 MiB at 512x512: more than one SM's shared
// memory). A thread-block cluster of 8 CTAs labels one grid, each CTA a band
// of ceil(H / 8) rows that stays in its shared memory as uint32 labels for
// all sweeps (147,456 B at 512x512 with the padding, plus two halo and
// three summary rows); the bitmap is read once (16-byte loads) and the
// labels written once (16-byte stores). A pass never waits on device
// memory:
//   Rows are local to a band: a warp a row, the whole row in registers (at
// most 2 rounds of 512 pixels, 16 consecutive pixels a lane, read as four
// 16-byte words; 4 words of padding after every 32 pixels of a row keep
// those reads free of bank conflicts), seg_scan_warp's segmented shuffle
// scan on 32-bit labels with a carry from round to round.
//   Columns cross bands: a thread walks its column of the band forward and
// back (coalesced across the warp), then publishes the min of its top run
// if that run touches the band's first row, the min of its bottom run if it
// touches the last row, and whether the band column is all foreground.
// After cluster.sync() a CTA reads its neighbours' summaries through
// distributed shared memory, walking up through full bands to the first
// that is not and down likewise, and applies the two carries to its own top
// and bottom runs; interior runs need none. Each pass gives a pixel the min
// over its maximal run, and a min does not depend on the order of combining,
// so the labels are the plain version's bit for bit.
//   3x3: a horizontal 3-min in place (a warp a row in registers; bit 31
// keeps "the centre is background"), the band's first and last rows of it
// copied to halo rows; cluster.sync(); a vertical 3-min down each column
// with the neighbours' halo rows above and below. The halos are copies, so
// no CTA overwrites a row a neighbour is still reading. Two cluster barriers
// a sweep and one before exit, since a CTA's shared memory must outlive its
// neighbours' reads.
//
// Global path (cc_label_kernel): any H, W, for grids neither of the others
// takes (the port's first kernel, kept as it was). Labels live in
// a global int32 buffer (the output); the 3x3 min writes a second global
// buffer (scratch) and the two swap roles. One thread walks one row (or
// column) in place: after the forward walk each pixel holds its run's prefix
// min, and the backward walk spreads the run's min over the run.
//
// Bound. On a C5 window (two 512x512 grids) the function must read
// 2 x 262,144 B of bitmap and write 2 x 1 MiB of labels: 2.6 MB, under a
// microsecond at 3.35 TB/s; the cluster path is bound by the latency of
// its passes inside the SMs (the row pass's shuffle scans first, then the
// column walks of R dependent steps), its 2 n_iters + 1 cluster barriers
// and the launch.
// On the main path (16 pages of 240x240 per fused chunk, one launch
// per chunk) the function must read 16 x 57,600 B of bitmap and write
// 16 x 230,400 B of labels: 4.6 MB, about 1.4 us at 3.35 TB/s, which is less
// than an empty kernel launch takes, so no design reaches it; the shared
// path is bound by its 16 blocks' shared-memory work and by the launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 1 << 30;

__global__ void cc_label_kernel(const uint8_t* __restrict__ bitmap,
                                int32_t* __restrict__ labels,
                                int32_t* __restrict__ scratch,
                                int H, int W, int n_iters) {
  const int64_t page = static_cast<int64_t>(blockIdx.x) * H * W;
  const uint8_t* fg = bitmap + page;
  int32_t* lab = labels + page;
  int32_t* tmp = scratch + page;
  const int n = H * W;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int p = tid; p < n; p += nt) lab[p] = fg[p] ? p : kBig;
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // 1. run-min along rows: one thread walks one row
    for (int y = tid; y < H; y += nt) {
      int32_t* row = lab + static_cast<int64_t>(y) * W;
      int32_t run = kBig;
      for (int x = 0; x < W; ++x) {
        const int32_t v = row[x];
        run = (v >= kBig) ? kBig : min(run, v);
        row[x] = run;
      }
      run = kBig;
      for (int x = W - 1; x >= 0; --x) {
        const int32_t v = row[x];
        run = (v >= kBig) ? kBig : min(run, v);
        row[x] = run;
      }
    }
    __syncthreads();
    // 2. run-min along columns: one thread walks one column (coalesced)
    for (int x = tid; x < W; x += nt) {
      int32_t run = kBig;
      for (int y = 0; y < H; ++y) {
        const int32_t v = lab[y * W + x];
        run = (v >= kBig) ? kBig : min(run, v);
        lab[y * W + x] = run;
      }
      run = kBig;
      for (int y = H - 1; y >= 0; --y) {
        const int32_t v = lab[y * W + x];
        run = (v >= kBig) ? kBig : min(run, v);
        lab[y * W + x] = run;
      }
    }
    __syncthreads();
    // 3. 3x3 min, out of place; background stays kBig
    for (int p = tid; p < n; p += nt) {
      const int32_t c = lab[p];
      int32_t m = kBig;
      if (c < kBig) {
        const int y = p / W;
        const int x = p - y * W;
        const int y0 = max(y - 1, 0), y1 = min(y + 1, H - 1);
        const int x0 = max(x - 1, 0), x1 = min(x + 1, W - 1);
        for (int yy = y0; yy <= y1; ++yy)
          for (int xx = x0; xx <= x1; ++xx) m = min(m, lab[yy * W + xx]);
      }
      tmp[p] = m;
    }
    __syncthreads();
    int32_t* swap = lab;
    lab = tmp;
    tmp = swap;
  }

  // an odd number of sweeps leaves the result in scratch
  if (lab != labels + page) {
    for (int p = tid; p < n; p += nt) tmp[p] = lab[p];
  }
}


// ---------------------------------------------------------------------------
// Shared-memory path
// ---------------------------------------------------------------------------

constexpr int kSharedThreads = 1024;
constexpr int kMaxChunksPerThread = 9;
constexpr int kMaxChunks = kSharedThreads * kMaxChunksPerThread;
constexpr int kMaxSharedPixels = 65535;
constexpr uint32_t kBg = 0xFFFFu;          // background, one pixel
constexpr uint32_t kBg2 = 0xFFFFFFFFu;     // background, a packed pair
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ void unpack8(const uint4& q, uint32_t (&v)[8]) {
  v[0] = q.x & kBg; v[1] = q.x >> 16;
  v[2] = q.y & kBg; v[3] = q.y >> 16;
  v[4] = q.z & kBg; v[5] = q.z >> 16;
  v[6] = q.w & kBg; v[7] = q.w >> 16;
}

__device__ __forceinline__ uint4 pack8(const uint32_t (&v)[8]) {
  return make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                    v[4] | (v[5] << 16), v[6] | (v[7] << 16));
}

// Inclusive segmented min-scan over the 256 pixels a warp holds (8 a lane),
// toward higher indices or, with REV, toward lower ones. Background pixels
// break the runs and stay background. `carry` is the min of the run that is
// open where the scan enters the warp's pixels (kBg if none) and comes back
// as the one open where it leaves them.
template <bool REV>
__device__ __forceinline__ void seg_scan_warp(uint32_t (&v)[8],
                                              uint32_t& carry, int lane) {
  // the lane's own pixels: min of the run open at their end, and whether
  // no background pixel broke it
  uint32_t tail = kBg;
  uint32_t open = 1u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t x = v[REV ? 7 - i : i];
    const bool bg = x == kBg;
    tail = bg ? kBg : min(tail, x);
    open = bg ? 0u : open;
  }
  // inclusive scan of (tail, open) over the lanes in scan order
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t mine = tail | (open << 16);
    const uint32_t got = REV ? __shfl_down_sync(kFullMask, mine, d)
                             : __shfl_up_sync(kFullMask, mine, d);
    const bool valid = REV ? (lane + d < 32) : (lane >= d);
    if (valid) {
      if (open) tail = min(tail, got & kBg);
      open &= got >> 16;
    }
  }
  const uint32_t incl = tail | (open << 16);
  // what enters this lane: the scan of the lanes before it, then the carry
  uint32_t before = REV ? __shfl_down_sync(kFullMask, incl, 1)
                        : __shfl_up_sync(kFullMask, incl, 1);
  if (lane == (REV ? 31 : 0)) before = kBg | (1u << 16);
  uint32_t run = before & kBg;
  if (before >> 16) run = min(run, carry);
  // what leaves the warp's pixels
  const uint32_t last = __shfl_sync(kFullMask, incl, REV ? 0 : 31);
  carry = (last >> 16) ? min(last & kBg, carry) : (last & kBg);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = REV ? 7 - i : i;
    run = (v[j] == kBg) ? kBg : min(run, v[j]);
    v[j] = run;
  }
}

// One step of a packed column walk: run-min of two neighbouring columns.
__device__ __forceinline__ uint32_t col_step(uint32_t run, uint32_t v) {
  return __vminu2(run, v) | __vcmpeq2(v, kBg2);
}

__global__ void __launch_bounds__(kSharedThreads, 1)
cc_label_shared_kernel(const uint8_t* __restrict__ bitmap,
                       int32_t* __restrict__ labels, int H, int W, int Ws,
                       int n_iters, int vec_in, int vec_out) {
  extern __shared__ uint4 lab_q[];           // H x Ws uint16, 16-byte chunks
  uint16_t* lab = reinterpret_cast<uint16_t*>(lab_q);
  uint32_t* lab2 = reinterpret_cast<uint32_t*>(lab_q);
  const int64_t page = static_cast<int64_t>(blockIdx.x) * H * W;
  const uint8_t* fg = bitmap + page;
  int32_t* out = labels + page;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nchunks = Ws >> 3;               // chunks in a row
  const int total = H * nchunks;             // chunks in the page
  const int half = Ws >> 1;                  // packed pairs in a row

  // the bitmap, read once: label = linear index on foreground
  for (int k = tid; k < total; k += kSharedThreads) {
    const int y = k / nchunks;
    const int x0 = (k - y * nchunks) << 3;
    const uint8_t* src = fg + y * W + x0;
    uint32_t v[8];
    if (vec_in) {
      const uint2 b = *reinterpret_cast<const uint2*>(src);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t byte = ((i < 4 ? b.x : b.y) >> (8 * (i & 3))) & 0xFFu;
        v[i] = byte ? static_cast<uint32_t>(y * W + x0 + i) : kBg;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = (x0 + i < W && src[i]) ? static_cast<uint32_t>(y * W + x0 + i)
                                      : kBg;
    }
    lab_q[k] = pack8(v);
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // 1. run-min along rows: a warp a row, a lane 8 pixels
    for (int y = warp; y < H; y += kSharedThreads / 32) {
      uint4* row = lab_q + y * nchunks;
      uint32_t v[8];
      if (nchunks <= 32) {
        const bool mine = lane < nchunks;
        unpack8(mine ? row[lane] : make_uint4(kBg2, kBg2, kBg2, kBg2), v);
        uint32_t carry = kBg;
        seg_scan_warp<false>(v, carry, lane);
        carry = kBg;
        seg_scan_warp<true>(v, carry, lane);
        if (mine) row[lane] = pack8(v);
      } else {
        const int rounds = (nchunks + 31) >> 5;
        uint32_t carry = kBg;
        for (int r = 0; r < rounds; ++r) {
          const int c = (r << 5) + lane;
          const bool mine = c < nchunks;
          unpack8(mine ? row[c] : make_uint4(kBg2, kBg2, kBg2, kBg2), v);
          seg_scan_warp<false>(v, carry, lane);
          if (mine) row[c] = pack8(v);
        }
        carry = kBg;
        for (int r = rounds - 1; r >= 0; --r) {
          const int c = (r << 5) + lane;
          const bool mine = c < nchunks;
          unpack8(mine ? row[c] : make_uint4(kBg2, kBg2, kBg2, kBg2), v);
          seg_scan_warp<true>(v, carry, lane);
          if (mine) row[c] = pack8(v);
        }
      }
    }
    __syncthreads();

    // 2. run-min along columns: a thread two packed columns, loads batched
    for (int t = tid; t < half; t += kSharedThreads) {
      uint32_t* col = lab2 + t;
      uint32_t run = kBg2;
      int y = 0;
      for (; y + 8 <= H; y += 8) {
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = col[(y + i) * half];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          run = col_step(run, v[i]);
          col[(y + i) * half] = run;
        }
      }
      for (; y < H; ++y) {
        run = col_step(run, col[y * half]);
        col[y * half] = run;
      }
      run = kBg2;
      y = H - 1;
      for (; y >= 7; y -= 8) {
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = col[(y - i) * half];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          run = col_step(run, v[i]);
          col[(y - i) * half] = run;
        }
      }
      for (; y >= 0; --y) {
        run = col_step(run, col[y * half]);
        col[y * half] = run;
      }
    }
    __syncthreads();

    // 3. 3x3 min into registers, then back: out of place in effect
    uint4 keep[kMaxChunksPerThread];
#pragma unroll
    for (int j = 0; j < kMaxChunksPerThread; ++j) {
      const int k = j * kSharedThreads + tid;
      if (k < total) {
        const int y = k / nchunks;
        const int c = k - y * nchunks;
        const uint4 centre = lab_q[k];
        uint4 m = centre;
        uint32_t left = kBg, right = kBg;    // columns 8c - 1 and 8c + 8
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          const int yy = y + dy;
          if (yy < 0 || yy >= H) continue;
          const uint16_t* r16 = lab + yy * Ws + (c << 3);
          if (dy != 0) {
            const uint4 q = lab_q[yy * nchunks + c];
            m.x = __vminu2(m.x, q.x);
            m.y = __vminu2(m.y, q.y);
            m.z = __vminu2(m.z, q.z);
            m.w = __vminu2(m.w, q.w);
          }
          if (c > 0) left = min(left, static_cast<uint32_t>(r16[-1]));
          if (c + 1 < nchunks)
            right = min(right, static_cast<uint32_t>(r16[8]));
        }
        // m: vertical mins of the chunk's 8 columns; now the horizontal min
        // with the columns one to the left and one to the right
        uint4 o;
        o.x = __vminu2(m.x, __vminu2((m.x << 16) | left,
                                     __funnelshift_r(m.x, m.y, 16)));
        o.y = __vminu2(m.y, __vminu2(__funnelshift_l(m.x, m.y, 16),
                                     __funnelshift_r(m.y, m.z, 16)));
        o.z = __vminu2(m.z, __vminu2(__funnelshift_l(m.y, m.z, 16),
                                     __funnelshift_r(m.z, m.w, 16)));
        o.w = __vminu2(m.w, __vminu2(__funnelshift_l(m.z, m.w, 16),
                                     (m.w >> 16) | (right << 16)));
        // background stays background
        o.x |= __vcmpeq2(centre.x, kBg2);
        o.y |= __vcmpeq2(centre.y, kBg2);
        o.z |= __vcmpeq2(centre.z, kBg2);
        o.w |= __vcmpeq2(centre.w, kBg2);
        keep[j] = o;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxChunksPerThread; ++j) {
      const int k = j * kSharedThreads + tid;
      if (k < total) lab_q[k] = keep[j];
    }
    __syncthreads();
  }

  // the labels, written once
  for (int k = tid; k < total; k += kSharedThreads) {
    const int y = k / nchunks;
    const int x0 = (k - y * nchunks) << 3;
    uint32_t v[8];
    unpack8(lab_q[k], v);
    int32_t o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = v[i] == kBg ? kBig : static_cast<int32_t>(v[i]);
    int32_t* dst = out + y * W + x0;
    if (vec_out) {
      reinterpret_cast<int4*>(dst)[0] = make_int4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<int4*>(dst)[1] = make_int4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (x0 + i < W) dst[i] = o[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Cluster path
// ---------------------------------------------------------------------------

constexpr int kClusterSize = 8;            // CTAs a grid (portable size)
constexpr int kClusterThreads = 512;
constexpr int kLanePixels = 16;            // row passes: pixels a lane
constexpr int kMaxRounds = 2;              // row passes: 512 pixels a round
constexpr int kMaxClusterWidth = kMaxRounds * 32 * kLanePixels;
constexpr int kMaxClusterBytes = 232448;
constexpr int kMaxDevices = 64;
constexpr uint32_t kBig32 = static_cast<uint32_t>(kBig);
constexpr uint32_t kBgBit = 0x80000000u;   // 3x3 pass: centre is background
constexpr uint32_t kLow = 0x7FFFFFFFu;

// Where pixel x of a row lies in the row's shared memory: 4 words of
// padding follow every 32 pixels, so that the 32 lanes of a row pass, each
// reading 16 consecutive pixels as four 16-byte words, hit the 8 bank
// groups of every quarter-warp once (without the padding lanes 0, 2, 4, 6
// meet in one group), while 32 consecutive pixels stay 32 consecutive
// words for the column passes.
__device__ __forceinline__ int sx(int x) { return x + ((x >> 5) << 2); }

// Inclusive segmented min-scan along the 512 pixels a warp holds in one
// round (16 consecutive pixels a lane, lanes in pixel order), toward
// higher indices or, with REV, toward lower ones: seg_scan_warp above with
// 32-bit labels, a label >= kBig32 being background. The open flag rides
// in bit 31 of the shuffled word (a tail is at most kBig32 = 2**30).
template <bool REV>
__device__ __forceinline__ void seg_scan_warp32(uint32_t (&v)[kLanePixels],
                                                uint32_t& carry, int lane) {
  uint32_t tail = kBig32;
  uint32_t open = 1u;
#pragma unroll
  for (int i = 0; i < kLanePixels; ++i) {
    const uint32_t x = v[REV ? kLanePixels - 1 - i : i];
    const bool bg = x >= kBig32;
    tail = bg ? kBig32 : min(tail, x);
    open = bg ? 0u : open;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t mine = tail | (open << 31);
    const uint32_t got = REV ? __shfl_down_sync(kFullMask, mine, d)
                             : __shfl_up_sync(kFullMask, mine, d);
    const bool valid = REV ? (lane + d < 32) : (lane >= d);
    if (valid) {
      if (open) tail = min(tail, got & kLow);
      open &= got >> 31;
    }
  }
  const uint32_t incl = tail | (open << 31);
  uint32_t before = REV ? __shfl_down_sync(kFullMask, incl, 1)
                        : __shfl_up_sync(kFullMask, incl, 1);
  if (lane == (REV ? 31 : 0)) before = kBig32 | kBgBit;
  uint32_t run = before & kLow;
  if (before >> 31) run = min(run, carry);
  const uint32_t last = __shfl_sync(kFullMask, incl, REV ? 0 : 31);
  carry = (last >> 31) ? min(last & kLow, carry) : (last & kLow);
#pragma unroll
  for (int i = 0; i < kLanePixels; ++i) {
    const int j = REV ? kLanePixels - 1 - i : i;
    run = (v[j] >= kBig32) ? kBig32 : min(run, v[j]);
    v[j] = run;
  }
}

__device__ __forceinline__ int band_rows(int rank, int R, int H) {
  const int r = H - rank * R;
  return r <= 0 ? 0 : (r < R ? r : R);
}

// A row of the band into registers: round j, lane l holds pixels
// 512 j + 16 l .. + 15 (background past the row's end).
__device__ __forceinline__ void load_row(const uint32_t* row,
                                         uint32_t (&v)[kMaxRounds]
                                                      [kLanePixels],
                                         int Ws, int lane) {
#pragma unroll
  for (int j = 0; j < kMaxRounds; ++j) {
    const int x0 = j * 32 * kLanePixels + lane * kLanePixels;
    const bool mine = x0 < Ws;
    const uint4* src = reinterpret_cast<const uint4*>(row + sx(x0));
#pragma unroll
    for (int q = 0; q < kLanePixels / 4; ++q) {
      const uint4 w = mine ? src[q] : make_uint4(kBig32, kBig32, kBig32,
                                                 kBig32);
      v[j][4 * q] = w.x; v[j][4 * q + 1] = w.y;
      v[j][4 * q + 2] = w.z; v[j][4 * q + 3] = w.w;
    }
  }
}

__device__ __forceinline__ void store_pixels(uint32_t* row,
                                             const uint32_t (&v)[kLanePixels],
                                             int x0) {
  uint4* dst = reinterpret_cast<uint4*>(row + sx(x0));
#pragma unroll
  for (int q = 0; q < kLanePixels / 4; ++q)
    dst[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// One cluster of kClusterSize CTAs labels one grid; CTA `rank` keeps rows
// [rank * R, rank * R + rows) as uint32 labels in its shared memory for all
// sweeps (rows of Ws pixels, a multiple of 16, padding is background; Wp
// words a row with sx's padding), then two rows of Wp words (the 3x3
// pass's first and last horizontal-min rows, the halos its neighbours
// read) and three of Ws words (the column pass's summaries: min of the top
// run, min of the bottom run, "no background in the band column").
__global__ void __launch_bounds__(kClusterThreads, 1)
cc_label_cluster_kernel(const uint8_t* __restrict__ bitmap,
                        int32_t* __restrict__ labels, int H, int W, int Ws,
                        int Wp, int R, int n_iters, int vec_in, int vec_out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint4 cl_q[];
  uint32_t* lab = reinterpret_cast<uint32_t*>(cl_q);
  uint32_t* halo_top = lab + R * Wp;
  uint32_t* halo_bot = halo_top + Wp;
  uint32_t* sum_top = halo_bot + Wp;
  uint32_t* sum_bot = sum_top + Ws;
  uint32_t* sum_full = sum_bot + Ws;
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t page = static_cast<int64_t>(blockIdx.x / kClusterSize) * H * W;
  const int r0 = rank * R;
  const int rows = band_rows(rank, R, H);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kClusterThreads / 32;
  const int rounds = (Ws + 32 * kLanePixels - 1) / (32 * kLanePixels);
  const bool has_up = rank > 0;
  const bool has_down = rank + 1 < kClusterSize &&
                        band_rows(rank + 1, R, H) > 0;

  // the band of the bitmap, read once: label = linear index on foreground
  const uint8_t* fg = bitmap + page + static_cast<int64_t>(r0) * W;
  if (vec_in) {                             // W % 16 == 0, 16-byte aligned
    const int per_row = W >> 4;
    for (int g = tid; g < rows * per_row; g += kClusterThreads) {
      const int y = g / per_row;
      const int x0 = (g - y * per_row) << 4;
      const uint4 b = reinterpret_cast<const uint4*>(fg)[g];
      const uint32_t words[4] = {b.x, b.y, b.z, b.w};
      const uint32_t base = static_cast<uint32_t>((r0 + y) * W + x0);
      uint32_t o[kLanePixels];
#pragma unroll
      for (int i = 0; i < kLanePixels; ++i)
        o[i] = ((words[i >> 2] >> (8 * (i & 3))) & 0xFFu) ? base + i
                                                           : kBig32;
      store_pixels(lab + y * Wp, o, x0);
    }
  } else {
    for (int p = tid; p < rows * Ws; p += kClusterThreads) {
      const int y = p / Ws;
      const int x = p - y * Ws;
      lab[y * Wp + sx(x)] = (x < W && fg[y * W + x])
          ? static_cast<uint32_t>((r0 + y) * W + x) : kBig32;
    }
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // 1. run-min along rows, local to the band: a warp a row, the whole row
    // in registers, 16 consecutive pixels a lane
    for (int y = warp; y < rows; y += kWarps) {
      uint32_t* row = lab + y * Wp;
      uint32_t v[kMaxRounds][kLanePixels];
      load_row(row, v, Ws, lane);
      uint32_t carry = kBig32;
#pragma unroll
      for (int j = 0; j < kMaxRounds; ++j)
        if (j < rounds) seg_scan_warp32<false>(v[j], carry, lane);
      carry = kBig32;
#pragma unroll
      for (int jj = 0; jj < kMaxRounds; ++jj) {
        const int j = kMaxRounds - 1 - jj;
        if (j < rounds) seg_scan_warp32<true>(v[j], carry, lane);
      }
#pragma unroll
      for (int j = 0; j < kMaxRounds; ++j) {
        const int x0 = j * 32 * kLanePixels + lane * kLanePixels;
        if (x0 < Ws) store_pixels(row, v[j], x0);
      }
    }
    __syncthreads();

    // 2. run-min along columns. Band-local first: a thread a column, a
    // forward walk (prefix mins) and a backward one (run mins); then the
    // band's summaries for its neighbours
    for (int x = tid; x < W; x += kClusterThreads) {
      uint32_t* col = lab + sx(x);
      uint32_t run = kBig32;
      uint32_t full = 1u;
      int y = 0;
      for (; y + 8 <= rows; y += 8) {
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = col[(y + i) * Wp];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool bg = v[i] >= kBig32;
          run = bg ? kBig32 : min(run, v[i]);
          full = bg ? 0u : full;
          col[(y + i) * Wp] = run;
        }
      }
      for (; y < rows; ++y) {
        const uint32_t v = col[y * Wp];
        const bool bg = v >= kBig32;
        run = bg ? kBig32 : min(run, v);
        full = bg ? 0u : full;
        col[y * Wp] = run;
      }
      sum_bot[x] = run;
      run = kBig32;
      y = rows - 1;
      for (; y >= 7; y -= 8) {
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = col[(y - i) * Wp];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          run = v[i] >= kBig32 ? kBig32 : min(run, v[i]);
          col[(y - i) * Wp] = run;
        }
      }
      for (; y >= 0; --y) {
        const uint32_t v = col[y * Wp];
        run = v >= kBig32 ? kBig32 : min(run, v);
        col[y * Wp] = run;
      }
      sum_top[x] = run;
      sum_full[x] = rows > 0 ? full : 0u;
    }
    cluster.sync();
    // the runs that cross band boundaries: walk up through full bands to
    // the first band that is not full, down the same way, and apply the two
    // carries to the band's own top and bottom runs (interior runs need
    // none)
    for (int x = tid; x < W && rows > 0; x += kClusterThreads) {
      uint32_t up = kBig32;
      for (int j = rank - 1; j >= 0; --j) {
        up = min(up, cluster.map_shared_rank(sum_bot, j)[x]);
        if (!cluster.map_shared_rank(sum_full, j)[x]) break;
      }
      uint32_t down = kBig32;
      for (int j = rank + 1; j < kClusterSize; ++j) {
        if (band_rows(j, R, H) == 0) break;
        down = min(down, cluster.map_shared_rank(sum_top, j)[x]);
        if (!cluster.map_shared_rank(sum_full, j)[x]) break;
      }
      uint32_t* col = lab + sx(x);
      if (up < kBig32)
        for (int y = 0; y < rows && col[y * Wp] < kBig32; ++y)
          col[y * Wp] = min(col[y * Wp], up);
      if (down < kBig32)
        for (int y = rows - 1; y >= 0 && col[y * Wp] < kBig32; --y)
          col[y * Wp] = min(col[y * Wp], down);
    }
    __syncthreads();

    // 3. 3x3 min as a horizontal 3-min along rows (in place, a warp a row
    // in registers) and a vertical 3-min along columns. The horizontal mins
    // keep the centre's background in bit 31; the band's first and last
    // rows of them also go to the halo rows that the neighbours read.
    for (int y = warp; y < rows; y += kWarps) {
      uint32_t* row = lab + y * Wp;
      uint32_t v[kMaxRounds][kLanePixels];
      load_row(row, v, Ws, lane);
#pragma unroll
      for (int j = 0; j < kMaxRounds; ++j) {
        if (j >= rounds) continue;
        // the pixel left of the lane's first and right of its last
        constexpr int L = kLanePixels - 1;
        uint32_t left = __shfl_up_sync(kFullMask, v[j][L], 1);
        const uint32_t wrap_l = __shfl_sync(
            kFullMask, j > 0 ? v[j > 0 ? j - 1 : 0][L] : kBig32, 31);
        if (lane == 0) left = wrap_l;
        uint32_t right = __shfl_down_sync(kFullMask, v[j][0], 1);
        const uint32_t wrap_r = __shfl_sync(
            kFullMask,
            j + 1 < rounds ? v[j + 1 < kMaxRounds ? j + 1 : j][0] : kBig32,
            0);
        if (lane == 31) right = wrap_r;
        uint32_t h[kLanePixels];
#pragma unroll
        for (int i = 0; i < kLanePixels; ++i) {
          const uint32_t a = i > 0 ? v[j][i > 0 ? i - 1 : 0] : left;
          const uint32_t c = i < L ? v[j][i < L ? i + 1 : L] : right;
          h[i] = min(a, min(v[j][i], c)) |
                 (v[j][i] >= kBig32 ? kBgBit : 0u);
        }
        const int x0 = j * 32 * kLanePixels + lane * kLanePixels;
        if (x0 < Ws) {
          store_pixels(row, h, x0);
          if (y == 0) store_pixels(halo_top, h, x0);
          if (y == rows - 1) store_pixels(halo_bot, h, x0);
        }
      }
    }
    cluster.sync();
    for (int x = tid; x < W && rows > 0; x += kClusterThreads) {
      uint32_t* col = lab + sx(x);
      uint32_t prev = has_up
          ? cluster.map_shared_rank(halo_bot, rank - 1)[sx(x)] & kLow
          : kBig32;
      const uint32_t below = has_down
          ? cluster.map_shared_rank(halo_top, rank + 1)[sx(x)] & kLow
          : kBig32;
      // 8 rows at a time, and the row after them, loaded ahead of the
      // stores (which touch only the 8)
      for (int y0 = 0; y0 < rows; y0 += 8) {
        uint32_t c[9];
#pragma unroll
        for (int i = 0; i < 9; ++i)
          c[i] = y0 + i < rows ? col[(y0 + i) * Wp] : below;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (y0 + i < rows) {
            const uint32_t h = c[i] & kLow;
            const uint32_t m = min(prev, min(h, c[i + 1] & kLow));
            col[(y0 + i) * Wp] = (c[i] & kBgBit) ? kBig32 : m;
            prev = h;
          }
        }
      }
    }
    __syncthreads();
  }

  // the labels, written once
  int32_t* out = labels + page + static_cast<int64_t>(r0) * W;
  if (vec_out) {                            // W % 4 == 0, 16-byte aligned
    const int per_row = W >> 2;
    for (int g = tid; g < rows * per_row; g += kClusterThreads) {
      const int y = g / per_row;
      const int x0 = (g - y * per_row) << 2;
      const uint4 q =
          *reinterpret_cast<const uint4*>(lab + y * Wp + sx(x0));
      reinterpret_cast<int4*>(out)[g] =
          make_int4(static_cast<int32_t>(q.x), static_cast<int32_t>(q.y),
                    static_cast<int32_t>(q.z), static_cast<int32_t>(q.w));
    }
  } else {
    for (int p = tid; p < rows * W; p += kClusterThreads) {
      const int y = p / W;
      out[p] = static_cast<int32_t>(lab[y * Wp + sx(p - y * W)]);
    }
  }
  // a CTA's shared memory must outlive its neighbours' reads of it
  cluster.sync();
}

__global__ void empty_kernel() {}

}  // namespace

// bitmap (B, H, W) uint8, labels (B, H, W) int32, both contiguous on the
// device. path 1: the shared-memory kernel (H * W <= 65,535 and at most
// 9,216 chunks of 8 pixels in rows padded to 8; scratch is not read).
// path 2: the cluster kernel (rows padded to 16 at most 1,024 wide, and
// ((ceil(H / 8) + 2) x Wp + 3 x Ws) x 4 B of shared memory a CTA at most
// 232,448, Wp = Ws + 4 ceil(Ws / 32);
// scratch is not read); a configuration of which no cluster can be
// resident is an error. path 0: the global-memory kernel, any size, with
// scratch (B, H, W) int32.
// Launches on `stream`; returns the first CUDA error, 0 if none.
extern "C" int ocj_cc_label(const void* bitmap, void* labels, void* scratch,
                            int B, int H, int W, int n_iters, int path,
                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const int Ws = (W + 7) / 8 * 8;
    const int64_t pixels = static_cast<int64_t>(H) * W;
    const int64_t chunks = static_cast<int64_t>(H) * (Ws / 8);
    if (pixels > kMaxSharedPixels || chunks > kMaxChunks)
      return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = static_cast<int>(chunks) * 16;
    cudaError_t err = cudaFuncSetAttribute(
        cc_label_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int vec_in =
        W % 8 == 0 && reinterpret_cast<uintptr_t>(bitmap) % 8 == 0;
    const int vec_out =
        W % 8 == 0 && reinterpret_cast<uintptr_t>(labels) % 16 == 0;
    cc_label_shared_kernel<<<B, kSharedThreads, bytes, s>>>(
        static_cast<const uint8_t*>(bitmap), static_cast<int32_t*>(labels), H,
        W, Ws, n_iters, vec_in, vec_out);
    return static_cast<int>(cudaGetLastError());
  }
  if (path == 2) {
    const int Ws = (W + 15) / 16 * 16;
    const int Wp = Ws + (Ws + 31) / 32 * 4;
    const int R = (H + kClusterSize - 1) / kClusterSize;
    const int64_t bytes =
        ((static_cast<int64_t>(R) + 2) * Wp + 3 * static_cast<int64_t>(Ws))
        * 4;
    if (Ws > kMaxClusterWidth || bytes > kMaxClusterBytes)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(kClusterSize * B, 1, 1);
    config.blockDim = dim3(kClusterThreads, 1, 1);
    config.dynamicSmemBytes = static_cast<size_t>(bytes);
    config.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterSize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    // once a device and size: the shared memory the kernel may take, and a
    // cluster that cannot be resident is an error, not a slow launch (a
    // larger size checked covers every smaller one)
    static int64_t checked[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (bytes > checked[dev]) {
      err = cudaFuncSetAttribute(cc_label_cluster_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, cc_label_cluster_kernel,
                                           &config);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (clusters == 0)
        return static_cast<int>(cudaErrorInvalidConfiguration);
      checked[dev] = bytes;
    }
    const int vec_in =
        W % 16 == 0 && reinterpret_cast<uintptr_t>(bitmap) % 16 == 0;
    const int vec_out =
        W % 4 == 0 && reinterpret_cast<uintptr_t>(labels) % 16 == 0;
    err = cudaLaunchKernelEx(&config, cc_label_cluster_kernel,
                             static_cast<const uint8_t*>(bitmap),
                             static_cast<int32_t*>(labels), H, W, Ws, Wp,
                             R, n_iters, vec_in, vec_out);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int longest = H > W ? H : W;
  int threads = ((longest + 31) / 32) * 32;
  if (threads < 256) threads = 256;
  if (threads > 1024) threads = 1024;
  cc_label_kernel<<<B, threads, 0, s>>>(
      static_cast<const uint8_t*>(bitmap), static_cast<int32_t*>(labels),
      static_cast<int32_t*>(scratch), H, W, n_iters);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on `stream`: what a launch alone costs on this card.
extern "C" int ocj_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
