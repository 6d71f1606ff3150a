// A shared-memory-tiled depthwise convolution for Hopper (sm_90a), NHWC,
// stride 1, f32 accumulation:
//
//   tiled_kernel<K, kBias, OutT, kCut, kAnyC>
//       bf16 x (B, H, W, C), f32 taps (K, K, C), optional f32 bias (C,)
//       -> OutT (B, Ho, Wo, C), zero padding pad_top / pad_left (the rest of
//       the padding follows from Ho, Wo); C a multiple of 32, or with kAnyC
//       any even C
//
// convnext_block.cu instantiates it as dwconv7x7_nhwc (K = 7, bias, f32 out,
// padding 3): the depthwise half of the TPU kernels fused_convnext_block and
// fused_ln_mlp_residual_batchlane (vip_cup_2022_tpu/ops/pallas/
// convnext_block.py, whose body _kernel hands the LN the unrounded f32 sum).
// depthwise.cu instantiates it as depthwise_conv_nhwc (K = 3, 5, 7, no bias,
// bf16 out, explicit asymmetric padding, kAnyC): the TPU kernel
// depthwise_conv_nhwc of vip_cup_2022_tpu/ops/pallas/depthwise.py.
//
// What bounds it on this card: the bytes (bf16 in, f32 out: 6 bytes an
// element, 0.43 ms at ConvNeXt s1 and batch 256), and close behind them the
// f32 FMAs (49 an element: 0.35 ms at s1 with every issue slot an FMA). So
// the design moves each input byte across the SM's port about twice and
// spends few instructions or registers besides the FMAs:
//
// - Tiles: a CTA owns a TH x TW output tile x kCB = 32 channels (64 bytes a
//   pixel; 32 divides 96 ... 768). With kAnyC the last slice may be a tail
//   (C = 336: 10 slices and 16 channels; C = 24 or 8: the tail alone): its
//   copies past C land zeros, the lanes past C load no taps and store
//   nothing, and each pixel's 64 bytes arrive as 16-, 8- or 4-byte copies,
//   whichever C's pixel stride allows. Its (TH + K - 1) x (TW + K - 1) halo is
//   copied into shared memory once by 16-byte cp.async, out-of-image chunks
//   zero-filled (the padding costs no branch in the FMA loop), so x crosses
//   from L2 (TH + 6)(TW + 6) / (TH TW) = 1.9 times at a 16 x 16 tile
//   instead of every thread fetching its own halo through L1.
// - Overlap: persistent CTAs walk the tiles with two halo buffers; the next
//   tile's copy is in flight while this one's FMAs run, and two CTAs share
//   an SM. The grid is a multiple of the channel slices, so a CTA keeps one
//   slice: each thread loads its channel's K x K taps and bias into
//   registers once.
// - Per thread: one channel (a warp covers the slice) x kR = 4 rows x kWt =
//   8 columns. Each halo row is read once per thread (K + 7 pixels, two
//   bytes each, converted to f32 once) and feeds every dx tap of every
//   output row it touches: 49 FMAs per output element against ~0.2 other
//   instructions, and no shared-memory read of a tap. A warp reads 64
//   consecutive bytes of one pixel at a time: no bank conflict.
// - Stores: a warp writes a pixel's 32 channels (128 bytes of f32, whole
//   sectors) per instruction; index math is 32-bit within an image.
//
// What bounds it as built: the FMA phase (about twice the FMAs' issue time
// at ConvNeXt s1); the kRegs cut, the same phase without its halo reads,
// shows what the 2-byte shared-memory reads (64 bytes a warp) cost there
// (PERF.md keeps the numbers). Tried on the H100 and dropped: two channels x
// 4 x 8 a thread with the taps read from shared memory (128 registers,
// spills); other tile shapes and row counts, an explicit prefetch of the
// next halo row, and another loop order (within 3 % of this); a
// channel-major f32 halo filled through registers, read 16 bytes at a time
// (slower: its fill cannot overlap the FMAs).
//
// The tile plan (plan(), below) is the same for every K: at k = 3 and 5 on
// small grids the tile covers the whole image, so the zero-filled halo costs
// no reads, only FMAs of outputs past the edge.
//
// kCut makes phase-cut instantiations for timing (csrc/dwconv_cuts.cu): kLoads
// (the halo copies only), kFmas (+ the shared-memory reads and the FMAs,
// nothing stored), kWhole (the kernel itself), kRegs (kFmas with the halo
// values made in registers: what the FMA phase costs without its reads).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "smem_grant.cuh"

namespace depthwise {

typedef __nv_bfloat16 bf16;

constexpr int kCB = 32;       // channels of a slice: 64 bytes of bf16 a pixel
constexpr int kPixel = kCB * 2;  // bytes of a pixel's slice in the halo
constexpr int kLanes = 32;    // threads of a slice: a warp, one channel each
constexpr int kWt = 8;        // output columns a thread owns
constexpr int kR = 4;         // output rows a thread owns
constexpr int kMaxStrips = 2;  // column strips (kWt wide) of a tile
constexpr int kMaxBlocks = 4;  // row blocks (kR high) of a tile
constexpr int kMaxThreads = kLanes * kMaxStrips * kMaxBlocks;  // 256
using smem_grant::kMaxDevices;

enum Cut : int {
  kLoads = 0,  // the halo copies only
  kFmas = 1,   // + the shared-memory reads and the FMAs, nothing stored
  kWhole = 2,  // + the stores: the kernel itself
  kRegs = 3,   // kFmas with the halo values made in registers, no shared-memory reads
};

struct Params {
  const bf16* x;
  const float* w;     // (K, K, C)
  const float* bias;  // (C,) or null
  void* out;          // (B, Ho, Wo, C)
  int H, W, C, Ho, Wo;
  int pad_top, pad_left;
  int strips, blocks;                  // a tile: strips x kWt columns, blocks x kR rows
  int tiles_w, tiles_h, slices, tiles;  // tiles = B * tiles_h * tiles_w * slices
  int vec;                              // bytes a halo copy moves: 16, 8 or 4 (kAnyC)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V bytes global -> shared; with ok false nothing is read and zeros land
template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(V),
                 "r"(ok ? V : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16(a); }

// halo geometry of a tile
__host__ __device__ constexpr int halo_cols(int strips, int k) { return strips * kWt + k - 1; }
__host__ __device__ constexpr int halo_rows(int blocks, int k) { return blocks * kR + k - 1; }
__host__ __device__ constexpr int buffer_bytes(int strips, int blocks, int k) {
  return halo_rows(blocks, k) * halo_cols(strips, k) * kPixel;
}
__host__ __device__ constexpr int smem_bytes(int strips, int blocks, int k) {
  return 2 * buffer_bytes(strips, blocks, k);
}

struct Tile {
  int b, h0, w0, c0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  Tile tl;
  tl.c0 = (t % p.slices) * kCB;
  int rest = t / p.slices;
  tl.w0 = (rest % p.tiles_w) * p.strips * kWt;
  rest /= p.tiles_w;
  tl.h0 = (rest % p.tiles_h) * p.blocks * kR;
  tl.b = rest / p.tiles_h;
  return tl;
}

// queue the halo of tile t into `buf`: kPixel / V chunks of V bytes a pixel;
// with kAnyC, chunks of channels past C land zeros
template <int K, int V, bool kAnyC>
__device__ __forceinline__ void load_halo(const Params& p, int t, uint32_t buf, uint32_t magic) {
  constexpr int kChunks = kPixel / V, kShift = V == 16 ? 2 : V == 8 ? 3 : 4;  // log2(kChunks)
  const Tile tl = tile_of(p, t);
  const int hc = halo_cols(p.strips, K);
  const int chunks = halo_rows(p.blocks, K) * hc * kChunks;
  const bf16* img = p.x + (long long)tl.b * p.H * p.W * p.C + tl.c0;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int pix = i >> kShift, q = i & (kChunks - 1);
    const int r = (int)__umulhi((uint32_t)pix, magic);  // pix / hc (exact at these sizes)
    const int c = pix - r * hc;
    const int h = tl.h0 - p.pad_top + r, w = tl.w0 - p.pad_left + c;
    const bool ok = (unsigned)h < (unsigned)p.H && (unsigned)w < (unsigned)p.W &&
                    (!kAnyC || tl.c0 + q * (V / 2) < p.C);
    const bf16* src = ok ? img + (h * p.W + w) * p.C + q * (V / 2) : p.x;
    cp_async<V>(buf + (uint32_t)(i * V), src, ok);  // pixel (r, c) at (r hc + c) 64 bytes
  }
}

template <int K, bool kAnyC>
__device__ __forceinline__ void queue_halo(const Params& p, int t, uint32_t buf, uint32_t magic) {
  if constexpr (!kAnyC) {
    load_halo<K, 16, false>(p, t, buf, magic);
  } else {
    if (p.vec == 16) load_halo<K, 16, true>(p, t, buf, magic);
    else if (p.vec == 8) load_halo<K, 8, true>(p, t, buf, magic);
    else load_halo<K, 4, true>(p, t, buf, magic);
  }
}

template <int K, bool kBias, typename OutT, int kCut, bool kAnyC>
__global__ void __launch_bounds__(kMaxThreads, 2) tiled_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int buf_bytes = buffer_bytes(p.strips, p.blocks, K);
  const int hc = halo_cols(p.strips, K);
  const uint32_t magic = (uint32_t)(0xffffffffu / (uint32_t)hc) + 1u;
  const uint32_t buf0 = smem_u32(smem);

  // this CTA's slice is fixed: the grid is a multiple of the slices, or one tile a CTA
  const int lane = threadIdx.x % kLanes, unit = threadIdx.x / kLanes;
  const int c = (blockIdx.x % p.slices) * kCB + lane;
  const bool live_c = !kAnyC || c < p.C;  // a tail slice's lanes past C: no taps, no stores
  float taps[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) taps[i] = live_c ? __ldg(p.w + i * p.C + c) : 0.f;
  const float bias = kBias && live_c ? __ldg(p.bias + c) : 0.f;
  const int oc0 = (unit % p.strips) * kWt, or0 = (unit / p.strips) * kR;

  int t = blockIdx.x;
  if (t < p.tiles) queue_halo<K, kAnyC>(p, t, buf0, magic);
  cp_async_commit();
  for (int k = 0; t < p.tiles; t += gridDim.x, ++k) {
    if (t + (int)gridDim.x < p.tiles)
      queue_halo<K, kAnyC>(p, t + gridDim.x, buf0 + ((k + 1) & 1) * buf_bytes, magic);
    cp_async_commit();
    cp_async_wait<1>();  // tile t's copies have landed (for this thread) ...
    __syncthreads();     // ... and for every thread
    const Tile tl = tile_of(p, t);
    if constexpr (kCut != kLoads) {
      if (tl.w0 + oc0 < p.Wo && tl.h0 + or0 < p.Ho) {  // the same for the whole warp
        const bf16* halo = reinterpret_cast<const bf16*>(smem + (k & 1) * buf_bytes) +
                           (or0 * hc + oc0) * kCB + lane;
        float acc[kR][kWt];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int j = 0; j < kWt; ++j) acc[r][j] = 0.f;
#pragma unroll
        for (int ir = 0; ir < kR + K - 1; ++ir) {
          float v[kWt + K - 1];
#pragma unroll
          for (int j = 0; j < kWt + K - 1; ++j) {
            if constexpr (kCut == kRegs)  // a value the compiler cannot fold, no read
              v[j] = __int_as_float(0x3c000000 + ((lane * 7 + ir * 3 + j) & 0xffff));
            else
              v[j] = __bfloat162float(halo[(ir * hc + j) * kCB]);
          }
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int dy = ir - r;
            if (dy < 0 || dy >= K) continue;
#pragma unroll
            for (int dx = 0; dx < K; ++dx)
#pragma unroll
              for (int j = 0; j < kWt; ++j)
                acc[r][j] = fmaf(v[j + dx], taps[dy * K + dx], acc[r][j]);
          }
        }
        OutT* img = static_cast<OutT*>(p.out) + (long long)tl.b * p.Ho * p.Wo * p.C + c;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int oh = tl.h0 + or0 + r;
#pragma unroll
          for (int j = 0; j < kWt; ++j) {
            const int ow = tl.w0 + oc0 + j;
            const float a = acc[r][j] + bias;
            if constexpr (kCut == kWhole) {
              if (oh < p.Ho && ow < p.Wo && live_c) store1(img + (oh * p.Wo + ow) * p.C, a);
            } else if (a == 1234.5678f) {  // keep the sums live
              store1(img, a);
            }
          }
        }
      }
    }
    __syncthreads();  // every read of this buffer is done before it is refilled
  }
  cp_async_wait<0>();
}

// CTAs an SM holds at each tile shape, found once per kernel and device (with
// the shared-memory carveout set to its maximum first). Like the grant it is
// a launcher's static that two libraries with one instantiation may share,
// so it remembers its kernel.
struct Occupancy {
  std::mutex mu;
  const void* kernel[kMaxDevices] = {};
  int ctas_per_sm[kMaxDevices][kMaxStrips + 1][kMaxBlocks + 1] = {};
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// tiles of at most kMaxStrips x kMaxBlocks warp units, split evenly over
// the output; one strip a tile where two would leave more than 1 in 12 of
// the strips idle. At ConvNeXt's 99 / 49 / 24 / 12 grids: 2 x 4 / 1 x 4 /
// 1 x 3 / 2 x 3 units (16 x 16 / 16 x 8 / 12 x 8 / 12 x 16 outputs), the
// fastest of the tile shapes timed on the H100 at each stage
inline void plan(Params& p) {
  const int nw = ceil_div(p.Wo, kWt), nh = ceil_div(p.Ho, kR);
  p.tiles_w = ceil_div(nw, kMaxStrips);
  p.strips = ceil_div(nw, p.tiles_w);
  if (p.strips > 1 && 12 * (p.tiles_w * p.strips - nw) > p.tiles_w * p.strips) {
    p.strips = 1;
    p.tiles_w = nw;
  }
  p.tiles_h = ceil_div(nh, kMaxBlocks);
  p.blocks = ceil_div(nh, p.tiles_h);
  p.slices = ceil_div(p.C, kCB);
  p.vec = p.C % 8 == 0 ? 16 : p.C % 4 == 0 ? 8 : 4;  // a pixel's stride, 2 C bytes, allows it
}

template <int K, bool kBias, typename OutT, int kCut, bool kAnyC>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
  static smem_grant::SmemGrant grant;
  static Occupancy occupancy;
  if (B <= 0 || p.Ho <= 0 || p.Wo <= 0 || p.C <= 0) return cudaSuccess;
  if ((kAnyC ? p.C % 2 : p.C % kCB) || (long long)p.H * p.W * p.C >= (1LL << 31) ||
      (long long)p.Ho * p.Wo * p.C >= (1LL << 31))
    return cudaErrorInvalidValue;
  plan(p);
  const long long tiles = (long long)B * p.tiles_h * p.tiles_w * p.slices;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const int threads = kLanes * p.strips * p.blocks;
  const int smem = smem_bytes(p.strips, p.blocks, K);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const void* kernel = (const void*)tiled_kernel<K, kBias, OutT, kCut, kAnyC>;
  err = smem_grant::grant_smem(kernel, smem, grant, dev);
  if (err != cudaSuccess) return err;
  int occ = 0;
  {
    std::lock_guard<std::mutex> lock(occupancy.mu);
    if (occupancy.kernel[dev] != kernel) {  // another library's copy: its own carveout
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
      for (auto& per_strips : occupancy.ctas_per_sm[dev])
        for (int& n : per_strips) n = 0;
      occupancy.kernel[dev] = kernel;
    }
    int& cached = occupancy.ctas_per_sm[dev][p.strips][p.blocks];
    if (cached == 0) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, kernel, threads, smem);
      if (err != cudaSuccess) return err;
    }
    occ = cached;
  }
  if (occ < 1) return cudaErrorInvalidConfiguration;
  int grid = sms * occ;
  grid -= grid % p.slices;  // a CTA keeps one channel slice
  if (grid < p.slices) grid = p.slices;
  if (grid > p.tiles) grid = p.tiles;
  tiled_kernel<K, kBias, OutT, kCut, kAnyC><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the C entry points' front: x (B, H, W, C) -> (B, Ho, Wo, C)
template <int K, bool kBias, typename OutT, int kCut, bool kAnyC = false>
cudaError_t run(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                int C, int Ho, int Wo, int pad_top, int pad_left, cudaStream_t stream) {
  Params p{};
  p.x = (const bf16*)x;
  p.w = (const float*)w;
  p.bias = (const float*)bias;
  p.out = out;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ho = Ho;
  p.Wo = Wo;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  return launch<K, kBias, OutT, kCut, kAnyC>(p, B, stream);
}

}  // namespace depthwise
