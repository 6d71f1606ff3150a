// Measurements of the int8 MLP pair (tools/exp_int8_mlp.py), a plain C
// interface for ctypes:
//   mlp_cut            mlp_s8_kernel's phase cuts (kLn: the loads, waits and
//                      barriers alone; kProducts: + fc1 and fc2; kWhole: the
//                      kernel) at the column tiles of ConvNeXt's stages, bf16
//                      residual
//   gelu_throughput    the per-element epilogue alone, out of registers, at
//                      full occupancy: gelu_rn; + the dequant; + the code
//   gelu_scan          where gelu_rn (the kernels' GELU) is monotone, over
//                      every f32 input
// None of them is on the model path.

#include "block_int8.cuh"

namespace B = block_int8;
namespace hg = hopper_gemm;
using B::bf16;

namespace {

template <int kCut>
int cut(const B::MlpParams& p, const void* x_codes, const void* w1, const void* w2,
        cudaStream_t s) {
  switch (p.C / p.col_tiles) {
    case 96: return (int)B::launch_mlp_ow<32, 3, bf16, bf16, kCut>(p, x_codes, w1, w2, s);
    case 192: return (int)B::launch_mlp_ow<64, 3, bf16, bf16, kCut>(p, x_codes, w1, w2, s);
    case 256: return (int)B::launch_mlp_ow<64, 4, bf16, bf16, kCut>(p, x_codes, w1, w2, s);
    case 384: return (int)B::launch_mlp_ow<96, 4, bf16, bf16, kCut>(p, x_codes, w1, w2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// kMode 0: gelu_rn of a float made from the counter; 1: of the dequant of
// an s32 sum; 2: and its code. kIlp independent elements a thread an iteration
template <int kMode, int kIlp>
__global__ void __launch_bounds__(256) gelu_throughput_kernel(unsigned* out, int iters) {
  unsigned acc = 0;
  int v[kIlp];
#pragma unroll
  for (int i = 0; i < kIlp; ++i)
    v[i] = (int)((threadIdx.x * 7919u + blockIdx.x * 104729u + i * 31u) % 4000u) - 2000;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kIlp; ++i) {
      const float h = kMode == 0 ? __int2float_rn(v[i]) * 1e-3f : B::dequant(v[i], 1.0f, 7e-4f, 1e-2f);
      const float g = B::gelu_rn(h);
      acc = kMode == 2 ? acc + B::code(g, 1.0f) : acc ^ __float_as_uint(g);
      v[i] += 13;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

struct Scan {
  unsigned long long pos_descents, pos_negative, neg_positive;
  unsigned long long peak;  // (bits of -g) << 32 | ~(bits of |x|): the largest -g, smallest |x|
  unsigned long long near_falls, far_rises;
  unsigned int pos_min, pos_max, near_min, near_max, far_min, far_max;
};

__global__ void scan_sides(Scan* s) {
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < 0x7f800000ull; i += step) {
    const unsigned b = (unsigned)i;
    const float g = B::gelu_rn(__uint_as_float(b));
    if (g < 0.f) atomicAdd(&s->pos_negative, 1ull);
    if (b + 1 < 0x7f800000u && B::gelu_rn(__uint_as_float(b + 1)) < g) {
      atomicAdd(&s->pos_descents, 1ull);
      atomicMin(&s->pos_min, b);
      atomicMax(&s->pos_max, b);
    }
    const float n = B::gelu_rn(__uint_as_float(b | 0x80000000u));
    if (n > 0.f) atomicAdd(&s->neg_positive, 1ull);
    atomicMax(&s->peak, ((unsigned long long)__float_as_uint(-n) << 32) | (unsigned long long)(~b));
  }
}

// below 0, by magnitude: up to the peak -g must not fall, past it not rise
__global__ void scan_negative(Scan* s) {
  const unsigned peak = ~(unsigned)(s->peak & 0xffffffffull);
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i + 1 < 0x7f800000ull; i += step) {
    const unsigned b = (unsigned)i;
    const float m0 = -B::gelu_rn(__uint_as_float(b | 0x80000000u));
    const float m1 = -B::gelu_rn(__uint_as_float((b + 1) | 0x80000000u));
    if (b + 1 <= peak && m1 < m0) {
      atomicAdd(&s->near_falls, 1ull);
      atomicMin(&s->near_min, b);
      atomicMax(&s->near_max, b);
    } else if (b >= peak && m1 > m0) {
      atomicAdd(&s->far_rises, 1ull);
      atomicMin(&s->far_min, b);
      atomicMax(&s->far_max, b);
    }
  }
}

}  // namespace

extern "C" {

int mlp_cut(int which, const void* x_codes, const void* x_scale, const void* h_scale,
            const void* w1, const void* colscale1, const void* b1, const void* w2,
            const void* colscale2, const void* b2, const void* gamma, const void* res, void* out,
            int M, int C, int N, int col_tiles, int s1, int s2, int x_buffers, int resident,
            void* stream) {
  const B::MlpParams p{(const float*)x_scale, (const float*)h_scale, (const float*)colscale1,
                       (const float*)b1, (const float*)colscale2, (const float*)b2,
                       (const float*)gamma, res, out, M, C, N, col_tiles, s1, s2, x_buffers,
                       resident};
  const cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) return cut<hg::kLn>(p, x_codes, w1, w2, s);
  if (which == 1) return cut<hg::kProducts>(p, x_codes, w1, w2, s);
  return cut<hg::kWhole>(p, x_codes, w1, w2, s);
}

// the card's maximum SM clock in kHz
int sm_clock_khz() {
  int dev = 0, khz = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev) == cudaSuccess ? khz : 0;
}

// mode 0-2 as gelu_throughput_kernel's, ilp 4 or 8; blocks x 256 threads
int gelu_throughput(int mode, int ilp, int blocks, int iters, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned* o = (unsigned*)out;
#define GELU_CASE(M, I)                                                        \
  if (mode == M && ilp == I) {                                                 \
    gelu_throughput_kernel<M, I><<<blocks, 256, 0, s>>>(o, iters);             \
    return (int)cudaGetLastError();                                            \
  }
  GELU_CASE(0, 4) GELU_CASE(0, 8) GELU_CASE(1, 4) GELU_CASE(1, 8) GELU_CASE(2, 4) GELU_CASE(2, 8)
#undef GELU_CASE
  return (int)cudaErrorInvalidValue;
}

// out: a Scan (72 bytes), zeroed but for the minima (0xffffffff) by the
// caller
int gelu_scan(void* out, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = hg::sm_count(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  scan_sides<<<sms * 16, 256, 0, s>>>((Scan*)out);
  scan_negative<<<sms * 16, 256, 0, s>>>((Scan*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
