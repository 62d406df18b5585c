// K6 — fused int8 convolution for Hopper (sm_90a).
//
// Replaces: analytics_zoo_tpu/ops/int8_fused.py, `_int8_conv_kernel`
// (wrapper `int8_conv2d_fused`, stride 1), and, with its stride and rule 1,
// the lax route `int8_conv2d_unfused` of analytics_zoo_tpu/ops/int8.py.
//
// Computes the NHWC x HWIO convolution y[b, ho, wo, n] = (sum over taps
// t = kh * KW + kw, in that order, of f32(sum_c q[b, hi, wi, c] *
// Wq[kh, kw, c, n]) * s[b, hi, wi]) * s_channel[n], with hi = ho * sh + kh -
// pad_top and wi = wo * sw + kw - pad_left, where q and s quantize each
// input pixel's Cin vector with its own abs-max scale (csrc/int8_tile.cuh
// has the rounding rules). Pixels outside the input are the zero padding:
// they quantize to 0, so their scale never matters. x in f32 or bf16, y
// (B, Ho, Wo, Cout) in x's dtype.
//
// What bounds it on the H100: the bytes (x, the weights and y once) at
// ResNet-50's convs at batch 32 (51 MB, 15.3 us at the 3x3/1 64->64 at 56
// px); 2 * B * Ho * Wo * Cout * KH * KW * Cin integer operations against
// 1979 TOP/s come second.
//
// The design (int8_tile.cuh): two launches on the caller's stream.
// - The quantize pass codes every input pixel once: one row of cp bytes
//   (Cin rounded up to 32, the pad zero) and one f32 scale a pixel, to the
//   scratch the wrapper passes. x in f32 is read once (4 bytes a value)
//   and its codes (1 byte) are what the taps read back: at the 3x3/1
//   64->64 at 56 px, batch 32, 25.7 MB of x read, 6.4 MB of codes and 0.4
//   MB of scales written, then read by 9 taps mostly from L2, where the
//   __dp4a kernel this replaces took each pixel's abs-max and divided it
//   again at each of the 9 taps. A 1x1 conv with no padding codes only the
//   pixels it reads (B x Ho x Wo rows: a quarter at stride 2) and runs as a
//   matmul with one segment.
// - The tensor-core GEMM is an implicit GEMM: rows are the output pixels
//   (B x Ho x Wo flattened), columns Cout, and the segments the taps, each
//   walked in 64-byte chunks of Cin; a row's chunk is its input pixel's at
//   that tap, zero-filled by cp.async on the padding. Each tap's int32
//   partial is folded into the f32 accumulator with the pixel's scale.
// - Cin <= 4 (the stem's 3 channels): padding to 32 would multiply the
//   work by 8, so the codes keep one 32-bit word a pixel and a __dp4a
//   kernel walks the taps (conv_dp4a_kernel). At the 7x7/2 stem, batch
//   32, on the H100 (scripts/torch_int8_variants.py --stem-tc): the
//   tensor-core path on channels padded to 8 took 0.73 ms device, this
//   kernel 0.32 (4 x 16 outputs a thread; 8 x 4 took 0.50). What bounds
//   it is the fold: 49 taps x 3 f32 operations an output.
// The weights come kernel-major, (KH, KW, Cout, Cin) with Cin padded to cp
// (`packed["qt"]`, made once where the layer is packed).
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using namespace zoo::i8;

// named for the profiler: K6's instances of the shared kernels
struct ConvTaps : TapGather {};
struct ConvRows : RowGather {};
struct ConvPixels : SameRows {};
struct ConvStrided : StridedPixels {};

struct ConvShape {
  int B, H, W, Cin, Ho, Wo, Cout, KH, KW, sh, sw, pt, pl;
};

// the codes' bytes a pixel
int pitch_of(int cin) { return cin <= 4 ? 4 : depth_of(cin); }

// a 1x1 window that never reads the padding codes only the pixels it reads
bool direct_rows(const ConvShape& s) {
  return s.Cin > 4 && s.KH == 1 && s.KW == 1 && s.pt == 0 && s.pl == 0 &&
         (long long)(s.Ho - 1) * s.sh < s.H &&
         (long long)(s.Wo - 1) * s.sw < s.W;
}

// the scratch rows the quantize pass codes
long long scratch_rows(const ConvShape& s) {
  return direct_rows(s) ? (long long)s.B * s.Ho * s.Wo
                        : (long long)s.B * s.H * s.W;
}

// the Cin <= 4 kernel's block: 256 threads, 64 output channels, each
// thread kRPT rows x kCPT columns
constexpr int kStemCols = 64, kStemThreads = 256, kRPT = 4, kCPT = 16;
constexpr int kTX = kStemCols / kCPT, kTY = kStemThreads / kTX;
constexpr int kStemRows = kTY * kRPT;
constexpr int kStemMaxK = 32;  // window rows and columns a mask holds
constexpr int kStemMaxSmem = 227 * 1024;  // the weights of a window

// Cin <= 4: each thread owns kRPT x kCPT outputs of a kStemRows x 64 tile
// (rows ty + kTY i, columns tx + kTX j). A row keeps its window's first
// input pixel and two masks of the window rows and columns that fall on
// the image, so a tap costs a row one add, two bit tests and two loads
// (its code word and scale: L1 hits, the kTX threads of a row share them);
// the tap's weights come from shared memory, one word a column; the tap's
// __dp4a partial starts at kMagic, so one subtraction converts it.
template <typename T>
__global__ void __launch_bounds__(kStemThreads)
    conv_dp4a_kernel(const ConvTaps g, const int8_t* __restrict__ wt,
                     const float* __restrict__ ws, T* __restrict__ y,
                     int KH, int Cin, int Cout) {
  extern __shared__ int wsm[];  // [tap][kStemCols], Cin bytes a word
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const long long m0 = (long long)blockIdx.x * kStemRows;
  const int n0 = blockIdx.y * kStemCols;
  const int KW = g.KW;
  for (int idx = tid; idx < KH * KW * kStemCols; idx += kStemThreads) {
    const int t = idx / kStemCols, n = n0 + idx % kStemCols;
    uint32_t w = 0;
    if (n < Cout)
      for (int c = 0; c < Cin; ++c)
        w |= (uint32_t)(uint8_t)wt[(t * Cout + n) * Cin + c] << (8 * c);
    wsm[idx] = (int)w;
  }
  int base[kRPT];
  uint32_t hmask[kRPT], wmask[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const typename ConvTaps::Row r = g.row(m0 + ty + kTY * i);
    base[i] = r.pix0 + r.hi0 * g.W + r.wi0;
    hmask[i] = wmask[i] = 0;
    for (int k = 0; k < KH; ++k)
      hmask[i] |= (uint32_t)((unsigned)(r.hi0 + k) < (unsigned)g.H) << k;
    for (int k = 0; k < KW; ++k)
      wmask[i] |= (uint32_t)((unsigned)(r.wi0 + k) < (unsigned)g.W) << k;
  }
  __syncthreads();
  const int* cw = reinterpret_cast<const int*>(g.codes);
  float acc[kRPT][kCPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int j = 0; j < kCPT; ++j) acc[i][j] = 0.f;
  for (int kh = 0; kh < KH; ++kh) {
    for (int kw = 0; kw < KW; ++kw) {
      const int* wrow = wsm + (kh * KW + kw) * kStemCols + tx;
      int w[kCPT];
#pragma unroll
      for (int j = 0; j < kCPT; ++j) w[j] = wrow[kTX * j];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const bool ok = (hmask[i] >> kh) & (wmask[i] >> kw) & 1u;
        const int p = base[i] + kh * g.W + kw;
        const int a = ok ? __ldg(cw + p) : 0;
        const float s = ok ? __ldg(g.scales + p) : 0.f;
#pragma unroll
        for (int j = 0; j < kCPT; ++j)
          acc[i][j] = __fadd_rn(
              acc[i][j],
              __fmul_rn(part_to_f(__dp4a(a, w[j], kMagic), true), s));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const long long m = m0 + ty + kTY * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int n = n0 + tx + kTX * j;
      if (n < Cout)
        y[m * Cout + n] = zoo::from_f<T>(__fmul_rn(acc[i][j], ws[n]));
    }
  }
}

template <typename T>
cudaError_t run(const T* x, const int8_t* wt, const float* ws, T* y,
                int8_t* codes, float* scales, const ConvShape& s, int rule,
                float recip, cudaStream_t st) {
  const int cp = pitch_of(s.Cin);
  const long long n_out = (long long)s.B * s.Ho * s.Wo;
  if (direct_rows(s)) {
    // at stride 1 the pixels it reads are all of them, in order
    cudaError_t err =
        s.sh == 1 && s.sw == 1
            ? launch_quantize(x, codes, scales, ConvPixels{{(int)n_out}},
                              s.Cin, s.Cin, cp, rule, recip, st)
            : launch_quantize(x, codes, scales,
                              ConvStrided{{(int)n_out, s.Wo, s.Ho * s.Wo,
                                           s.sh, s.sw, s.W, s.H * s.W}},
                              s.Cin, s.Cin, cp, rule, recip, st);
    if (err != cudaSuccess) return err;
    const ConvRows rows{{codes, scales, n_out, 1, cp}};
    const Operands op{wt, cp, 0, ws, s.Cout, 1, cp};
    return launch_gemm(rows, op, y, st);
  }
  const ConvPixels map{{s.B * s.H * s.W}};
  cudaError_t err =
      launch_quantize(x, codes, scales, map, s.Cin, s.Cin, cp, rule, recip,
                      st);
  if (err != cudaSuccess) return err;
  const ConvTaps taps{{codes, scales, n_out, s.H, s.W, s.Ho, s.Wo, s.KW, s.sh,
                       s.sw, s.pt, s.pl, cp}};
  const int n_taps = s.KH * s.KW;
  if (s.Cin <= 4) {
    // the grant is the most any window takes: it caps every launch's
    static std::atomic<uint64_t> granted{0};
    auto kernel = conv_dp4a_kernel<T>;
    const int smem = n_taps * kStemCols * 4;
    err = zoo::mma::grant_smem(kernel, kStemMaxSmem, granted);
    if (err != cudaSuccess) return err;
    const long long mt = (n_out + kStemRows - 1) / kStemRows;
    const int nt = (s.Cout + kStemCols - 1) / kStemCols;
    if (mt > 2147483647LL || nt > 65535) return cudaErrorInvalidValue;
    kernel<<<dim3((unsigned)mt, (unsigned)nt), kStemThreads, smem, st>>>(
        taps, wt, ws, y, s.KH, s.Cin, s.Cout);
    return cudaGetLastError();
  }
  const Operands op{wt, cp, (long long)s.Cout * cp, ws, s.Cout, n_taps, cp};
  return launch_gemm(taps, op, y, st);
}

}  // namespace

// x (B, H, W, Cin) and y (B, Ho, Wo, Cout) contiguous in the dtype `dtype`
// (0 f32, 1 bf16); wt (KH, KW, Cout, wp) int8, the weights kernel-major,
// with wp = Cin at Cin <= 4 and the codes' pitch (Cin rounded up to 32,
// the pad zero) above; ws (Cout,) f32; the scratch codes (rows, pitch)
// int8 and scales (rows,) f32, all contiguous and 16-byte aligned: rows
// B * Ho * Wo for a 1x1 window at Cin > 4 that reads no padding (it codes
// only the pixels it reads), else B * H * W; pitch 4 at Cin <= 4, else Cin
// rounded up to 32. The caller's rows and pitch must be these. Strides
// sh, sw >= 1; pad_top/pad_left place the window (the bottom/right padding
// follows from Ho, Wo). rule 0: scale = max(amax, 1e-12) * recip; rule 1:
// / 127. Returns the first CUDA error of the two launches
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int zoo_int8_conv(const void* x, const void* wt, const void* ws,
                             void* y, void* codes, void* scales, int dtype,
                             int B, int H, int W, int Cin, int Ho, int Wo,
                             int Cout, int KH, int KW, int sh, int sw,
                             int pad_top, int pad_left, int rule, float recip,
                             long long rows, int pitch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* sc = static_cast<const float*>(ws);
  int8_t* c = static_cast<int8_t*>(codes);
  float* s = static_cast<float*>(scales);
  const ConvShape shape{B,  H,  W,  Cin, Ho, Wo,      Cout,
                        KH, KW, sh, sw,  pad_top, pad_left};
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Ho < 1 || Wo < 1 || Cout < 1 ||
      KH < 1 || KW < 1 || sh < 1 || sw < 1 || pad_top < 0 || pad_left < 0 ||
      (long long)B * H * W > 2147483647LL ||
      (long long)B * Ho * Wo > 2147483647LL ||
      (long long)Cin * 127 * 127 > 2147483647LL ||
      (Cin <= 4 && (KH > kStemMaxK || KW > kStemMaxK ||
                    KH * KW * kStemCols * 4 > kStemMaxSmem)) ||
      (rule != 0 && rule != 1) || rows != scratch_rows(shape) ||
      pitch != pitch_of(Cin))
    return (int)cudaErrorInvalidValue;
  if (dtype == zoo::kF32)
    return (int)run(static_cast<const float*>(x), w, sc,
                    static_cast<float*>(y), c, s, shape, rule, recip, st);
  if (dtype == zoo::kBF16)
    return (int)run(static_cast<const __nv_bfloat16*>(x), w, sc,
                    static_cast<__nv_bfloat16*>(y), c, s, shape, rule, recip,
                    st);
  return (int)cudaErrorInvalidValue;
}
