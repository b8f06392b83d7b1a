// The device residual composer for Hopper (sm_90a): every coded
// transform of a frame inverse-transformed and stored into the residual
// planes, in one launch.
//
// Replaces easyav1_tpu/video/av1/recon/itx_jax.py:31-102 (_make_kernel,
// itx_batch: one jitted batched 2-D inverse transform per (tx_size,
// tx_type, bit depth)) and the composer of jax_exec.py (group_txs
// :148-181, _residual_multi_kernel :352-380, apply_residuals_fused
// :434-481: every (size, type) bucket's transforms scatter-added into
// the planes in one jit) with itx_kernel, which reads the C decoder's
// transform records and dense coefficients as they are uploaded: no
// buckets, no padded batches.
//
// What it computes.  A record is [plane, x, y, tx_size, tx_type, eob
// (packed; not read), coefficient offset, lossless].  For each, as the
// port's video/av1/itx_ref.py and the reference's
// recon_ref.inverse_transform: the adj_h x adj_w coefficients (a
// 64-point side keeps its first 32), zero-extended to h x w; the
// 2896/4096 scaling where the sides differ by a factor 2; the row pass
// (the horizontal 1-D kind of tx_type along each row), rounded by the
// size's row shift and clamped to +-2^(bd+7); the column pass; then
// (x + 8) >> 4, stored at (y, x) of its plane and cropped at the plane's
// right and bottom edges.  The 1-D kinds: DCT 4 to 64, ADST 4, 8 and 16,
// flipADST (the ADST's outputs reversed), identity 4 to 64 (x4 at 32 and
// 64, as itx_ref).  Butterfly intermediates are clamped to +-2^(bd+7)
// where itx_ref clamps them.  Records the decoder never makes are
// skipped, whole: a lossless (WHT) one (the recons decline such frames,
// as the reference's device composer does), an ADST longer than 16, a
// plane, size, type or coefficient range out of bounds.  Records must
// not overlap (the decoder's do not): each pixel is written by one
// transform, and the planes are zero where none lies.
//
// Integer widths.  Every butterfly input lies within +-2^(bd+7), so a
// rotation's two products sum to at most 2^(bd+7) x 5793, ADST4's four
// to 2^(bd+7) x 10950 and identity16's product to 2^(bd+7) x 11586:
// below 2^31 at 8 and 10 bits, where the kernel runs in int32 and
// writes int16 planes.  At 12 bits they leave int32 (the reference falls
// back to numpy int64 there, itx_jax.py:85-95); that instantiation runs
// in int64 and writes int32 planes.
//
// What bounds it on this card: bytes (32 a record, 4 a coefficient, 2
// or 4 a plane sample) for most transforms, the butterflies' integer
// operations for the largest (some 25 a sample for 32x32 DCT_DCT).  The
// first design: a warp a transform, 4 warps a CTA.  The warp stages the
// coefficient block in shared memory with coalesced loads (rows padded
// to w + 1 samples, so that the row pass's lanes, one a row, hit
// different banks); a lane runs one row's 1-D transform in registers and
// writes it back in place; after __syncwarp a lane runs one column (two
// for 64-wide blocks) and stores it, the warp's lanes on neighbouring
// samples of each output row.  Small transforms leave most lanes idle
// (a 4x4 runs on 4), and every record costs a warp: packing several
// small transforms into a warp, the eob's bounding box and asynchronous
// copies are for a later design.

#include <cuda_runtime.h>
#include <stdint.h>

// The launch, as a macro so that a host build can run the kernel
// (tools/torch_itx_host_run.py).
#ifndef ITX_LAUNCH
#define ITX_LAUNCH(kernel, grid, threads, stream, ...) \
  kernel<<<grid, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kWarps = 4;                 // transforms in flight a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kCtasPerSm = 4;             // caps registers at 128 a thread
constexpr int kMaxPlanes = 3;
constexpr int kRecord = 8;                // int32 fields a record
constexpr int kStage = 32 * 65;           // 32 coded rows of 64, pitch 65

enum { kDct = 0, kAdst = 1, kFlip = 2, kIdtx = 3 };

// log2 of TX_WIDTH and TX_HEIGHT by tx size (video/av1/tables.py)
__constant__ int8_t kLogW[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4,
                                 5, 5, 6, 2, 4, 3, 5, 4, 6};
__constant__ int8_t kLogH[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5,
                                 4, 6, 5, 4, 2, 5, 3, 6, 4};
// itx_ref._ROW_SHIFT
__constant__ int8_t kRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                                     1, 1, 1, 1, 1, 2, 2, 2, 2};
// itx_ref._TX_1D: (vertical, horizontal) kind by tx type
__constant__ int8_t kKinds[16][2] = {
    {0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {0, 2}, {2, 2}, {1, 2},
    {2, 1}, {3, 3}, {0, 3}, {3, 0}, {1, 3}, {3, 1}, {2, 3}, {3, 2}};
// itx_ref.cos128_table(): round(4096 cos(i pi / 128)), i = 0..64
__constant__ int16_t kCos[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
    3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
    3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
    2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
    1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995,
    897,  799,  700,  601,  501,  401,  301,  201,  101,  0};

__host__ __device__ constexpr int bitrev(int j, int bits) {
  int out = 0;
  for (int b = 0; b < bits; ++b) {
    out = (out << 1) | (j & 1);
    j >>= 1;
  }
  return out;
}

__device__ __forceinline__ int cos128(int angle) {
  const int a = angle & 255;
  if (a <= 64) return kCos[a];
  if (a <= 128) return -kCos[128 - a];
  if (a <= 192) return -kCos[a - 128];
  return kCos[256 - a];
}

// The 1-D transforms of itx_ref on T (int32 or int64), in place on c.
template <typename T>
struct Itx {
  T mn, mx;

  __device__ __forceinline__ T cl(T x) const {
    return x < mn ? mn : (x > mx ? mx : x);
  }
  static __device__ __forceinline__ T r12(T x) { return (x + 2048) >> 12; }
  static __device__ __forceinline__ T half(T x) { return (x * 181 + 128) >> 8; }
  // (a cos(64 - phi) - b cos(phi), a cos(phi) + b cos(64 - phi)), rounded
  static __device__ __forceinline__ void rot(T a, T b, int phi, T& lo,
                                             T& hi) {
    const T c0 = cos128(64 - phi), c1 = cos128(phi);
    lo = r12(a * c0 - b * c1);
    hi = r12(a * c1 + b * c0);
  }

  __device__ void dct4(T* c) const {
    const T in0 = c[0], in1 = c[1], in2 = c[2], in3 = c[3];
    const T t0 = half(in0 + in2), t1 = half(in0 - in2);
    const T t2 = r12(in1 * 1567 - in3 * 3784);
    const T t3 = r12(in1 * 3784 + in3 * 1567);
    c[0] = cl(t0 + t3);
    c[1] = cl(t1 + t2);
    c[2] = cl(t1 - t2);
    c[3] = cl(t0 - t3);
  }

  __device__ void dct8(T* c) const {
    T t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = c[2 * i];
    dct4(t);
    const T in1 = c[1], in3 = c[3], in5 = c[5], in7 = c[7];
    const T t4a = r12(in1 * 799 - in7 * 4017);
    const T t7a = r12(in1 * 4017 + in7 * 799);
    const T t5a = r12(in5 * 3406 - in3 * 2276);
    const T t6a = r12(in5 * 2276 + in3 * 3406);
    const T t4 = cl(t4a + t5a), t5b = cl(t4a - t5a);
    const T t7 = cl(t7a + t6a), t6b = cl(t7a - t6a);
    const T o[4] = {t4, half(t6b - t5b), half(t6b + t5b), t7};
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = cl(t[i] + o[3 - i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[4 + i] = cl(t[3 - i] - o[i]);
  }

  __device__ void dct16(T* c) const {
    T t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = c[2 * i];
    dct8(t);
    T t8a, t15a, t9a, t14a, t10a, t13a, t11a, t12a;
    rot(c[1], c[15], 4, t8a, t15a);
    rot(c[9], c[7], 36, t9a, t14a);
    rot(c[5], c[11], 20, t10a, t13a);
    rot(c[13], c[3], 52, t11a, t12a);
    const T t8 = cl(t8a + t9a), t9 = cl(t8a - t9a);
    const T t10 = cl(t11a - t10a), t11 = cl(t11a + t10a);
    const T t12 = cl(t12a + t13a), t13 = cl(t12a - t13a);
    const T t14 = cl(t15a - t14a), t15 = cl(t15a + t14a);
    t9a = r12(t14 * 1567 - t9 * 3784);
    t14a = r12(t14 * 3784 + t9 * 1567);
    t10a = r12(-(t13 * 3784 + t10 * 1567));
    t13a = r12(t13 * 1567 - t10 * 3784);
    t8a = cl(t8 + t11);
    const T t9b = cl(t9a + t10a), t10b = cl(t9a - t10a);
    t11a = cl(t8 - t11);
    t12a = cl(t15 - t12);
    const T t13b = cl(t14a - t13a), t14b = cl(t14a + t13a);
    t15a = cl(t15 + t12);
    const T o[8] = {t8a, t9b, half(t13b - t10b), half(t12a - t11a),
                    half(t12a + t11a), half(t13b + t10b), t14b, t15a};
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = cl(t[i] + o[7 - i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) c[8 + i] = cl(t[7 - i] - o[i]);
  }

  __device__ void dct32(T* c) const {
    T t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = c[2 * i];
    dct16(t);
    // ta[0..15] = t16a..t31a: rotations of (c[f], c[32 - f]) at
    // f = 1 + 4 bitrev(j), angle 2 + 8 bitrev(j)
    T ta[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = 1 + 4 * bitrev(j, 3);
      rot(c[f], c[32 - f], 2 + 8 * bitrev(j, 3), ta[j], ta[15 - j]);
    }
    const T t16 = cl(ta[0] + ta[1]), t17 = cl(ta[0] - ta[1]);
    const T t18 = cl(ta[3] - ta[2]), t19 = cl(ta[3] + ta[2]);
    const T t20 = cl(ta[4] + ta[5]), t21 = cl(ta[4] - ta[5]);
    const T t22 = cl(ta[7] - ta[6]), t23 = cl(ta[7] + ta[6]);
    const T t24 = cl(ta[8] + ta[9]), t25 = cl(ta[8] - ta[9]);
    const T t26 = cl(ta[11] - ta[10]), t27 = cl(ta[11] + ta[10]);
    const T t28 = cl(ta[12] + ta[13]), t29 = cl(ta[12] - ta[13]);
    const T t30 = cl(ta[15] - ta[14]), t31 = cl(ta[15] + ta[14]);
    const T t17a = r12(t30 * 799 - t17 * 4017);
    const T t30a = r12(t30 * 4017 + t17 * 799);
    const T t18a = r12(-(t29 * 4017 + t18 * 799));
    const T t29a = r12(t29 * 799 - t18 * 4017);
    const T t21a = r12(t26 * 3406 - t21 * 2276);
    const T t26a = r12(t26 * 2276 + t21 * 3406);
    const T t22a = r12(-(t25 * 2276 + t22 * 3406));
    const T t25a = r12(t25 * 3406 - t22 * 2276);
    const T t16a = cl(t16 + t19), t17b = cl(t17a + t18a);
    const T t18b = cl(t17a - t18a), t19a = cl(t16 - t19);
    const T t20a = cl(t23 - t20), t21b = cl(t22a - t21a);
    const T t22b = cl(t22a + t21a), t23a = cl(t23 + t20);
    const T t24a = cl(t24 + t27), t25b = cl(t25a + t26a);
    const T t26b = cl(t25a - t26a), t27a = cl(t24 - t27);
    const T t28a = cl(t31 - t28), t29b = cl(t30a - t29a);
    const T t30b = cl(t30a + t29a), t31a = cl(t31 + t28);
    const T t18c = r12(t29b * 1567 - t18b * 3784);
    const T t29c = r12(t29b * 3784 + t18b * 1567);
    const T t19b = r12(t28a * 1567 - t19a * 3784);
    const T t28b = r12(t28a * 3784 + t19a * 1567);
    const T t20b = r12(-(t27a * 3784 + t20a * 1567));
    const T t27b = r12(t27a * 1567 - t20a * 3784);
    const T t21c = r12(-(t26b * 3784 + t21b * 1567));
    const T t26c = r12(t26b * 1567 - t21b * 3784);
    const T u16 = cl(t16a + t23a), u17 = cl(t17b + t22b);
    const T u18 = cl(t18c + t21c), u19 = cl(t19b + t20b);
    const T u20 = cl(t19b - t20b), u21 = cl(t18c - t21c);
    const T u22 = cl(t17b - t22b), u23 = cl(t16a - t23a);
    const T u24 = cl(t31a - t24a), u25 = cl(t30b - t25b);
    const T u26 = cl(t29c - t26c), u27 = cl(t28b - t27b);
    const T u28 = cl(t28b + t27b), u29 = cl(t29c + t26c);
    const T u30 = cl(t30b + t25b), u31 = cl(t31a + t24a);
    const T o[16] = {u16, u17, u18, u19,
                     half(u27 - u20), half(u26 - u21),
                     half(u25 - u22), half(u24 - u23),
                     half(u24 + u23), half(u25 + u22),
                     half(u26 + u21), half(u27 + u20),
                     u28, u29, u30, u31};
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = cl(t[i] + o[15 - i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) c[16 + i] = cl(t[15 - i] - o[i]);
  }

  // itx_ref._odd_merge for m = 32: alternating add stages, group size
  // doubling, with mirror-pair rotations at angles base (1 + 4 bitrev(q))
  // between them, then the 1/sqrt2 halves
  __device__ void odd_merge32(T* s) const {
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const T a = s[2 * g], b = s[2 * g + 1];
      s[2 * g] = g % 2 == 0 ? cl(a + b) : cl(b - a);
      s[2 * g + 1] = g % 2 == 0 ? cl(a - b) : cl(b + a);
    }
#pragma unroll
    for (int L = 1; L <= 3; ++L) {
      const int size = 1 << (L + 1);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ang = size * (1 + 4 * bitrev(i >> (L + 1), 3 - L));
        const int r = i % size, j = 31 - i;
        const T a = s[i], b = s[j];
        const T c0 = cos128(64 - ang), c1 = cos128(ang);
        if (size / 4 <= r && r < size / 2) {
          s[i] = r12(b * c0 - a * c1);
          s[j] = r12(b * c1 + a * c0);
        } else if (size / 2 <= r && r < 3 * size / 4) {
          s[i] = r12(-(b * c1 + a * c0));
          s[j] = r12(b * c0 - a * c1);
        }
      }
      T t[32];
#pragma unroll
      for (int gi = 0; gi < 32 / size; ++gi) {
#pragma unroll
        for (int i = 0; i < size / 2; ++i) {
          const int lo = gi * size + i, hi = gi * size + size - 1 - i;
          t[lo] = gi % 2 == 0 ? cl(s[lo] + s[hi]) : cl(s[hi] - s[lo]);
          t[hi] = gi % 2 == 0 ? cl(s[lo] - s[hi]) : cl(s[hi] + s[lo]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = t[i];
    }
#pragma unroll
    for (int i = 8; i < 16; ++i) {
      const T a = s[i], b = s[31 - i];
      s[i] = half(b - a);
      s[31 - i] = half(b + a);
    }
  }

  __device__ void dct64(T* c) const {
    T t[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) t[i] = c[2 * i];
    dct32(t);
    T o[32];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i0 = 1 + 2 * bitrev(j, 5);
      rot(c[i0], c[64 - i0], 1 + 4 * bitrev(j, 4), o[j], o[31 - j]);
    }
    odd_merge32(o);
#pragma unroll
    for (int i = 0; i < 32; ++i) c[i] = cl(t[i] + o[31 - i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) c[32 + i] = cl(t[31 - i] - o[i]);
  }

  __device__ void adst4(T* c) const {
    const T in0 = c[0], in1 = c[1], in2 = c[2], in3 = c[3];
    T s0 = in0 * 1321, s1 = in0 * 2482, s2 = in1 * 3344, s3 = in2 * 3803;
    const T s4 = in2 * 1321, s5 = in3 * 2482, s6 = in3 * 3803;
    const T b7 = (in0 - in2) + in3;
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = b7 * 3344;
    s0 = s0 + s5;
    s1 = s1 - s6;
    c[0] = r12(s0 + s3);
    c[1] = r12(s1 + s3);
    c[2] = r12(s2);
    c[3] = r12(s0 + s1 - s3);
  }

  __device__ void adst8(T* c) const {
    const T in0 = c[0], in1 = c[1], in2 = c[2], in3 = c[3];
    const T in4 = c[4], in5 = c[5], in6 = c[6], in7 = c[7];
    T t0a = r12(in7 * 4076 + in0 * 401), t1a = r12(in7 * 401 - in0 * 4076);
    T t2a = r12(in5 * 3612 + in2 * 1931), t3a = r12(in5 * 1931 - in2 * 3612);
    T t4a = r12(in3 * 2598 + in4 * 3166), t5a = r12(in3 * 3166 - in4 * 2598);
    T t6a = r12(in1 * 1189 + in6 * 3920), t7a = r12(in1 * 3920 - in6 * 1189);
    const T t0 = cl(t0a + t4a), t1 = cl(t1a + t5a);
    const T t2 = cl(t2a + t6a), t3 = cl(t3a + t7a);
    const T t4 = cl(t0a - t4a), t5 = cl(t1a - t5a);
    const T t6 = cl(t2a - t6a), t7 = cl(t3a - t7a);
    t4a = r12(t4 * 3784 + t5 * 1567);
    t5a = r12(t4 * 1567 - t5 * 3784);
    t6a = r12(-(t6 * 1567) + t7 * 3784);
    t7a = r12(t6 * 3784 + t7 * 1567);
    const T t2b = cl(t0 - t2), t3b = cl(t1 - t3);
    const T t6b = cl(t4a - t6a), t7b = cl(t5a - t7a);
    c[0] = cl(t0 + t2);
    c[1] = -cl(t4a + t6a);
    c[2] = half(t6b + t7b);
    c[3] = -half(t2b + t3b);
    c[4] = half(t2b - t3b);
    c[5] = -half(t6b - t7b);
    c[6] = cl(t5a + t7a);
    c[7] = -cl(t1 + t3);
  }

  __device__ void adst16(T* x) const {
    T t0a = r12(x[15] * 4091 + x[0] * 201), t1a = r12(x[15] * 201 - x[0] * 4091);
    T t2a = r12(x[13] * 3973 + x[2] * 995), t3a = r12(x[13] * 995 - x[2] * 3973);
    T t4a = r12(x[11] * 3703 + x[4] * 1751), t5a = r12(x[11] * 1751 - x[4] * 3703);
    T t6a = r12(x[9] * 3290 + x[6] * 2440), t7a = r12(x[9] * 2440 - x[6] * 3290);
    T t8a = r12(x[7] * 2751 + x[8] * 3035), t9a = r12(x[7] * 3035 - x[8] * 2751);
    T t10a = r12(x[5] * 2106 + x[10] * 3513);
    T t11a = r12(x[5] * 3513 - x[10] * 2106);
    T t12a = r12(x[3] * 1380 + x[12] * 3857);
    T t13a = r12(x[3] * 3857 - x[12] * 1380);
    T t14a = r12(x[1] * 601 + x[14] * 4052);
    T t15a = r12(x[1] * 4052 - x[14] * 601);
    const T t0 = cl(t0a + t8a), t1 = cl(t1a + t9a);
    const T t2 = cl(t2a + t10a), t3 = cl(t3a + t11a);
    const T t4 = cl(t4a + t12a), t5 = cl(t5a + t13a);
    const T t6 = cl(t6a + t14a), t7 = cl(t7a + t15a);
    const T t8 = cl(t0a - t8a), t9 = cl(t1a - t9a);
    const T t10 = cl(t2a - t10a), t11 = cl(t3a - t11a);
    const T t12 = cl(t4a - t12a), t13 = cl(t5a - t13a);
    const T t14 = cl(t6a - t14a), t15 = cl(t7a - t15a);
    t8a = r12(t8 * 4017 + t9 * 799);
    t9a = r12(t8 * 799 - t9 * 4017);
    t10a = r12(t10 * 2276 + t11 * 3406);
    t11a = r12(t10 * 3406 - t11 * 2276);
    t12a = r12(-(t12 * 799) + t13 * 4017);
    t13a = r12(t12 * 4017 + t13 * 799);
    t14a = r12(-(t14 * 3406) + t15 * 2276);
    t15a = r12(t14 * 2276 + t15 * 3406);
    const T t0b = cl(t0 + t4), t1b = cl(t1 + t5);
    const T t2b = cl(t2 + t6), t3b = cl(t3 + t7);
    const T t4b = cl(t0 - t4), t5b = cl(t1 - t5);
    const T t6b = cl(t2 - t6), t7b = cl(t3 - t7);
    const T t8b = cl(t8a + t12a), t9b = cl(t9a + t13a);
    const T t10b = cl(t10a + t14a), t11b = cl(t11a + t15a);
    const T t12b = cl(t8a - t12a), t13b = cl(t9a - t13a);
    const T t14b = cl(t10a - t14a), t15b = cl(t11a - t15a);
    const T t4c = r12(t4b * 3784 + t5b * 1567);
    const T t5c = r12(t4b * 1567 - t5b * 3784);
    const T t6c = r12(-(t6b * 1567) + t7b * 3784);
    const T t7c = r12(t6b * 3784 + t7b * 1567);
    const T t12c = r12(t12b * 3784 + t13b * 1567);
    const T t13c = r12(t12b * 1567 - t13b * 3784);
    const T t14c = r12(-(t14b * 1567) + t15b * 3784);
    const T t15c = r12(t14b * 3784 + t15b * 1567);
    const T x0 = cl(t0b + t2b), x1 = cl(t1b + t3b);
    const T x2 = cl(t0b - t2b), x3 = cl(t1b - t3b);
    const T x4 = cl(t4c + t6c), x5 = cl(t5c + t7c);
    const T x6 = cl(t4c - t6c), x7 = cl(t5c - t7c);
    const T x8 = cl(t8b + t10b), x9 = cl(t9b + t11b);
    const T x10 = cl(t8b - t10b), x11 = cl(t9b - t11b);
    const T x12 = cl(t12c + t14c), x13 = cl(t13c + t15c);
    const T x14 = cl(t12c - t14c), x15 = cl(t13c - t15c);
    x[0] = x0;
    x[1] = -x8;
    x[2] = x12;
    x[3] = -x4;
    x[4] = half(x6 + x7);
    x[5] = -half(x14 + x15);
    x[6] = half(x10 + x11);
    x[7] = -half(x2 + x3);
    x[8] = half(x2 - x3);
    x[9] = -half(x10 - x11);
    x[10] = half(x14 - x15);
    x[11] = -half(x6 - x7);
    x[12] = x5;
    x[13] = -x13;
    x[14] = x9;
    x[15] = -x1;
  }

  // kind of N points, in place; the kinds a size cannot have (ADST above
  // 16 points) are refused before
  template <int N>
  __device__ __forceinline__ void tx1d(int kind, T* v) const {
    if (kind == kIdtx) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (N == 4) v[i] = (v[i] * 5793 + 2048) >> 12;
        else if (N == 8) v[i] = v[i] * 2;
        else if (N == 16) v[i] = (v[i] * 2 * 5793 + 2048) >> 12;
        else v[i] = v[i] * 4;
      }
    } else if (kind == kDct) {
      if constexpr (N == 4) dct4(v);
      else if constexpr (N == 8) dct8(v);
      else if constexpr (N == 16) dct16(v);
      else if constexpr (N == 32) dct32(v);
      else dct64(v);
    } else {
      if constexpr (N <= 16) {
        if constexpr (N == 4) adst4(v);
        else if constexpr (N == 8) adst8(v);
        else adst16(v);
        if (kind == kFlip) {
#pragma unroll
          for (int i = 0; i < N / 2; ++i) {
            const T s = v[i];
            v[i] = v[N - 1 - i];
            v[N - 1 - i] = s;
          }
        }
      }
    }
  }
};

// The row pass of one row of N samples in place in shared memory: its
// first min(N, 32) are the coded coefficients, the rest zeros.
template <typename T, int N>
__device__ void row_n(const Itx<T>& f, int kind, int32_t* p, bool rect,
                      int shift) {
  constexpr int NA = N < 32 ? N : 32;
  T v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = j < NA ? static_cast<T>(p[j]) : T(0);
  if (rect) {
#pragma unroll
    for (int j = 0; j < NA; ++j) v[j] = (v[j] * 2896 + 2048) >> 12;
  }
  f.template tx1d<N>(kind, v);
  const T rnd = (T(1) << shift) >> 1;
#pragma unroll
  for (int j = 0; j < N; ++j)
    p[j] = static_cast<int32_t>(f.cl((v[j] + rnd) >> shift));
}

// The column pass of one column of N samples (pitch apart in shared
// memory, the first min(N, 32) rows coded, the rest zeros), its first
// `rows` outputs stored `dpitch` apart from dst.
template <typename T, typename OutT, int N>
__device__ void col_n(const Itx<T>& f, int kind, const int32_t* p, int pitch,
                      OutT* dst, int64_t dpitch, int rows) {
  constexpr int NA = N < 32 ? N : 32;
  T v[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = i < NA ? static_cast<T>(p[i * pitch]) : T(0);
  f.template tx1d<N>(kind, v);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < rows) dst[i * dpitch] = static_cast<OutT>((v[i] + 8) >> 4);
}

template <typename T>
__device__ void row_pass(const Itx<T>& f, int logw, int kind, int32_t* p,
                         bool rect, int shift) {
  switch (logw) {
    case 2: row_n<T, 4>(f, kind, p, rect, shift); break;
    case 3: row_n<T, 8>(f, kind, p, rect, shift); break;
    case 4: row_n<T, 16>(f, kind, p, rect, shift); break;
    case 5: row_n<T, 32>(f, kind, p, rect, shift); break;
    default: row_n<T, 64>(f, kind, p, rect, shift); break;
  }
}

template <typename T, typename OutT>
__device__ void col_pass(const Itx<T>& f, int logh, int kind,
                         const int32_t* p, int pitch, OutT* dst,
                         int64_t dpitch, int rows) {
  switch (logh) {
    case 2: col_n<T, OutT, 4>(f, kind, p, pitch, dst, dpitch, rows); break;
    case 3: col_n<T, OutT, 8>(f, kind, p, pitch, dst, dpitch, rows); break;
    case 4: col_n<T, OutT, 16>(f, kind, p, pitch, dst, dpitch, rows); break;
    case 5: col_n<T, OutT, 32>(f, kind, p, pitch, dst, dpitch, rows); break;
    default: col_n<T, OutT, 64>(f, kind, p, pitch, dst, dpitch, rows); break;
  }
}

struct Args {
  const int32_t* txs;      // [n, kRecord]
  const int32_t* coeffs;   // [n_coeffs]
  int64_t n, n_coeffs;
  int np, bd;
  void* planes[kMaxPlanes];  // [h, w], contiguous: OutT
  int h[kMaxPlanes], w[kMaxPlanes];
};

// One warp a record: stage, row pass, column pass and store.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) itx_kernel(Args a) {
  __shared__ int32_t stage[kWarps][kStage];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (k >= a.n) return;                       // the whole warp
  const int32_t* rec = a.txs + k * kRecord;
  const int plane = __ldg(rec), x = __ldg(rec + 1), y = __ldg(rec + 2);
  const int tsz = __ldg(rec + 3), ttyp = __ldg(rec + 4);
  const int64_t off = __ldg(rec + 6);
  if (plane < 0 || plane >= a.np || tsz < 0 || tsz >= 19 || ttyp < 0
      || ttyp >= 16 || __ldg(rec + 7) != 0 || x < 0 || y < 0)
    return;
  const int lw = kLogW[tsz], lh = kLogH[tsz];
  const int law = min(lw, 5), lah = min(lh, 5);
  const int aw = 1 << law, ah = 1 << lah, w = 1 << lw, h = 1 << lh;
  const int vk = kKinds[ttyp][0], hk = kKinds[ttyp][1];
  if ((vk == kAdst || vk == kFlip) && ah > 16) return;
  if ((hk == kAdst || hk == kFlip) && aw > 16) return;
  const int pw = a.w[plane], ph = a.h[plane];
  if (off < 0 || off + ah * aw > a.n_coeffs || x >= pw || y >= ph) return;

  int32_t* s = stage[warp];
  const int pitch = w + 1;
  const int32_t* co = a.coeffs + off;
  for (int i = lane; i < ah * aw; i += 32)
    s[(i >> law) * pitch + (i & (aw - 1))] = __ldg(co + i);
  __syncwarp();
  const Itx<T> f{-(T(1) << (a.bd + 7)), (T(1) << (a.bd + 7)) - 1};
  if (lane < ah)
    row_pass<T>(f, lw, hk, s + lane * pitch, lw - lh == 1 || lh - lw == 1,
                kRowShift[tsz]);
  __syncwarp();
  OutT* out = static_cast<OutT*>(a.planes[plane])
              + static_cast<int64_t>(y) * pw + x;
  const int rows = min(h, ph - y), cols = min(w, pw - x);
  for (int c = lane; c < cols; c += 32)
    col_pass<T, OutT>(f, lh, vk, s + c, pitch, out + c, pw, rows);
}

}  // namespace

// txs: [n, 8] int32 records, coeffs: [n_coeffs] int32, both on the
// device; planes[p]: [h[p], w[p]] contiguous, int16 at bit depths 8 and
// 10, int32 at 12, zero where no record lies (the caller's fill).
// Returns cudaGetLastError().
extern "C" int itx_compose_launch(int64_t n, const void* txs,
                                  const void* coeffs, int64_t n_coeffs,
                                  int np, void* const* planes, const int* h,
                                  const int* w, int bd, void* stream) {
  if (np < 1 || np > kMaxPlanes || n < 0 || n_coeffs < 0
      || (bd != 8 && bd != 10 && bd != 12))
    return cudaErrorInvalidValue;
  Args a = {};
  a.txs = static_cast<const int32_t*>(txs);
  a.coeffs = static_cast<const int32_t*>(coeffs);
  a.n = n;
  a.n_coeffs = n_coeffs;
  a.np = np;
  a.bd = bd;
  for (int p = 0; p < np; ++p) {
    if (h[p] < 0 || w[p] < 0) return cudaErrorInvalidValue;
    a.planes[p] = planes[p];
    a.h[p] = h[p];
    a.w[p] = w[p];
  }
  const int64_t grid = (n + kWarps - 1) / kWarps;
  if (grid == 0) return cudaSuccess;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(Args) = bd == 12 ? itx_kernel<int64_t, int32_t>
                                  : itx_kernel<int32_t, int16_t>;
  ITX_LAUNCH(kernel, static_cast<int>(grid), kThreads, s, a);
  return static_cast<int>(cudaGetLastError());
}
