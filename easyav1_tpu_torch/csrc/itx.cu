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
// transform records and each record's coded rows, packed on the host
// (records.pack_coeff_rows, native av1_pack_coeff_rows): no buckets, no
// padded batches.
//
// What it computes.  A record is [plane, x, y, tx_size, tx_type, eob
// packed with the nonzero box (bits 0-11 eob, 12-17 nzh, 18-23 nzw),
// packed coefficient offset, lossless].  Its coded rows are the first
// nzh rows of its adj_h x adj_w coefficients (a 64-point side keeps its
// first 32), adj_w each, at the offset; every coefficient at or past row
// nzh or column nzw is zero (the decoder's box, av1_tile.c).  For each
// record, as the port's video/av1/itx_ref.py and the reference's
// recon_ref.inverse_transform: the coefficients zero-extended to h x w;
// the 2896/4096 scaling where the sides differ by a factor 2; the row
// pass (the horizontal 1-D kind of tx_type along each row), rounded by
// the size's row shift and clamped to +-2^(bd+7); the column pass; then
// (x + 8) >> 4, stored at (y, x) of its plane and cropped at the plane's
// right and bottom edges.  The 1-D kinds: DCT 4 to 64, ADST 4, 8 and 16,
// flipADST (the ADST's outputs reversed), identity 4 to 64 (x4 at 32 and
// 64, as itx_ref).  Butterfly intermediates are clamped to +-2^(bd+7)
// where itx_ref clamps them.  Rows at or past nzh are zero after the row
// pass (every 1-D kind maps zeros to zeros, and (0 + rnd) >> shift is
// 0), so they are neither staged nor transformed.  A DCT_DCT record whose
// box is 1x1 (an eob of 1 has one) is one value over its block: the 1-D
// DCT of [v, 0, ...] is ihalf(v) at every length, so the chain of
// av1_recon_tmpl.h::itx_dc_value (scaling, ihalf, row shift, clamps,
// ihalf, (x + 8) >> 4) gives it.  Records the decoder never makes are
// skipped, whole: a lossless (WHT) one (the recons decline such frames,
// as the reference's device composer does), an ADST longer than 16, a
// plane, size, type, box or coefficient range out of bounds, a size
// outside its class's range.  Records must not overlap (the decoder's do
// not): each pixel is written by one transform, and the planes are zero
// where none lies.  Their order does not matter.
//
// Integer widths.  Coefficients lie within +-2^(bd+7) (the decoder clamps
// them), and so does every butterfly input.  All state is int32: a sum
// of two clamped values is within 2^(bd+8), ihalf's product within
// 2^(bd+8) x 181 and the rectangular scaling's within 2^(bd+7) x 2896
// (below 2^31 at 12 bits).  What can leave int32 is a product sum: a
// rotation's two products reach 2^(bd+7) x 5793, ADST4's four-term sums
// 2^(bd+7) x 10950 and identity16's product 2^(bd+7) x 11586: below 2^31
// at 8 and 10 bits, above it at 12.  So those products are taken in W,
// int32 at 8 and 10 bits (int16 planes) and int64 at 12 (int32 planes),
// and narrowed after their >> 12, which brings them back within
// 2^(bd+8).
//
// What bounds it on this card: bytes (32 a record, 4 a coded-row
// coefficient, 2 or 4 a plane sample) for most frames, the butterflies'
// integer operations for large dense transforms.  The design:
// - Lane groups sized to the transform.  A record takes g lanes, the
//   power of two that covers its coded rows (at most 32) and its columns
//   (64-wide records run two columns a lane): class 0 (g = 4: 4x4),
//   1 (g = 8: 8x8, 4x8, 8x4), 2 (g = 16), 3 (g = 32, up to 32 wide) and
//   4 (g = 32, 64 wide).  The host writes the records in class order and
//   gives each class's first record; a warp takes 32 / g records of one
//   class, a work item.
// - Persistent CTAs of 4 warps, 4 an SM: 16 warps an SM, 128 registers a
//   thread (dct64 in registers needs them; one kernel holds every
//   class, so the largest sets the count).  A frame of small transforms
//   (32-lane items at most a 16th of its items) launches a second
//   instantiation at 6 CTAs an SM instead: 24 warps, 80 registers, the
//   32- and 64-point paths spilling on the few records that take them.
//   Still one launch a frame.  Each warp walks the work items of every
//   class in turn, round robin over the grid's warps.
// - Asynchronous copies.  Each warp owns a ring of kWarpWords int32 of
//   shared memory (9,280 bytes, 37,120 a CTA, 148,480 an SM), cut by
//   class into depth(C) stages of one work item each: 4 stages of 8 4x4
//   records (192 words with their headers), 4 of 4 8x8 (416), 3 of 2
//   16x16 (656), 2 of one 32-wide (1,160), 1 of one 64-wide (2,184).
//   While a warp computes one item, its next items are on their way:
//   each group checks its record once and writes a header of 8 int32
//   into the stage, and cp.async 16-byte copies bring the coded rows
//   (each packed block starts on a 16-byte boundary), only the columns
//   below nzw rounded up to a power of two of 16-byte pieces; rows sit
//   at a pitch of w + 4 (4 for 4-wide), so that the row pass's 16-byte
//   reads, one row a lane, hit distinct banks.  A DC-only record stages
//   its first 16 bytes alone.
// - Row pass: a lane a coded row (nzh of the group's lanes), in
//   registers, written back in place; __syncwarp; column pass: a lane a
//   column, zeros for rows past nzh.
// - Wide stores.  The column pass writes its outputs back in place, and
//   the group's lanes walk the block's (row, 16-byte piece) pairs: a
//   piece inside the plane whose address is 16- or 8-byte aligned goes
//   out as one or two vector stores, else sample by sample (the right
//   and bottom crops, odd plane widths).  The DC-only fill stores its
//   one value the same way.  A 64-high column (more rows than the stage
//   holds) stores straight from registers, a lane a sample of each row,
//   the group's lanes on neighbouring samples.  Storing the small
//   classes that way too measured within 6% either way on the key
//   frames.
// The first design (a warp a record, all ah rows staged from the dense
// coefficients) is kept as tools/torch_itx_first.cu.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// The launch, as a macro so that a host build can run the kernel
// (tools/torch_itx_host_run.py).
#ifndef ITX_LAUNCH
#define ITX_LAUNCH(kernel, grid, threads, stream, ...) \
  kernel<<<grid, threads, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kWarps = 4;                 // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kCtasPerSm = 4;             // caps registers at 128 a thread
constexpr int kSmallCtasPerSm = 6;        // frames of small transforms
constexpr int kMaxPlanes = 3;
constexpr int kClasses = 5;
// A staged record's header, written by the first lane of its group: two
// int4, (ok: 0 skip, 1 full, 2 DC-only; plane; x; y) and (tx size; tx
// type; nzh | nzw << 8; packed offset)
constexpr int kHead = 8;
constexpr int kWarpWords = 2320;          // a warp's ring of stages

// lanes a record, by class
__host__ __device__ constexpr int group_lanes(int c) {
  return c < 4 ? 4 << c : 32;
}
// int32 words of a record's stage, by class: the largest coded rows x
// pitch of its sizes (4x4, 8x8, 16x16, 32x32, 64x32)
__host__ __device__ constexpr int slot_words(int c) {
  return c == 0 ? 16 : c == 1 ? 96 : c == 2 ? 320 : c == 3 ? 1152 : 2176;
}
// a work item's stage: the records' headers, then their slots
__host__ __device__ constexpr int item_words(int c) {
  return 32 / group_lanes(c) * (kHead + slot_words(c));
}
__host__ __device__ constexpr int depth(int c) {
  return kWarpWords / item_words(c) < 4 ? kWarpWords / item_words(c) : 4;
}
static_assert(depth(4) >= 1 && depth(3) >= 2, "ring too small");

enum { kDct = 0, kAdst = 1, kFlip = 2, kIdtx = 3 };

// log2 of TX_WIDTH and TX_HEIGHT by tx size (video/av1/tables.py)
__constant__ int8_t kLogW[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4,
                                 5, 5, 6, 2, 4, 3, 5, 4, 6};
__constant__ int8_t kLogH[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5,
                                 4, 6, 5, 4, 2, 5, 3, 6, 4};
// records.tx_class by tx size
__constant__ int8_t kClassOf[19] = {0, 1, 2, 3, 4, 1, 1, 2, 2, 3,
                                    3, 3, 4, 2, 2, 3, 3, 3, 4};
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

// 16-byte asynchronous copy global -> shared; the host build copies at
// once.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
#else
  memcpy(smem, gmem, 16);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
#endif
}

// The 1-D transforms of itx_ref, in place on int32 c; W holds the
// products (see "Integer widths").
template <typename W>
struct Itx {
  int32_t mn, mx;

  __device__ __forceinline__ int32_t cl(int32_t x) const {
    return x < mn ? mn : (x > mx ? mx : x);
  }
  static __device__ __forceinline__ int32_t r12(W x) {
    return static_cast<int32_t>((x + 2048) >> 12);
  }
  static __device__ __forceinline__ int32_t half(int32_t x) {
    return (x * 181 + 128) >> 8;
  }
  // (a ca + b cb) rounded at 12 bits
  static __device__ __forceinline__ int32_t dot(int32_t a, int ca, int32_t b,
                                                int cb) {
    return r12(static_cast<W>(a) * ca + static_cast<W>(b) * cb);
  }
  // (a cos(64 - phi) - b cos(phi), a cos(phi) + b cos(64 - phi)), rounded
  static __device__ __forceinline__ void rot(int32_t a, int32_t b, int phi,
                                             int32_t& lo, int32_t& hi) {
    const int c0 = cos128(64 - phi), c1 = cos128(phi);
    lo = dot(a, c0, b, -c1);
    hi = dot(a, c1, b, c0);
  }

  __device__ void dct4(int32_t* c) const {
    const int32_t in0 = c[0], in1 = c[1], in2 = c[2], in3 = c[3];
    const int32_t t0 = half(in0 + in2), t1 = half(in0 - in2);
    const int32_t t2 = dot(in1, 1567, in3, -3784);
    const int32_t t3 = dot(in1, 3784, in3, 1567);
    c[0] = cl(t0 + t3);
    c[1] = cl(t1 + t2);
    c[2] = cl(t1 - t2);
    c[3] = cl(t0 - t3);
  }

  __device__ void dct8(int32_t* c) const {
    int32_t t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = c[2 * i];
    dct4(t);
    const int32_t in1 = c[1], in3 = c[3], in5 = c[5], in7 = c[7];
    const int32_t t4a = dot(in1, 799, in7, -4017);
    const int32_t t7a = dot(in1, 4017, in7, 799);
    const int32_t t5a = dot(in5, 3406, in3, -2276);
    const int32_t t6a = dot(in5, 2276, in3, 3406);
    const int32_t t4 = cl(t4a + t5a), t5b = cl(t4a - t5a);
    const int32_t t7 = cl(t7a + t6a), t6b = cl(t7a - t6a);
    const int32_t o[4] = {t4, half(t6b - t5b), half(t6b + t5b), t7};
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = cl(t[i] + o[3 - i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[4 + i] = cl(t[3 - i] - o[i]);
  }

  __device__ void dct16(int32_t* c) const {
    int32_t t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = c[2 * i];
    dct8(t);
    int32_t t8a, t15a, t9a, t14a, t10a, t13a, t11a, t12a;
    rot(c[1], c[15], 4, t8a, t15a);
    rot(c[9], c[7], 36, t9a, t14a);
    rot(c[5], c[11], 20, t10a, t13a);
    rot(c[13], c[3], 52, t11a, t12a);
    const int32_t t8 = cl(t8a + t9a), t9 = cl(t8a - t9a);
    const int32_t t10 = cl(t11a - t10a), t11 = cl(t11a + t10a);
    const int32_t t12 = cl(t12a + t13a), t13 = cl(t12a - t13a);
    const int32_t t14 = cl(t15a - t14a), t15 = cl(t15a + t14a);
    t9a = dot(t14, 1567, t9, -3784);
    t14a = dot(t14, 3784, t9, 1567);
    t10a = dot(t13, -3784, t10, -1567);
    t13a = dot(t13, 1567, t10, -3784);
    t8a = cl(t8 + t11);
    const int32_t t9b = cl(t9a + t10a), t10b = cl(t9a - t10a);
    t11a = cl(t8 - t11);
    t12a = cl(t15 - t12);
    const int32_t t13b = cl(t14a - t13a), t14b = cl(t14a + t13a);
    t15a = cl(t15 + t12);
    const int32_t o[8] = {t8a, t9b, half(t13b - t10b), half(t12a - t11a),
                          half(t12a + t11a), half(t13b + t10b), t14b, t15a};
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = cl(t[i] + o[7 - i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) c[8 + i] = cl(t[7 - i] - o[i]);
  }

  __device__ void dct32(int32_t* c) const {
    int32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = c[2 * i];
    dct16(t);
    // ta[0..15] = t16a..t31a: rotations of (c[f], c[32 - f]) at
    // f = 1 + 4 bitrev(j), angle 2 + 8 bitrev(j)
    int32_t ta[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = 1 + 4 * bitrev(j, 3);
      rot(c[f], c[32 - f], 2 + 8 * bitrev(j, 3), ta[j], ta[15 - j]);
    }
    const int32_t t16 = cl(ta[0] + ta[1]), t17 = cl(ta[0] - ta[1]);
    const int32_t t18 = cl(ta[3] - ta[2]), t19 = cl(ta[3] + ta[2]);
    const int32_t t20 = cl(ta[4] + ta[5]), t21 = cl(ta[4] - ta[5]);
    const int32_t t22 = cl(ta[7] - ta[6]), t23 = cl(ta[7] + ta[6]);
    const int32_t t24 = cl(ta[8] + ta[9]), t25 = cl(ta[8] - ta[9]);
    const int32_t t26 = cl(ta[11] - ta[10]), t27 = cl(ta[11] + ta[10]);
    const int32_t t28 = cl(ta[12] + ta[13]), t29 = cl(ta[12] - ta[13]);
    const int32_t t30 = cl(ta[15] - ta[14]), t31 = cl(ta[15] + ta[14]);
    const int32_t t17a = dot(t30, 799, t17, -4017);
    const int32_t t30a = dot(t30, 4017, t17, 799);
    const int32_t t18a = dot(t29, -4017, t18, -799);
    const int32_t t29a = dot(t29, 799, t18, -4017);
    const int32_t t21a = dot(t26, 3406, t21, -2276);
    const int32_t t26a = dot(t26, 2276, t21, 3406);
    const int32_t t22a = dot(t25, -2276, t22, -3406);
    const int32_t t25a = dot(t25, 3406, t22, -2276);
    const int32_t t16a = cl(t16 + t19), t17b = cl(t17a + t18a);
    const int32_t t18b = cl(t17a - t18a), t19a = cl(t16 - t19);
    const int32_t t20a = cl(t23 - t20), t21b = cl(t22a - t21a);
    const int32_t t22b = cl(t22a + t21a), t23a = cl(t23 + t20);
    const int32_t t24a = cl(t24 + t27), t25b = cl(t25a + t26a);
    const int32_t t26b = cl(t25a - t26a), t27a = cl(t24 - t27);
    const int32_t t28a = cl(t31 - t28), t29b = cl(t30a - t29a);
    const int32_t t30b = cl(t30a + t29a), t31a = cl(t31 + t28);
    const int32_t t18c = dot(t29b, 1567, t18b, -3784);
    const int32_t t29c = dot(t29b, 3784, t18b, 1567);
    const int32_t t19b = dot(t28a, 1567, t19a, -3784);
    const int32_t t28b = dot(t28a, 3784, t19a, 1567);
    const int32_t t20b = dot(t27a, -3784, t20a, -1567);
    const int32_t t27b = dot(t27a, 1567, t20a, -3784);
    const int32_t t21c = dot(t26b, -3784, t21b, -1567);
    const int32_t t26c = dot(t26b, 1567, t21b, -3784);
    const int32_t u16 = cl(t16a + t23a), u17 = cl(t17b + t22b);
    const int32_t u18 = cl(t18c + t21c), u19 = cl(t19b + t20b);
    const int32_t u20 = cl(t19b - t20b), u21 = cl(t18c - t21c);
    const int32_t u22 = cl(t17b - t22b), u23 = cl(t16a - t23a);
    const int32_t u24 = cl(t31a - t24a), u25 = cl(t30b - t25b);
    const int32_t u26 = cl(t29c - t26c), u27 = cl(t28b - t27b);
    const int32_t u28 = cl(t28b + t27b), u29 = cl(t29c + t26c);
    const int32_t u30 = cl(t30b + t25b), u31 = cl(t31a + t24a);
    const int32_t o[16] = {u16, u17, u18, u19,
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
  __device__ void odd_merge32(int32_t* s) const {
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const int32_t a = s[2 * g], b = s[2 * g + 1];
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
        const int32_t a = s[i], b = s[j];
        const int c0 = cos128(64 - ang), c1 = cos128(ang);
        if (size / 4 <= r && r < size / 2) {
          s[i] = dot(b, c0, a, -c1);
          s[j] = dot(b, c1, a, c0);
        } else if (size / 2 <= r && r < 3 * size / 4) {
          s[i] = dot(b, -c1, a, -c0);
          s[j] = dot(b, c0, a, -c1);
        }
      }
      int32_t t[32];
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
      const int32_t a = s[i], b = s[31 - i];
      s[i] = half(b - a);
      s[31 - i] = half(b + a);
    }
  }

  __device__ void dct64(int32_t* c) const {
    int32_t t[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) t[i] = c[2 * i];
    dct32(t);
    int32_t o[32];
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

  // all in W: its sums of up to four products leave int32 at 12 bits
  __device__ void adst4(int32_t* c) const {
    const W in0 = c[0], in1 = c[1], in2 = c[2], in3 = c[3];
    W s0 = in0 * 1321, s1 = in0 * 2482, s2 = in1 * 3344, s3 = in2 * 3803;
    const W s4 = in2 * 1321, s5 = in3 * 2482, s6 = in3 * 3803;
    const W b7 = (in0 - in2) + in3;
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

  __device__ void adst8(int32_t* c) const {
    const int32_t in0 = c[0], in1 = c[1], in2 = c[2], in3 = c[3];
    const int32_t in4 = c[4], in5 = c[5], in6 = c[6], in7 = c[7];
    int32_t t0a = dot(in7, 4076, in0, 401), t1a = dot(in7, 401, in0, -4076);
    int32_t t2a = dot(in5, 3612, in2, 1931), t3a = dot(in5, 1931, in2, -3612);
    int32_t t4a = dot(in3, 2598, in4, 3166), t5a = dot(in3, 3166, in4, -2598);
    int32_t t6a = dot(in1, 1189, in6, 3920), t7a = dot(in1, 3920, in6, -1189);
    const int32_t t0 = cl(t0a + t4a), t1 = cl(t1a + t5a);
    const int32_t t2 = cl(t2a + t6a), t3 = cl(t3a + t7a);
    const int32_t t4 = cl(t0a - t4a), t5 = cl(t1a - t5a);
    const int32_t t6 = cl(t2a - t6a), t7 = cl(t3a - t7a);
    t4a = dot(t4, 3784, t5, 1567);
    t5a = dot(t4, 1567, t5, -3784);
    t6a = dot(t6, -1567, t7, 3784);
    t7a = dot(t6, 3784, t7, 1567);
    const int32_t t2b = cl(t0 - t2), t3b = cl(t1 - t3);
    const int32_t t6b = cl(t4a - t6a), t7b = cl(t5a - t7a);
    c[0] = cl(t0 + t2);
    c[1] = -cl(t4a + t6a);
    c[2] = half(t6b + t7b);
    c[3] = -half(t2b + t3b);
    c[4] = half(t2b - t3b);
    c[5] = -half(t6b - t7b);
    c[6] = cl(t5a + t7a);
    c[7] = -cl(t1 + t3);
  }

  __device__ void adst16(int32_t* x) const {
    int32_t t0a = dot(x[15], 4091, x[0], 201);
    int32_t t1a = dot(x[15], 201, x[0], -4091);
    int32_t t2a = dot(x[13], 3973, x[2], 995);
    int32_t t3a = dot(x[13], 995, x[2], -3973);
    int32_t t4a = dot(x[11], 3703, x[4], 1751);
    int32_t t5a = dot(x[11], 1751, x[4], -3703);
    int32_t t6a = dot(x[9], 3290, x[6], 2440);
    int32_t t7a = dot(x[9], 2440, x[6], -3290);
    int32_t t8a = dot(x[7], 2751, x[8], 3035);
    int32_t t9a = dot(x[7], 3035, x[8], -2751);
    int32_t t10a = dot(x[5], 2106, x[10], 3513);
    int32_t t11a = dot(x[5], 3513, x[10], -2106);
    int32_t t12a = dot(x[3], 1380, x[12], 3857);
    int32_t t13a = dot(x[3], 3857, x[12], -1380);
    int32_t t14a = dot(x[1], 601, x[14], 4052);
    int32_t t15a = dot(x[1], 4052, x[14], -601);
    const int32_t t0 = cl(t0a + t8a), t1 = cl(t1a + t9a);
    const int32_t t2 = cl(t2a + t10a), t3 = cl(t3a + t11a);
    const int32_t t4 = cl(t4a + t12a), t5 = cl(t5a + t13a);
    const int32_t t6 = cl(t6a + t14a), t7 = cl(t7a + t15a);
    const int32_t t8 = cl(t0a - t8a), t9 = cl(t1a - t9a);
    const int32_t t10 = cl(t2a - t10a), t11 = cl(t3a - t11a);
    const int32_t t12 = cl(t4a - t12a), t13 = cl(t5a - t13a);
    const int32_t t14 = cl(t6a - t14a), t15 = cl(t7a - t15a);
    t8a = dot(t8, 4017, t9, 799);
    t9a = dot(t8, 799, t9, -4017);
    t10a = dot(t10, 2276, t11, 3406);
    t11a = dot(t10, 3406, t11, -2276);
    t12a = dot(t12, -799, t13, 4017);
    t13a = dot(t12, 4017, t13, 799);
    t14a = dot(t14, -3406, t15, 2276);
    t15a = dot(t14, 2276, t15, 3406);
    const int32_t t0b = cl(t0 + t4), t1b = cl(t1 + t5);
    const int32_t t2b = cl(t2 + t6), t3b = cl(t3 + t7);
    const int32_t t4b = cl(t0 - t4), t5b = cl(t1 - t5);
    const int32_t t6b = cl(t2 - t6), t7b = cl(t3 - t7);
    const int32_t t8b = cl(t8a + t12a), t9b = cl(t9a + t13a);
    const int32_t t10b = cl(t10a + t14a), t11b = cl(t11a + t15a);
    const int32_t t12b = cl(t8a - t12a), t13b = cl(t9a - t13a);
    const int32_t t14b = cl(t10a - t14a), t15b = cl(t11a - t15a);
    const int32_t t4c = dot(t4b, 3784, t5b, 1567);
    const int32_t t5c = dot(t4b, 1567, t5b, -3784);
    const int32_t t6c = dot(t6b, -1567, t7b, 3784);
    const int32_t t7c = dot(t6b, 3784, t7b, 1567);
    const int32_t t12c = dot(t12b, 3784, t13b, 1567);
    const int32_t t13c = dot(t12b, 1567, t13b, -3784);
    const int32_t t14c = dot(t14b, -1567, t15b, 3784);
    const int32_t t15c = dot(t14b, 3784, t15b, 1567);
    const int32_t x0 = cl(t0b + t2b), x1 = cl(t1b + t3b);
    const int32_t x2 = cl(t0b - t2b), x3 = cl(t1b - t3b);
    const int32_t x4 = cl(t4c + t6c), x5 = cl(t5c + t7c);
    const int32_t x6 = cl(t4c - t6c), x7 = cl(t5c - t7c);
    const int32_t x8 = cl(t8b + t10b), x9 = cl(t9b + t11b);
    const int32_t x10 = cl(t8b - t10b), x11 = cl(t9b - t11b);
    const int32_t x12 = cl(t12c + t14c), x13 = cl(t13c + t15c);
    const int32_t x14 = cl(t12c - t14c), x15 = cl(t13c - t15c);
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
  __device__ __forceinline__ void tx1d(int kind, int32_t* v) const {
    if (kind == kIdtx) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (N == 4) v[i] = r12(static_cast<W>(v[i]) * 5793);
        else if (N == 8) v[i] = v[i] * 2;
        else if (N == 16) v[i] = r12(static_cast<W>(v[i]) * 11586);
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
            const int32_t s = v[i];
            v[i] = v[N - 1 - i];
            v[N - 1 - i] = s;
          }
        }
      }
    }
  }

  // a DC-only DCT_DCT block's one value (av1_recon_tmpl.h::itx_dc_value)
  __device__ int32_t dc_value(int32_t v, bool rect, int shift) const {
    if (rect) v = (v * 2896 + 2048) >> 12;
    int32_t r = cl(half(v));
    r = cl((r + ((1 << shift) >> 1)) >> shift);
    r = cl(half(r));
    return (r + 8) >> 4;
  }
};

// The row pitch of a record's stage, in int32: 16-byte rows whose
// quarter-warp reads, one row a lane, hit distinct banks.
__device__ __forceinline__ int pitch_of(int w) { return w == 4 ? 4 : w + 4; }

// The row pass of one coded row of N samples in place in shared memory:
// its first min(N, 32) are the coefficients, zero from column nzw.
template <typename W, int N>
__device__ void row_n(const Itx<W>& f, int kind, int32_t* p, int nzw,
                      bool rect, int shift) {
  constexpr int NA = N < 32 ? N : 32;
  int32_t v[N];
#pragma unroll
  for (int j = 0; j < NA; j += 4) {
    if (j < nzw) {
      const int4 q = *reinterpret_cast<const int4*>(p + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    } else {
      v[j] = v[j + 1] = v[j + 2] = v[j + 3] = 0;
    }
  }
#pragma unroll
  for (int j = NA; j < N; ++j) v[j] = 0;
  if (rect) {
#pragma unroll
    for (int j = 0; j < NA; ++j) v[j] = (v[j] * 2896 + 2048) >> 12;
  }
  f.template tx1d<N>(kind, v);
  const int32_t rnd = (1 << shift) >> 1;
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    int4 q;
    q.x = f.cl((v[j] + rnd) >> shift);
    q.y = f.cl((v[j + 1] + rnd) >> shift);
    q.z = f.cl((v[j + 2] + rnd) >> shift);
    q.w = f.cl((v[j + 3] + rnd) >> shift);
    *reinterpret_cast<int4*>(p + j) = q;
  }
}

// The column pass of one column of N samples (pitch apart in shared
// memory, zero from row nzh).  With N up to 32 the outputs go back in
// place, for the wide stores; else its first `rows` outputs are stored
// `dpitch` apart from dst (the group's lanes on neighbouring samples of
// each row).
template <typename W, typename OutT, int N>
__device__ void col_n(const Itx<W>& f, int kind, int32_t* p, int pitch,
                      int nzh, OutT* dst, int64_t dpitch, int rows) {
  constexpr int NA = N < 32 ? N : 32;
  int32_t v[N];
#pragma unroll
  for (int i = 0; i < NA; ++i) v[i] = i < nzh ? p[i * pitch] : 0;
#pragma unroll
  for (int i = NA; i < N; ++i) v[i] = 0;
  f.template tx1d<N>(kind, v);
  if constexpr (N <= 32) {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i * pitch] = (v[i] + 8) >> 4;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < rows) dst[i * dpitch] = static_cast<OutT>((v[i] + 8) >> 4);
  }
}

// The sizes a class holds, by log2 of the side: rows (w) and columns (h)
template <typename W, int C>
__device__ void row_pass(const Itx<W>& f, int lw, int kind, int32_t* p,
                         int nzw, bool rect, int shift) {
  if constexpr (C == 0) {
    row_n<W, 4>(f, kind, p, nzw, rect, shift);
  } else if constexpr (C == 1) {
    if (lw == 2) row_n<W, 4>(f, kind, p, nzw, rect, shift);
    else row_n<W, 8>(f, kind, p, nzw, rect, shift);
  } else if constexpr (C == 2) {
    if (lw == 2) row_n<W, 4>(f, kind, p, nzw, rect, shift);
    else if (lw == 3) row_n<W, 8>(f, kind, p, nzw, rect, shift);
    else row_n<W, 16>(f, kind, p, nzw, rect, shift);
  } else if constexpr (C == 3) {
    if (lw == 3) row_n<W, 8>(f, kind, p, nzw, rect, shift);
    else if (lw == 4) row_n<W, 16>(f, kind, p, nzw, rect, shift);
    else row_n<W, 32>(f, kind, p, nzw, rect, shift);
  } else {
    row_n<W, 64>(f, kind, p, nzw, rect, shift);
  }
}

template <typename W, typename OutT, int C>
__device__ void col_pass(const Itx<W>& f, int lh, int kind, int32_t* p,
                         int pitch, int nzh, OutT* dst, int64_t dpitch,
                         int rows) {
  if constexpr (C == 0) {
    col_n<W, OutT, 4>(f, kind, p, pitch, nzh, dst, dpitch, rows);
  } else if constexpr (C == 1 || C == 2) {
    if (lh == 2)
      col_n<W, OutT, 4>(f, kind, p, pitch, nzh, dst, dpitch, rows);
    else if (C == 1 || lh == 3)
      col_n<W, OutT, 8>(f, kind, p, pitch, nzh, dst, dpitch, rows);
    else
      col_n<W, OutT, 16>(f, kind, p, pitch, nzh, dst, dpitch, rows);
  } else {
    if (C == 3 && lh == 3)
      col_n<W, OutT, 8>(f, kind, p, pitch, nzh, dst, dpitch, rows);
    else if (lh == 4)
      col_n<W, OutT, 16>(f, kind, p, pitch, nzh, dst, dpitch, rows);
    else if (lh == 5)
      col_n<W, OutT, 32>(f, kind, p, pitch, nzh, dst, dpitch, rows);
    else
      col_n<W, OutT, 64>(f, kind, p, pitch, nzh, dst, dpitch, rows);
  }
}

// Stores of 8 and 16 bytes of OutT samples from int32 values
__device__ __forceinline__ uint32_t pack2(int32_t a, int32_t b) {
  return (static_cast<uint32_t>(a) & 0xffffu)
         | (static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ void put8(int16_t* d, const int32_t* v) {
  uint2 q;
  q.x = pack2(v[0], v[1]);
  q.y = pack2(v[2], v[3]);
  *reinterpret_cast<uint2*>(d) = q;
}
__device__ __forceinline__ void put8(int32_t* d, const int32_t* v) {
  int2 q;
  q.x = v[0];
  q.y = v[1];
  *reinterpret_cast<int2*>(d) = q;
}
__device__ __forceinline__ void put16(int16_t* d, const int32_t* v) {
  uint4 q;
  q.x = pack2(v[0], v[1]);
  q.y = pack2(v[2], v[3]);
  q.z = pack2(v[4], v[5]);
  q.w = pack2(v[6], v[7]);
  *reinterpret_cast<uint4*>(d) = q;
}
__device__ __forceinline__ void put16(int32_t* d, const int32_t* v) {
  int4 q;
  q.x = v[0];
  q.y = v[1];
  q.z = v[2];
  q.w = v[3];
  *reinterpret_cast<int4*>(d) = q;
}

// The block's rows x cols (cropped) from the stage p (pitch apart), or
// the value dcv everywhere when p is null: the group's G lanes walk its
// (row, piece) pairs, a piece 16 bytes of OutT (w of them if narrower);
// inside the plane and aligned, one 16-byte or 8-byte vector store, else
// sample by sample.
template <typename OutT, int G>
__device__ void store_block(const int32_t* p, int pitch, int32_t dcv,
                            OutT* out, int64_t pw, int w, int rows, int cols,
                            int gl) {
  constexpr int CW = 16 / static_cast<int>(sizeof(OutT));   // 8 or 4
  constexpr int H8 = CW / 2;                                // 8 bytes
  const int cw = w < CW ? w : CW;
  const int lcpr = w <= CW ? 0 : (w == 2 * CW ? 1 : w == 4 * CW ? 2
                                                 : w == 8 * CW ? 3 : 4);
  const int total = rows << lcpr;
  for (int i = gl; i < total; i += G) {
    const int r = i >> lcpr, c0 = (i & ((1 << lcpr) - 1)) * cw;
    if (c0 >= cols) continue;
    int32_t v[CW];
    if (p) {
      const int32_t* s = p + r * pitch + c0;
#pragma unroll
      for (int e = 0; e < CW; e += 4)
        if (e < cw) {
          const int4 q = *reinterpret_cast<const int4*>(s + e);
          v[e] = q.x;
          v[e + 1] = q.y;
          v[e + 2] = q.z;
          v[e + 3] = q.w;
        }
    } else {
#pragma unroll
      for (int e = 0; e < CW; ++e) v[e] = dcv;
    }
    const int n = cols - c0 < cw ? cols - c0 : cw;
    OutT* d = out + r * pw + c0;
    const uintptr_t at = reinterpret_cast<uintptr_t>(d);
    if (n == CW && at % 16 == 0) {
      put16(d, v);
    } else if (n >= H8 && at % 8 == 0) {
      put8(d, v);
      if (n == CW) put8(d + H8, v + H8);
      else
        for (int e = H8; e < n; ++e) d[e] = static_cast<OutT>(v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < CW; ++e)
        if (e < n) d[e] = static_cast<OutT>(v[e]);
    }
  }
}

struct Args {
  const int32_t* txs;      // [n, 8] records (two int4), in class order
  const int32_t* coeffs;   // [n_coeffs]: the records' coded rows
  int n, n_coeffs;
  int np, bd;
  void* planes[kMaxPlanes];  // [h, w], contiguous: OutT
  int h[kMaxPlanes], w[kMaxPlanes];
  int first[kClasses + 1];   // each class's first record, then n
  int base[kClasses + 1];    // each class's first work item, then all
};

// v[i] for i in 0..2, without indexing the kernel's parameters
template <typename V>
__device__ __forceinline__ V pick(const V* v, int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : v[2];
}

// A group's record as loaded, before its checks: k past the class's
// last record loads nothing (ok stays 0)
struct Raw {
  int4 q0, q1;
  bool in;
};

// The record of this lane's group in work item `it` of class C
template <int C>
__device__ __forceinline__ Raw load_raw(const Args& a, int it, int lane) {
  constexpr int G = group_lanes(C);
  const int k = a.first[C] + it * (32 / G) + lane / G;
  Raw r;
  r.in = k < a.first[C + 1];
  if (r.in) {
    const int4* q = reinterpret_cast<const int4*>(a.txs)
                    + static_cast<int64_t>(k) * 2;
    r.q0 = __ldg(q);
    r.q1 = __ldg(q + 1);
  }
  return r;
}

// Stage a work item of class C from its loaded records into its ring
// stage `st`: each group checks its record (one it must skip gets
// ok = 0: skipped whole), writes its header and copies its coded rows by
// cp.async, columns below nzw rounded up to a power of two of 16-byte
// pieces (a DC-only record: its first 16 bytes, the DC coefficient's).
template <int C>
__device__ __forceinline__ void stage_item(const Args& a, const Raw& r,
                                           int32_t* st, int lane) {
  constexpr int G = group_lanes(C);
  const int j = lane / G, gl = lane % G;
  int32_t* head = st + j * kHead;
  int32_t* s = st + (32 / G) * kHead + j * slot_words(C);
  int ok = 0, plane = 0, x = 0, y = 0, tsz = 0, ttyp = 0, nzh = 0, nzw = 0,
      off = 0;
  if (r.in) {
    plane = r.q0.x;
    x = r.q0.y;
    y = r.q0.z;
    tsz = r.q0.w;
    ttyp = r.q1.x;
    nzh = (r.q1.y >> 12) & 63;
    nzw = (r.q1.y >> 18) & 63;
    off = r.q1.z;
    if (plane >= 0 && plane < a.np && tsz >= 0 && tsz < 19
        && kClassOf[tsz] == C && ttyp >= 0 && ttyp < 16 && r.q1.w == 0
        && x >= 0 && y >= 0 && x < pick(a.w, plane) && y < pick(a.h, plane)) {
      const int law = min(static_cast<int>(kLogW[tsz]), 5);
      const int ah = 1 << min(static_cast<int>(kLogH[tsz]), 5), aw = 1 << law;
      const int vk = kKinds[ttyp][0], hk = kKinds[ttyp][1];
      ok = !(((vk == kAdst || vk == kFlip) && ah > 16)
             || ((hk == kAdst || hk == kFlip) && aw > 16))
           && nzh >= 1 && nzh <= ah && nzw >= 1 && nzw <= aw && off >= 0
           && (off & 3) == 0 && off <= a.n_coeffs - nzh * aw;
      if (ok && ttyp == 0 && nzh == 1 && nzw == 1) {
        ok = 2;                                  // DC-only
        if (gl == 0) cp_async16(s, a.coeffs + off);
      } else if (ok) {
        // pieces a row: a power of two covering nzw, at most aw / 4
        const int lp = min(32 - __clz((nzw + 3) / 4 - 1), law - 2);
        const int pitch = pitch_of(1 << kLogW[tsz]);
        const int32_t* co = a.coeffs + off;
        for (int i = gl; i < nzh << lp; i += G) {
          const int row = i >> lp, col = (i & ((1 << lp) - 1)) * 4;
          cp_async16(s + row * pitch + col, co + row * aw + col);
        }
      }
    }
  }
  if (gl == 0) {
    *reinterpret_cast<int4*>(head) = make_int4(ok, plane, x, y);
    *reinterpret_cast<int4*>(head + 4) =
        make_int4(tsz, ttyp, nzh | nzw << 8, off);
  }
}

// Compute work item `it` of class C from its ring stage `st` and store
// it: a group a record.  Every lane reaches both barriers.
template <typename W, typename OutT, int C>
__device__ __forceinline__ void compute_item(const Args& a, int32_t* st,
                                             int lane) {
  constexpr int G = group_lanes(C);
  const int j = lane / G, gl = lane % G;
  const int4 h0 = *reinterpret_cast<const int4*>(st + j * kHead);
  const int4 h1 = *reinterpret_cast<const int4*>(st + j * kHead + 4);
  int32_t* s = st + (32 / G) * kHead + j * slot_words(C);
  const int ok = h0.x, plane = h0.y, tsz = h1.x, ttyp = h1.y;
  const int nzh = h1.z & 255, nzw = h1.z >> 8;
  const Itx<W> f{-(1 << (a.bd + 7)), (1 << (a.bd + 7)) - 1};
  const int lw = ok ? kLogW[tsz] : 2, lh = ok ? kLogH[tsz] : 2;
  const int w = 1 << lw, h = 1 << lh;
  const int pitch = pitch_of(w);
  const bool rect = lw - lh == 1 || lh - lw == 1;
  const bool full = ok == 1;
  const int pw = ok ? pick(a.w, plane) : 0, ph = ok ? pick(a.h, plane) : 0;
  OutT* out = ok ? static_cast<OutT*>(pick(a.planes, plane))
                       + static_cast<int64_t>(h0.w) * pw + h0.z
                 : nullptr;
  const int rows = min(h, ph - h0.w), cols = min(w, pw - h0.z);
  if (full && gl < nzh)
    row_pass<W, C>(f, lw, kKinds[ttyp][1], s + gl * pitch, nzw, rect,
                   kRowShift[tsz]);
  __syncwarp();
  if (full) {
    // a column stores straight from registers where the stage cannot
    // hold its outputs (h = 64), or without the wide stores: none past
    // cols
    const int vk = kKinds[ttyp][0];
    for (int c = gl; c < w; c += G)
      col_pass<W, OutT, C>(f, lh, vk, s + c, pitch, nzh, out + c, pw,
                           c < cols ? rows : 0);
  }
  __syncwarp();
  if (ok == 2 || (full && h <= 32))
    store_block<OutT, G>(ok == 2 ? nullptr : s, pitch,
                         ok == 2 ? f.dc_value(s[0], rect, kRowShift[tsz]) : 0,
                         out, pw, w, rows, cols, gl);
}

// A warp's walk over class C's work items (gw, gw + stride, ... in the
// numbering of all classes' items), depth(C) of them in its ring at
// once.  (Loading the next item's records before the current item
// computes, to hide their latency, measured slower: the registers that
// hold them across the compute cost more than the wait.)
template <typename W, typename OutT, int C>
__device__ __forceinline__ void walk(const Args& a, int32_t* ring, int lane,
                                     int gw, int stride) {
  constexpr int D = depth(C), IW = item_words(C);
  const int items = a.base[C + 1] - a.base[C];
  if (items == 0) return;
  // this warp's first item of the class
  int it = ((gw - a.base[C]) % stride + stride) % stride;
#pragma unroll
  for (int d = 0; d < D - 1; ++d) {
    if (it + d * stride < items)
      stage_item<C>(a, load_raw<C>(a, it + d * stride, lane), ring + d * IW,
                    lane);
    cp_async_commit();
  }
  for (int k = 0; it < items; it += stride, ++k) {
    const int next = it + (D - 1) * stride;
    if (next < items)
      stage_item<C>(a, load_raw<C>(a, next, lane),
                    ring + ((k + D - 1) % D) * IW, lane);
    cp_async_commit();
    cp_async_wait<D - 1>();   // item `it`'s copies are in
    __syncwarp();
    compute_item<W, OutT, C>(a, ring + (k % D) * IW, lane);
    __syncwarp();             // before its stage is staged again
  }
  cp_async_wait<0>();
  __syncwarp();
}

template <typename W, typename OutT, int CTAS>
__global__ void __launch_bounds__(kThreads, CTAS) itx_kernel(Args a) {
  __shared__ int4 ring4[kWarps][kWarpWords / 4];   // 16-byte aligned
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t* ring = reinterpret_cast<int32_t*>(ring4[warp]);
  const int gw = blockIdx.x * kWarps + warp, stride = gridDim.x * kWarps;
  walk<W, OutT, 0>(a, ring, lane, gw, stride);
  walk<W, OutT, 1>(a, ring, lane, gw, stride);
  walk<W, OutT, 2>(a, ring, lane, gw, stride);
  walk<W, OutT, 3>(a, ring, lane, gw, stride);
  walk<W, OutT, 4>(a, ring, lane, gw, stride);
}

// The instantiation a frame takes (see itx_compose_launch)
template <typename W, typename OutT>
void (*kernel_for(bool small))(Args) {
  if (small) return itx_kernel<W, OutT, kSmallCtasPerSm>;
  return itx_kernel<W, OutT, kCtasPerSm>;
}

}  // namespace

// txs: [n, 8] int32 records in class order and coeffs: [n_coeffs] int32
// coded rows, 16-byte aligned, both on the device (records.
// pack_coeff_rows); class_off: [6] on the host, each class's first
// record, then n; planes[p]: [h[p], w[p]] contiguous, int16 at bit
// depths 8 and 10, int32 at 12, zero where no record lies (the caller's
// fill).  Returns cudaGetLastError().
extern "C" int itx_compose_launch(int64_t n, const void* txs,
                                  const void* coeffs, int64_t n_coeffs,
                                  int np, void* const* planes, const int* h,
                                  const int* w, int bd,
                                  const int64_t* class_off, void* stream) {
  if (np < 1 || np > kMaxPlanes || n < 0 || n > 0x7fffffff || n_coeffs < 0
      || n_coeffs > 0x7fffffff || (bd != 8 && bd != 10 && bd != 12)
      || reinterpret_cast<uintptr_t>(coeffs) % 16 != 0
      || reinterpret_cast<uintptr_t>(txs) % 16 != 0 || class_off[0] != 0
      || class_off[kClasses] != n)
    return cudaErrorInvalidValue;
  Args a = {};
  a.txs = static_cast<const int32_t*>(txs);
  a.coeffs = static_cast<const int32_t*>(coeffs);
  a.n = static_cast<int>(n);
  a.n_coeffs = static_cast<int>(n_coeffs);
  a.np = np;
  a.bd = bd;
  for (int p = 0; p < np; ++p) {
    if (h[p] < 0 || w[p] < 0) return cudaErrorInvalidValue;
    a.planes[p] = planes[p];
    a.h[p] = h[p];
    a.w[p] = w[p];
  }
  a.base[0] = 0;
  for (int c = 0; c <= kClasses; ++c) {
    if (c && class_off[c] < class_off[c - 1]) return cudaErrorInvalidValue;
    a.first[c] = static_cast<int>(class_off[c]);
    if (c) {
      const int per = 32 / group_lanes(c - 1);
      a.base[c] = a.base[c - 1]
                  + static_cast<int>((class_off[c] - class_off[c - 1]
                                      + per - 1) / per);
    }
  }
  const int items = a.base[kClasses];
  if (items == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess || sms < 1)
    sms = 132;
  // A frame whose 32-lane items are at most a 16th of its items (small
  // transforms: the 4K 10-bit key frame's 8x8s) runs at kSmallCtasPerSm
  // CTAs an SM, more warps to hide latency with fewer registers (the 32-
  // and 64-point paths spill there); any other at kCtasPerSm.
  const bool small = 16 * (items - a.base[3]) <= items;
  const int ctas = small ? kSmallCtasPerSm : kCtasPerSm;
  const int want = (items + kWarps - 1) / kWarps;
  const int grid = want < sms * ctas ? want : sms * ctas;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(Args) = bd == 12 ? kernel_for<int64_t, int32_t>(small)
                                  : kernel_for<int32_t, int16_t>(small);
  ITX_LAUNCH(kernel, grid, kThreads, s, a);
  return static_cast<int>(cudaGetLastError());
}
