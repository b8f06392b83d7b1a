// Sequential intra pred-unit executor for Hopper (sm_90a).
//
// Replaces easyav1_tpu/video/av1/recon/intra_pallas.py:make_strip_kernel,
// the JAX package's only Pallas kernel.  Semantics are those of
// exec_ref.UnitExecutor._unit on the records of
// jax_exec.preprocess_units(units, dims, pad=0): for each unit in decode
// order, fetch the above/left edges from the plane, fill them by
// availability, run the 5-tap edge filter and the 2x upsample for the
// directional classes, predict (DC, V, H, Paeth, the three Smooths,
// zones 1-3, filter-intra, palette-zero), add 4:2:0 CfL, and write
// clip(pred + residual) into the plane.  All arithmetic is int32.
//
// What bounds it: the serial chain of units.  Every unit reads pixels the
// units before it wrote, so a plane is one dependency chain; the kernel
// moves few bytes (a 1080p luma plane is 8 MB of int32, resident in the
// 50 MB L2) and does little arithmetic per unit.  The cost is the
// per-unit latency: a handful of __syncthreads() and dependent global
// loads.  wgmma and TMA do not apply.
//
// Design: one CTA per plane walks that plane's units in order (the
// Pallas grid's in-order strips and carried prev_row become a loop inside
// the block; reading the row above straight from the plane gives the
// same values).  The block's threads share one unit's pixels.  Only the
// unit's edge vectors, the CfL AC block and the filter-intra patch buffer
// live in shared memory; the plane stays in global memory.  Luma runs as
// one launch; U and V run as one launch of two CTAs whose CfL reads the
// finished luma.  The TPU kernel's 0/1 selection matmuls and lane rolls
// are plain indexed loads here, and DC uses integer division.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// record fields (jax_exec.F_*) and classes (jax_exec.K_*)
enum {
  F_X, F_Y, F_W, F_H, F_CLS, F_ANGLE, F_HA, F_HL, F_HTR, F_HBL,
  F_SA, F_SL, F_UA, F_UL, F_CF, F_ALPHA, F_ACX, F_ACY, F_ACW, F_ACH,
  F_DX, F_DY, F_MAXXR, F_MAXYR, F_NPXA, F_NPXL, F_NA, F_NL, F_VALID,
  F_RES, NF
};
enum {
  K_DC, K_V, K_H, K_Z1, K_Z2, K_Z3, K_SM, K_SMV, K_SMH, K_PAETH,
  K_CFL, K_ZERO, K_FILT
};

constexpr int THREADS = 256;
constexpr int OFF = 2;       // edge slot of the first pixel (exec_ref.OFF)
constexpr int EDGE = 272;    // >= exec_ref's edge length for w, h <= 64
constexpr int AC_MAX = 4096; // CfL AC block (ac_w * ac_h)
constexpr int W9 = 33;       // filter-intra buffer stride (w, h <= 32)

struct Plane {
  const int32_t* fields;  // [n, NF]
  int n;
  const int16_t* resid;   // [ph, pw]
  int32_t* out;           // [ph, pw]
};

struct Args {
  Plane p[2];
  int ph, pw;
  const int32_t* luma;    // [2 ph, 2 pw] finished luma for CfL, or null
  int lw;
  const int32_t* sm_weights;  // [124]
  const int32_t* fi_taps;     // [5, 8, 8]
  int bd;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// exec_ref._edge_filter: new value of edge[OFF - 1 + i], 1 <= i < sz
__device__ __forceinline__ int edge_tap(const int* e, int sz, int strength,
                                        int i) {
  const int k0 = strength == 3 ? 2 : 0;
  const int k1 = strength == 2 ? 5 : 4;
  const int k2 = strength == 1 ? 8 : (strength == 2 ? 6 : 4);
  const int* s = e + OFF - 1;
  int acc = k0 * s[clampi(i - 2, 0, sz - 1)] + k1 * s[clampi(i - 1, 0, sz - 1)]
          + k2 * s[i] + k1 * s[clampi(i + 1, 0, sz - 1)]
          + k0 * s[clampi(i + 2, 0, sz - 1)];
  return (acc + 8) >> 4;
}

// exec_ref._upsample_edge's dup[k]
__device__ __forceinline__ int dup_at(const int* e, int num, int k) {
  return k < 2 ? e[OFF - 1] : e[OFF + min(k - 2, num - 1)];
}

__device__ __forceinline__ int interp(const int* e, int b, int sh) {
  return (e[OFF + b] * (32 - sh) + e[OFF + b + 1] * sh + 16) >> 5;
}

__global__ void __launch_bounds__(THREADS) intra_strip_kernel(Args a) {
  __shared__ int above[EDGE];
  __shared__ int left[EDGE];
  __shared__ int ac[AC_MAX];
  __shared__ int w9[W9 * W9];
  __shared__ int red[THREADS / 32];
  __shared__ int s_dc, s_avg;

  const Plane P = a.p[blockIdx.x];
  const int ph = a.ph, pw = a.pw;
  const int mx = (1 << a.bd) - 1;
  const int base = 1 << (a.bd - 1);
  const int t = threadIdx.x;
  int32_t* buf = P.out;

  for (int u = 0; u < P.n; ++u) {
    const int32_t* f = P.fields + (size_t)u * NF;
    const int x = __ldg(f + F_X), y = __ldg(f + F_Y);
    const int w = __ldg(f + F_W), h = __ldg(f + F_H);
    const int cls = __ldg(f + F_CLS), ang = __ldg(f + F_ANGLE);
    const bool ha = __ldg(f + F_HA) != 0, hl = __ldg(f + F_HL) != 0;
    const bool is_dir = cls == K_Z1 || cls == K_Z2 || cls == K_Z3;

    // ---- edges (exec_ref._unit: above/left/corner) ----
    int corner;
    if (ha && hl) corner = buf[(y - 1) * pw + x - 1];
    else if (ha) corner = buf[(y - 1) * pw + x];
    else if (hl) corner = buf[y * pw + x - 1];
    else corner = base;
    const int fill_a = hl ? buf[y * pw + x - 1] : base - 1;
    const int fill_l = ha ? buf[(y - 1) * pw + x] : base + 1;
    const int na = __ldg(f + F_NA), nl = __ldg(f + F_NL);
    const int esz = OFF + 2 * (2 * max(w, h) + 1) + 2;
    for (int i = t; i < esz; i += THREADS) {
      int va, vl;
      if (i == OFF - 1) {
        va = vl = corner;
      } else {
        if (ha)
          va = i < OFF ? 0
                       : buf[(y - 1) * pw + min(x + min(i - OFF, na - 1), pw - 1)];
        else
          va = fill_a;
        if (hl)
          vl = i < OFF ? 0
                       : buf[min(y + min(i - OFF, nl - 1), ph - 1) * pw + x - 1];
        else
          vl = fill_l;
      }
      above[i] = va;
      left[i] = vl;
    }
    __syncthreads();

    // ---- directional edge prep: corner filter, edge filter, upsample ----
    const int ua = is_dir && __ldg(f + F_UA) != 0;
    const int ul = is_dir && __ldg(f + F_UL) != 0;
    if (is_dir) {
      if (__ldg(f + F_CF)) {
        const int s = (left[OFF] * 5 + above[OFF - 1] * 6 + above[OFF] * 5 + 8) >> 4;
        __syncthreads();
        if (t == 0) above[OFF - 1] = left[OFF - 1] = s;
        __syncthreads();
      }
      const int sa = __ldg(f + F_SA), sl = __ldg(f + F_SL);
      const int sza = __ldg(f + F_NPXA), szl = __ldg(f + F_NPXL);
      const bool fa = ha && sa != 0 && sza > 1 && t >= 1 && t < sza;
      const bool fl = hl && sl != 0 && szl > 1 && t >= 1 && t < szl;
      const int va = fa ? edge_tap(above, sza, sa, t) : 0;
      const int vl = fl ? edge_tap(left, szl, sl, t) : 0;
      __syncthreads();
      if (fa) above[OFF - 1 + t] = va;
      if (fl) left[OFF - 1 + t] = vl;
      __syncthreads();
      if (ua || ul) {
        const int nua = w + (ang < 90 ? h : 0);
        const int nul = h + (ang > 180 ? w : 0);
        int sa_v = 0, pa_v = 0, sl_v = 0, pl_v = 0;
        const int ca = above[OFF - 1], cl = left[OFF - 1];
        const bool da = ua && t < nua, dl = ul && t < nul;
        if (da) {
          sa_v = -dup_at(above, nua, t) + 9 * dup_at(above, nua, t + 1)
               + 9 * dup_at(above, nua, t + 2) - dup_at(above, nua, t + 3);
          sa_v = clampi((sa_v + 8) >> 4, 0, mx);
          pa_v = above[OFF + t];
        }
        if (dl) {
          sl_v = -dup_at(left, nul, t) + 9 * dup_at(left, nul, t + 1)
               + 9 * dup_at(left, nul, t + 2) - dup_at(left, nul, t + 3);
          sl_v = clampi((sl_v + 8) >> 4, 0, mx);
          pl_v = left[OFF + t];
        }
        __syncthreads();
        if (da) {
          above[OFF - 1 + 2 * t] = sa_v;
          above[OFF + 2 * t] = pa_v;
        }
        if (dl) {
          left[OFF - 1 + 2 * t] = sl_v;
          left[OFF + 2 * t] = pl_v;
        }
        if (t == 0) {
          if (ua) above[OFF - 2] = ca;
          if (ul) left[OFF - 2] = cl;
        }
        __syncthreads();
      }
    }

    // ---- DC average (DC and CfL) ----
    if (cls == K_DC || cls == K_CFL) {
      if (t < 32) {
        int s_a = 0, s_l = 0;
        for (int i = t; i < w; i += 32) s_a += above[OFF + i];
        for (int i = t; i < h; i += 32) s_l += left[OFF + i];
        s_a = warp_sum(s_a);
        s_l = warp_sum(s_l);
        if (t == 0) {
          int avg = base;
          if (ha && hl) avg = (s_a + s_l + ((w + h) >> 1)) / (w + h);
          else if (ha) avg = (s_a + (w >> 1)) / w;
          else if (hl) avg = (s_l + (h >> 1)) / h;
          s_dc = avg;
        }
      }
    }

    // ---- CfL AC block from the finished luma (4:2:0) ----
    const int alpha = __ldg(f + F_ALPHA);
    const bool cfl = cls == K_CFL && alpha != 0;
    const int acx = __ldg(f + F_ACX), acy = __ldg(f + F_ACY);
    const int acw = __ldg(f + F_ACW), ach = __ldg(f + F_ACH);
    if (cfl) {
      int part = 0;
      for (int k = t; k < acw * ach; k += THREADS) {
        const int r = k / acw, c = k - r * acw;
        const int32_t* l0 = a.luma + (size_t)(2 * (acy + r)) * a.lw + 2 * (acx + c);
        const int v = (__ldg(l0) + __ldg(l0 + 1) + __ldg(l0 + a.lw)
                       + __ldg(l0 + a.lw + 1)) << 1;
        ac[k] = v;
        part += v;
      }
      part = warp_sum(part);
      if ((t & 31) == 0) red[t >> 5] = part;
      __syncthreads();
      if (t < 32) {
        int tot = t < THREADS / 32 ? red[t] : 0;
        tot = warp_sum(tot);
        if (t == 0) {
          const int l2 = (31 - __clz(max(acw, 1))) + (31 - __clz(max(ach, 1)));
          s_avg = (tot + (1 << max(l2 - 1, 0))) >> l2;
        }
      }
    }

    // ---- filter-intra: 4x2 patches on anti-diagonal wavefronts ----
    if (cls == K_FILT) {
      for (int k = t; k <= w; k += THREADS) w9[k] = k == 0 ? corner : above[OFF + k - 1];
      for (int k = t; k < h; k += THREADS) w9[(k + 1) * W9] = left[OFF + k];
      __syncthreads();
      const int32_t* taps = a.fi_taps + clampi(ang, 0, 4) * 64;
      const int n_w = w >> 2, n_h = h >> 1;
      const int pi = t >> 3, k = t & 7;
      // patch (i, j) reads patches (i-1, j-1), (i-1, j) and (i, j-1):
      // every patch of the diagonal i + j = d runs at once
      for (int d = 0; d < n_w + n_h - 1; ++d) {
        const int i = max(0, d - n_w + 1) + pi;
        const int j = d - i;
        if (i <= min(d, n_h - 1) && j >= 0) {
          const int y0 = 2 * i, x0 = 4 * j;
          const int* r0 = w9 + y0 * W9 + x0;
          const int32_t* tk = taps + k * 8;
          const int s = __ldg(tk) * r0[0] + __ldg(tk + 1) * r0[1]
                      + __ldg(tk + 2) * r0[2] + __ldg(tk + 3) * r0[3]
                      + __ldg(tk + 4) * r0[4] + __ldg(tk + 5) * r0[W9]
                      + __ldg(tk + 6) * r0[2 * W9];
          w9[(y0 + 1 + (k >> 2)) * W9 + x0 + 1 + (k & 3)] = clampi((s + 8) >> 4, 0, mx);
        }
        __syncthreads();
      }
    }
    __syncthreads();

    // ---- predict, CfL, blend clip(pred + residual) into the plane ----
    const int cw = min(w, pw - x), chh = min(h, ph - y);
    const int offx = x - acx, offy = y - acy;
    const int oh = min(h, ach - offy), ow = min(w, acw - offx);
    const int ua_sh = 6 - ua, ul_sh = 6 - ul;
    const int dx = __ldg(f + F_DX), dy = __ldg(f + F_DY);
    for (int k = t; k < cw * chh; k += THREADS) {
      const int i = k / cw, j = k - i * cw;
      int p;
      switch (cls) {
        case K_DC:
        case K_CFL:
          p = s_dc;
          break;
        case K_V:
          p = above[OFF + j];
          break;
        case K_H:
          p = left[OFF + i];
          break;
        case K_PAETH: {
          const int bv = above[OFF + j], lv = left[OFF + i];
          const int pp = bv + lv - corner;
          const int pb = abs(pp - bv), pl = abs(pp - lv), pc = abs(pp - corner);
          p = (pl <= pb && pl <= pc) ? lv : (pb <= pc ? bv : corner);
          break;
        }
        case K_SM:
        case K_SMV:
        case K_SMH: {
          const int wy = __ldg(a.sm_weights + h - 4 + i);
          const int wx = __ldg(a.sm_weights + w - 4 + j);
          const int below = left[OFF + h - 1], right = above[OFF + w - 1];
          if (cls == K_SM)
            p = (wy * above[OFF + j] + (256 - wy) * below + wx * left[OFF + i]
                 + (256 - wx) * right + 256) >> 9;
          else if (cls == K_SMV)
            p = (wy * above[OFF + j] + (256 - wy) * below + 128) >> 8;
          else
            p = (wx * left[OFF + i] + (256 - wx) * right + 128) >> 8;
          break;
        }
        case K_Z1: {
          const int max_base = (w + h - 1) << ua;
          const int idx = (i + 1) * dx;
          const int b = (idx >> ua_sh) + (j << ua);
          const int sh = ((idx << ua) >> 1) & 0x1F;
          p = b >= max_base ? above[OFF + max_base] : interp(above, b, sh);
          break;
        }
        case K_Z3: {
          const int max_base = (w + h - 1) << ul;
          const int idy = (j + 1) * dy;
          const int b = (idy >> ul_sh) + (i << ul);
          const int sh = ((idy << ul) >> 1) & 0x1F;
          p = b >= max_base ? left[OFF + max_base] : interp(left, b, sh);
          break;
        }
        case K_Z2: {
          const int idx = j * 64 - (i + 1) * dx;
          const int b = idx >> ua_sh;
          if (b >= -(1 << ua)) {
            p = interp(above, max(b, -2), (idx * (1 << ua) >> 1) & 0x1F);
          } else {
            const int idy = i * 64 - (j + 1) * dy;
            p = interp(left, max(idy >> ul_sh, -2), (idy * (1 << ul) >> 1) & 0x1F);
          }
          break;
        }
        case K_FILT:
          p = w9[(i + 1) * W9 + j + 1];
          break;
        default:  // K_ZERO: palette, prediction folded into the residual
          p = 0;
          break;
      }
      if (cfl && i < oh && j < ow) {
        const int d = alpha * (ac[(offy + i) * acw + offx + j] - s_avg);
        const int sc = d < 0 ? -((-d + 32) >> 6) : ((d + 32) >> 6);
        p = clampi(p + sc, 0, mx);
      }
      const int o = (y + i) * pw + x + j;
      buf[o] = clampi(p + P.resid[o], 0, mx);
    }
    // the next unit's edge fetch reads these pixels
    __syncthreads();
  }
}

}  // namespace

// Launch the executor over one or two planes of the same dims (one CTA
// each) on `stream`.  Returns the cudaError_t of the launch.
extern "C" int intra_strip_launch(int nplanes,
                                  const void* fields0, int n0,
                                  const void* resid0, void* out0,
                                  const void* fields1, int n1,
                                  const void* resid1, void* out1,
                                  int ph, int pw, const void* luma,
                                  const void* sm_weights, const void* fi_taps,
                                  int bd, void* stream) {
  Args a;
  a.p[0] = {static_cast<const int32_t*>(fields0), n0,
            static_cast<const int16_t*>(resid0), static_cast<int32_t*>(out0)};
  a.p[1] = {static_cast<const int32_t*>(fields1), n1,
            static_cast<const int16_t*>(resid1), static_cast<int32_t*>(out1)};
  a.ph = ph;
  a.pw = pw;
  a.luma = static_cast<const int32_t*>(luma);
  a.lw = 2 * pw;
  a.sm_weights = static_cast<const int32_t*>(sm_weights);
  a.fi_taps = static_cast<const int32_t*>(fi_taps);
  a.bd = bd;
  intra_strip_kernel<<<nplanes, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
