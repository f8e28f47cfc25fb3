// L1 (redesigned): the sphere positions of MPA and ROT for Hopper
// (sm_90a), one thread a position, one launch a call.
//
// Replaces no Pallas kernel: the JAX package computes these positions in
// float32 code that XLA's CPU backend compiles (the merged positions as
// one jit, vvc_mm_tpu/common/mm/frame_codec.py:344-360; the searches'
// inside their jits; the rest op by op), calling glibc's float32 sinf /
// cosf / tanf / atan2f.  The port's plain version is that float32 chain in
// torch operations (common/mm/models.py, lib360/projection.py), with
// glibc's functions copied (common/libm_f32.py) and each FMA that XLA
// contracts emulated in float64: a few hundred eager operations and 8-20
// elementwise launches a model.  Here one thread runs a position's whole
// chain in registers: it reads its block's MV (and model index), the grid
// constant it needs (the MPA perspective cache, or the grid's sphere
// points folded in double), and writes the int32 position.
//
//  sphere_positions  per-subblock positions, (K, ny, nx, 2): K fields,
//                    each with n_models MV layers and a per-block model
//                    index; row_step / col_step keep every row_step-th
//                    subblock row and col_step-th column.  CLASSIC is its
//                    integer formula; MPA (three planes) and ROT take the
//                    form the caller names: op by op (FORM_OP), the jit of
//                    the merged positions (FORM_MERGED) or of the merge
//                    search (FORM_SEARCH).  A model of code SKIP (3DT, TAN,
//                    GED) is left to the caller, who fills its positions
//                    first.
//  sphere_centers    block-centre positions, (K, nby, nbx, 2): each block
//                    centre moved by its block's model and MV, as the
//                    position of the block's top-left sample; op by op
//                    (FORM_OP) or as the JAX codec's search jits compile
//                    it (FORM_SEARCH: MPA's mpa_center_fused, ROT's merged
//                    form at the centre's own sphere point).
//
// Every operation is the plain chain's, in its order: products, sums and
// differences are __fmul_rn / __fadd_rn / __fsub_rn, each FMA that XLA
// contracts __fmaf_rn, each division __fdiv_rn (projection.div is a true
// division), the square root __fsqrt_rn (libm_f32.sqrtf rounds a double
// square root once), and the source is built with -fmad=false besides.
// Every constant that the plain code writes as a Python scalar comes in
// from Python as the float32 it rounds to (Consts).  rsqrt is XLA's:
// RSQRTSS's estimate from the 2048-entry table of libm_f32._rsqrt_table,
// read through __ldg, then two Newton steps of FMAs.  torch.clamp passes a
// NaN through, and so does clamp1 here; NaN becomes no motion at the end,
// as in reprojection.reproject_frame.
//
// Bound.  Bytes: each block's MVs and model index, the grid constants and
// 8 bytes a position, once; operations: the float32 operations of the
// chain and of glibc's atan2f / tanf, and the float64 work of glibc's sinf /
// cosf, that a position runs (chip_smoke.py's sphere_bound counts them).
// A ROT block's terms (its centre's angles, the sines and cosines of its
// rotations: 14 of ROT's 16 glibc calls in the merged form) are the same
// for each of its subblocks, and each thread recomputes them: computing
// them once a block into shared memory paid only on fields of ROT alone,
// not on the merged call of five models (PERF.md, PR 14).

#define LIBM_FN __device__ __noinline__
#include "libm_f32.cuh"

// the launch's arguments: types with external linkage, as the C entry
// points take them
namespace sphere {

constexpr int MAXM = 8;
constexpr int THREADS = 128;
enum Code { SKIP = -1, CLASSIC = 0, MPA_FB = 1, MPA_LR = 2, MPA_TB = 3,
            ROT = 6 };
enum Form { FORM_OP = 0, FORM_MERGED = 1, FORM_SEARCH = 2 };

// The float32 values of the plain code's Python scalars
struct Consts {
  float offset;        // the subblock grid's offset (MMOffset4x4)
  float po;            // ERP pixel offset
  float width;         // float32(W)
  float height;        // float32(H)
  float pi;            // float32(PI)
  float two_pi;        // float32(2 PI)
  float half_pi;       // float32(PI / 2)
  float angle_res;     // float32(PI / H)
  float focal;         // float32(ERP focal), the MPA plane's focal
  float focal_recip;   // recip32(focal)
  float neg_recip_2pi; // -recip32(2 PI)
  float y_scale;       // float32(recip32(PI)) * float32(H)
  float persp_c;       // the perspective plane's centre (cx = cy)
  float half;          // (block size - 1) / 2
};

struct Args {
  const int32_t* mvs;        // (K, n_models, nby, nbx, 2), 1/16 pel
  const int32_t* midx;       // (K, nby, nbx) model slot, or null: slot 0
  const int64_t* rsqrt_tab;  // RSQRTSS's 2048 estimates (float32 words)
  int32_t* out;              // (K, ny, nx, 2)
  const float* ga[MAXM];     // per slot: MPA cache px, ROT folded x
  const float* gb[MAXM];     // MPA cache py, ROT folded y
  const float* gc[MAXM];     // ROT folded z
  const uint8_t* vip[MAXM];  // MPA cache: behind the camera
  int code[MAXM];
  // sy0: the frame's subblock row of the grid's row 0 (a row slab's
  // origin): the models run at absolute rows, positions come out
  // relative to the slab
  int n_models, k, nby, nbx, bs, row_step, col_step, ny, nx, grid_w, form,
      sy0;
  Consts c;
};

}  // namespace sphere

namespace {

using namespace sphere;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ float sqrt32(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float sin_(float a) { return g_sincosf(a, false); }
__device__ __forceinline__ float cos_(float a) { return g_sincosf(a, true); }
__device__ __forceinline__ float atan_(float a) { return g_atan2f(a, 1.0f); }
// torch.clamp(v, -1, 1): a NaN stays NaN (fminf / fmaxf would drop it)
__device__ __forceinline__ float clamp1(float v) {
  return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}
// lm.acos: atan2(sqrt((1 - x)(x + 1)), x)
__device__ __forceinline__ float acos_(float x) {
  return g_atan2f(sqrt32(mul(sub(1.0f, x), add(x, 1.0f))), x);
}

// libm_f32.rsqrt_xla
__device__ float rsqrt_xla(float x, const int64_t* __restrict__ tab) {
  const uint32_t u = __float_as_uint(x);
  const int e = (u >> 23) & 0xff;
  const int par = (e - 127) & 1;
  const int64_t half = (e - 127 - par) / 2;      // e - 127 - par is even
  const int64_t est = __ldg(tab + par * 1024 + ((u >> 13) & 1023));
  float y = __uint_as_float(
      static_cast<uint32_t>((est - half * (1LL << 23)) & 0xffffffffLL));
  const bool normal = e > 0 && e < 255 && (u >> 31) == 0;
  if (!normal) {
    const float inf = __uint_as_float(0x7f800000u);
    if (e == 0) return (u >> 31) ? -inf : inf;
    return x == inf ? 0.0f : __uint_as_float(0x7fc00000u);
  }
  for (int i = 0; i < 2; ++i) {
    const float err = fma32(mul(x, y), y, -1.0f);
    y = fma32(mul(y, -0.5f), err, y);
  }
  return y;
}

struct V3 { float x, y, z; };

// ERP.to_sphere, op by op
__device__ V3 erp_to_sphere(const Consts& c, float x, float y) {
  const float phi = mul(mul(-fdiv(add(x, c.po), c.width), 2.0f), c.pi);
  const float theta = mul(fdiv(add(y, c.po), c.height), c.pi);
  const float st = sin_(theta);
  return {mul(st, cos_(phi)), mul(st, sin_(phi)), cos_(theta)};
}

// cartesian_to_spherical's angles, op by op
__device__ void to_spherical(float x, float y, float z, float* theta,
                             float* phi) {
  const float r = sqrt32(add(add(mul(x, x), mul(y, y)), mul(z, z)));
  *theta = acos_(clamp1(fdiv(z, r)));
  *phi = g_atan2f(y, x);
}

// ERP.from_sphere, op by op
__device__ void erp_from_sphere(const Consts& c, V3 p, float* ox, float* oy) {
  float theta, phi;
  to_spherical(p.x, p.y, p.z, &theta, &phi);
  if (phi > 0.0f) phi = sub(phi, c.two_pi);
  *ox = sub(mul(-fdiv(phi, c.two_pi), c.width), c.po);
  *oy = sub(mul(fdiv(theta, c.pi), c.height), c.po);
}

// ERP.from_sphere_fused: z / r as z * rsqrt(ss); phi of (x, y)
__device__ void erp_from_sphere_fused(const Consts& c,
                                      const int64_t* __restrict__ tab, V3 p,
                                      float ss, float* ox, float* oy) {
  const float theta = acos_(clamp1(mul(rsqrt_xla(ss, tab), p.z)));
  float phi = g_atan2f(p.y, p.x);
  if (phi > 0.0f) phi = sub(phi, c.two_pi);
  *ox = sub(mul(mul(phi, c.neg_recip_2pi), c.width), c.po);
  *oy = sub(mul(theta, c.y_scale), c.po);
}

// models._mpa_axes_to_plane / _mpa_axes_from_plane
__device__ V3 axes_to_plane(int plane, V3 p) {
  if (plane == MPA_LR) return {p.y, -p.x, p.z};
  if (plane == MPA_TB) return {-p.z, p.y, p.x};
  return p;
}
__device__ V3 axes_from_plane(int plane, V3 p) {
  if (plane == MPA_LR) return {-p.y, p.x, p.z};
  if (plane == MPA_TB) return {p.z, p.y, -p.x};
  return p;
}

// theta and phi of a point behind the camera (vip), as Perspective does
__device__ void vip_turn(const Consts& c, bool vip, float* theta, float* phi) {
  const float vipf = vip ? 1.0f : 0.0f;
  *theta = sub(*theta, mul(vipf, sub(mul(2.0f, *theta), c.pi)));
  *phi = sub(*phi, mul(vipf, c.pi));
}

// models.mpa_to_perspective of one point, op by op (the block-centre arm)
__device__ void mpa_to_perspective(const Consts& c, int plane, float x,
                                   float y, float* px, float* py, bool* vip) {
  const V3 p = axes_to_plane(plane, erp_to_sphere(c, x, y));
  float theta, phi;
  to_spherical(p.y, -p.z, -p.x, &theta, &phi);
  const float r = mul(g_tanf(theta), c.focal);
  *px = add(mul(r, cos_(phi)), c.persp_c);
  *py = add(mul(r, sin_(phi)), c.persp_c);
  *vip = r < 0.0f;
}

// models.mpa_from_perspective, op by op
__device__ void mpa_back(const Consts& c, int plane, float x, float y,
                         bool vip, float* ox, float* oy) {
  const float xs = sub(x, c.persp_c), ys = sub(y, c.persp_c);
  const float r = sqrt32(add(mul(xs, xs), mul(ys, ys)));
  float phi = g_atan2f(ys, xs);
  float theta = atan_(fdiv(r, c.focal));
  vip_turn(c, vip, &theta, &phi);
  const float st = sin_(theta);
  const float sx = mul(st, cos_(phi)), sy = mul(st, sin_(phi));
  const float sz = cos_(theta);
  erp_from_sphere(c, axes_from_plane(plane, {-sz, sx, -sy}), ox, oy);
}

// models.mpa_from_perspective_fused: the merged positions' jit (and the
// merge search's, the same)
__device__ void mpa_back_fused(const Consts& c,
                               const int64_t* __restrict__ tab, int plane,
                               float x, float y, bool vip, float* ox,
                               float* oy) {
  const float r = sqrt32(fma32(x, x, mul(y, y)));
  float phi = g_atan2f(y, x);
  float theta = atan_(mul(r, c.focal_recip));
  vip_turn(c, vip, &theta, &phi);
  const float ct = cos_(theta), st = sin_(theta);
  const float cp = cos_(phi), sp = sin_(phi);
  const float a = mul(st, cp), b = mul(st, sp);
  const float ss = plane == MPA_TB ? fma32(ct, ct, fma32(b, b, mul(a, a)))
                                   : fma32(b, b, fma32(ct, ct, mul(a, a)));
  erp_from_sphere_fused(c, tab, axes_from_plane(plane, {-ct, a, -b}), ss, ox,
                        oy);
}

// models.mpa_center_motion_fused: MPA's motion of a block centre in the
// JAX codec's search jits
__device__ void mpa_center_fused(const Consts& c,
                                 const int64_t* __restrict__ tab, int plane,
                                 float cx, float cy, float mvx, float mvy,
                                 float* ox, float* oy) {
  const float phi = mul(mul(-fdiv(add(cx, c.po), c.width), 2.0f), c.pi);
  const float theta = mul(fdiv(add(cy, c.po), c.height), c.pi);
  const float cp = cos_(phi), sp = sin_(phi);
  const float st = sin_(theta), ct = cos_(theta);
  const float ct2 = mul(ct, ct);
  const float a = mul(st, cp), b = mul(st, sp);
  float p, q, r, ss;
  if (plane == MPA_TB) {
    p = b; q = -a; r = ct;
    ss = add(fma32(p, p, mul(q, q)), ct2);
  } else {
    if (plane == MPA_FB) { p = b; q = -ct; r = -a; }
    else { p = -a; q = -ct; r = -b; }
    ss = fma32(r, r, fma32(p, p, ct2));
  }
  const float theta_p = acos_(clamp1(mul(rsqrt_xla(ss, tab), r)));
  const float phi_p = g_atan2f(q, p);
  const float radius = mul(g_tanf(theta_p), c.focal);
  const bool vip = radius < 0.0f;
  const float sign = vip ? -1.0f : 1.0f;
  const float px = fma32(radius, cos_(phi_p), mul(mvx, sign));
  const float py = fma32(radius, sin_(phi_p), mul(mvy, sign));
  mpa_back_fused(c, tab, plane, px, py, vip, ox, oy);
}

// models._rot_z / _rot_y, by the rotation angle's cosine and sine
__device__ V3 rot_z(float ca, float sa, V3 p) {
  return {sub(mul(p.x, ca), mul(p.y, sa)), add(mul(p.x, sa), mul(p.y, ca)),
          p.z};
}
__device__ V3 rot_y(float ca, float sa, V3 p) {
  return {add(mul(p.x, ca), mul(p.z, sa)), p.y,
          add(mul(-p.x, sa), mul(p.z, ca))};
}

// A ROT block's terms, the same for each of its subblocks: the cosines and
// sines of its rotations' angles.  Op by op (models.rot_motion) the six
// rotations -phi_c, beta, the MV's two, -beta and phi_c; in the fused
// forms (models._rot_motion_fused, with _center_spherical_fused) phi_c,
// beta and the MV's two angles.
struct RotTerms { float cs[12]; };

__device__ RotTerms rot_terms(const Consts& c, const int64_t* __restrict__ tab,
                              int form, float mvx, float mvy, float cx,
                              float cy) {
  RotTerms t;
  const float a = mul(mvy, c.angle_res), b = mul(-mvx, c.angle_res);
  const V3 s = erp_to_sphere(c, cx, cy);
  float theta_c, phi_c;
  if (form == FORM_OP) {
    to_spherical(s.x, s.y, s.z, &theta_c, &phi_c);
  } else {
    const float sxy = fma32(s.x, s.x, mul(s.y, s.y));
    const float ssc = form == FORM_SEARCH ? fma32(s.z, s.z, sxy)
                                          : add(mul(s.z, s.z), sxy);
    theta_c = acos_(clamp1(mul(s.z, rsqrt_xla(ssc, tab))));
    phi_c = g_atan2f(s.y, s.x);
  }
  const float beta = sub(c.half_pi, theta_c);
  const float op[6] = {-phi_c, beta, a, b, -beta, phi_c};
  const float fused[4] = {phi_c, beta, a, b};
  const int n = form == FORM_OP ? 6 : 4;
  for (int i = 0; i < n; ++i) {
    const float ang = form == FORM_OP ? op[i] : fused[i];
    t.cs[2 * i] = cos_(ang);
    t.cs[2 * i + 1] = sin_(ang);
  }
  return t;
}

// models.rot_motion, op by op, at the grid point (gx, gy)
__device__ void rot_op(const Consts& c, const float* cs, float gx, float gy,
                       float* ox, float* oy) {
  const V3 q = rot_y(cs[2], cs[3], rot_z(cs[0], cs[1],
                                         erp_to_sphere(c, gx, gy)));
  const V3 r = rot_z(cs[6], cs[7], rot_y(cs[4], cs[5], q));
  erp_from_sphere(c, rot_z(cs[10], cs[11], rot_y(cs[8], cs[9], r)), ox, oy);
}

// models._rot_motion_fused: the merged positions' jit (grid point p folded
// in double) or, with search, the merge search's (p op by op)
__device__ void rot_fused(const Consts& c, const int64_t* __restrict__ tab,
                          const float* cs, V3 p, bool search, float* ox,
                          float* oy) {
  const float cf = cs[0], sf = cs[1], cb = cs[2], sb = cs[3];
  const float ca = cs[4], sa = cs[5], cm = cs[6], sm = cs[7];
  const float x1 = fma32(cf, p.x, mul(sf, p.y));
  const float y1 = fma32(cf, p.y, -mul(sf, p.x));
  const float x2 = search ? fma32(p.z, sb, mul(cb, x1))
                          : fma32(x1, cb, mul(p.z, sb));
  const float z2 = fma32(p.z, cb, -mul(x1, sb));
  const float x3 = fma32(x2, ca, mul(z2, sa));
  const float z3 = fma32(z2, ca, -mul(x2, sa));
  const float x4 = fma32(cm, x3, -mul(y1, sm));
  const float y4 = fma32(y1, cm, mul(sm, x3));
  const float x5 = fma32(cb, x4, -mul(sb, z3));
  const float z5 = search ? fma32(x4, sb, mul(z3, cb))
                          : fma32(cb, z3, mul(sb, x4));
  float x6 = fma32(cf, x5, -mul(sf, y4));
  float y6 = fma32(cf, y4, mul(sf, x5));
  const float ss = fma32(z5, z5, fma32(x6, x6, mul(y6, y6)));
  if (search) {
    const float y4_phi = fma32(x3, sm, mul(y1, cm));
    x6 = fma32(cf, x5, -mul(sf, y4_phi));
    y6 = fma32(cf, y4_phi, mul(sf, x5));
  }
  erp_from_sphere_fused(c, tab, {x6, y6, z5}, ss, ox, oy);
}

// round(v * 16) to int32, as torch.round(...).to(torch.int32)
__device__ __forceinline__ int32_t fixed16(float v) {
  return static_cast<int32_t>(rintf(mul(v, 16.0f)));
}

__device__ __forceinline__ float mv_pel(int32_t v) {
  return fdiv(static_cast<float>(v), 16.0f);
}

// The kept subblock (k, sy, sx)'s position into o.
__device__ __forceinline__ void position(const Args& a, int k, int sy, int sx,
                                         int32_t* o) {
  const Consts& c = a.c;
  const int rep = a.bs / 4;
  const int by = sy / rep, bx = sx / rep;
  const int64_t blk = (static_cast<int64_t>(k) * a.nby + by) * a.nbx + bx;
  const int slot = a.midx ? a.midx[blk] : 0;
  const int code = a.code[slot];
  if (code == SKIP) return;
  const int32_t* mv =
      a.mvs + (((static_cast<int64_t>(k) * a.n_models + slot) * a.nby + by)
                   * a.nbx + bx) * 2;
  if (code == CLASSIC) {                  // mc.classic_positions
    o[0] = sx * 64 + mv[0];
    o[1] = sy * 64 + mv[1];
    return;
  }
  const float mvx = mv_pel(mv[0]), mvy = mv_pel(mv[1]);
  const float gx = add(mul(static_cast<float>(sx), 4.0f), c.offset);
  const float gy = add(mul(static_cast<float>(sy + a.sy0), 4.0f), c.offset);
  const int64_t g = static_cast<int64_t>(sy) * a.grid_w + sx;
  float ox, oy;
  if (code == ROT) {
    const RotTerms t = rot_terms(
        c, a.rsqrt_tab, a.form, mvx, mvy,
        add(mul(static_cast<float>(bx), static_cast<float>(a.bs)), c.half),
        add(mul(static_cast<float>(by + a.sy0 / rep),
                static_cast<float>(a.bs)), c.half));
    if (a.form == FORM_OP) {
      rot_op(c, t.cs, gx, gy, &ox, &oy);
    } else {
      const V3 p = a.form == FORM_MERGED
                       ? V3{a.ga[slot][g], a.gb[slot][g], a.gc[slot][g]}
                       : erp_to_sphere(c, gx, gy);
      rot_fused(c, a.rsqrt_tab, t.cs, p, a.form == FORM_SEARCH, &ox, &oy);
    }
    if (mvx == 0.0f && mvy == 0.0f) { ox = gx; oy = gy; }
  } else {                                // MPA, from the perspective cache
    const bool vip = a.vip[slot][g] != 0;
    const float sign = vip ? -1.0f : 1.0f;
    const float qx = add(a.ga[slot][g], mul(mvx, sign));
    const float qy = add(a.gb[slot][g], mul(mvy, sign));
    if (a.form == FORM_OP) mpa_back(c, code, qx, qy, vip, &ox, &oy);
    else mpa_back_fused(c, a.rsqrt_tab, code, qx, qy, vip, &ox, &oy);
  }
  const bool bad = isnan(ox) || isnan(oy);     // no motion
  o[0] = fixed16(sub(bad ? gx : ox, c.offset));
  o[1] = fixed16(sub(bad ? gy : oy, c.offset)) - a.sy0 * 64;
}

// One thread a position.
__global__ void __launch_bounds__(THREADS)
sphere_positions_kernel(const Args a) {
  const int64_t n = static_cast<int64_t>(a.k) * a.ny * a.nx;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(THREADS) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * THREADS) {
    const int ox = static_cast<int>(i % a.nx);
    const int64_t t = i / a.nx;
    const int oy = static_cast<int>(t % a.ny);
    const int k = static_cast<int>(t / a.ny);
    position(a, k, oy * a.row_step, ox * a.col_step, a.out + i * 2);
  }
}

__global__ void __launch_bounds__(THREADS)
sphere_centers_kernel(const Args a) {
  const int64_t n = static_cast<int64_t>(a.k) * a.nby * a.nbx;
  const Consts& c = a.c;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(THREADS) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * THREADS) {
    const int bx = static_cast<int>(i % a.nbx);
    const int64_t t = i / a.nbx;
    const int by = static_cast<int>(t % a.nby);
    const int k = static_cast<int>(t / a.nby);
    const int slot = a.midx ? a.midx[i] : 0;
    const int code = a.code[slot];
    if (code == SKIP) continue;
    const int32_t* mv =
        a.mvs + (((static_cast<int64_t>(k) * a.n_models + slot) * a.nby + by)
                     * a.nbx + bx) * 2;
    const float mvx = mv_pel(mv[0]), mvy = mv_pel(mv[1]);
    const float cx = add(mul(static_cast<float>(bx), static_cast<float>(a.bs)),
                         c.half);
    const float cy = add(mul(static_cast<float>(by + a.sy0 / (a.bs / 4)),
                             static_cast<float>(a.bs)), c.half);
    float ox, oy;
    if (code == CLASSIC) {                // models.translational_motion
      ox = add(cx, mvx);
      oy = add(cy, mvy);
    } else if (code == ROT) {
      if (a.form == FORM_SEARCH) {        // the merged form at the centre
        const RotTerms t = rot_terms(c, a.rsqrt_tab, FORM_MERGED, mvx, mvy,
                                     cx, cy);
        rot_fused(c, a.rsqrt_tab, t.cs, erp_to_sphere(c, cx, cy), false, &ox,
                  &oy);
      } else {
        const RotTerms t = rot_terms(c, a.rsqrt_tab, FORM_OP, mvx, mvy, cx,
                                     cy);
        rot_op(c, t.cs, cx, cy, &ox, &oy);
      }
      if (mvx == 0.0f && mvy == 0.0f) { ox = cx; oy = cy; }
    } else if (a.form == FORM_SEARCH) {
      mpa_center_fused(c, a.rsqrt_tab, code, cx, cy, mvx, mvy, &ox, &oy);
    } else {
      float px, py;
      bool vip;
      mpa_to_perspective(c, code, cx, cy, &px, &py, &vip);
      const float sign = vip ? -1.0f : 1.0f;
      mpa_back(c, code, add(px, mul(mvx, sign)), add(py, mul(mvy, sign)), vip,
               &ox, &oy);
    }
    const bool bad = isnan(ox) || isnan(oy);
    int32_t* o = a.out + i * 2;
    o[0] = fixed16(sub(bad ? cx : ox, c.half));
    o[1] = fixed16(sub(bad ? cy : oy, c.half)) - a.sy0 * 64;
  }
}

int grid_of(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return static_cast<int>(blocks);
}

}  // namespace

extern "C" {
// Each launches its kernel on `stream` with *a (copied into the launch's
// parameters) and returns the CUDA error of the launch.
int sphere_positions(const sphere::Args* a, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(a->k) * a->ny * a->nx;
  if (n <= 0) return 0;
  sphere_positions_kernel<<<grid_of(n), THREADS, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
int sphere_centers(const sphere::Args* a, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(a->k) * a->nby * a->nbx;
  if (n <= 0) return 0;
  sphere_centers_kernel<<<grid_of(n), THREADS, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
// sizeof(Args), which the caller's layout must equal
int sphere_args_size() { return static_cast<int>(sizeof(sphere::Args)); }
}
