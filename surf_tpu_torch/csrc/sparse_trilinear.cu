// K3 sparse_trilinear_multi: trilinear features of up to 4 sparse cascade
// stages at a batch of points, and their cross-stage nearest occupancy, in
// one launch.  Render mode also writes the per-channel Jacobian with
// respect to the point and the mixed second derivatives (xy, xz, yz); the
// pure second derivatives of a trilinear cell are 0.
//
// Replaces (surf_tpu/ops/sparse.py): sparse_trilinear (:422) with
// lookup_rows (:97), gather_feats (:116) and the storage variants
// dense_trilinear (:393), packed_trilinear (:347), packed_trilinear_yz
// (:312); and occupancy_nearest (:546), combined_occupancy (:517),
// occupancy_lookup (:534).  The JAX package gets the derivatives by
// nested autodiff through the gathers (sdf_net.py:162-212); here they come
// out of the same gathers and feed two torch.autograd.Functions.
//
// Bound on the card: bytes, most of them written.  Per point and stage the
// function reads 8 parent-table entries (4 B), 8 child-validity flags
// (1 B) and 8 storage rows (C*4 B), plus one table entry and flag for the
// occupancy, many of them shared with neighbouring points; it writes
// (1, 7 with the derivatives, 8 in training) * sum(C) floats a point.  At
// the render chunk (557,056 points, 4 stages of C = 7) the 437 MB of
// outputs are 96 % of the bound's bytes.
//
// Design.  A thread per point writing its 28..224 outputs one float at a
// time makes every store of a warp touch 32 rows 112-336 B apart, so a
// warp's store moves 32 sectors for 128 useful bytes.  Here a block takes
// kPoints points in two phases:
//   1. geometry: a thread per (point, stage) clamps the 8 corners to the
//      border BEFORE the lookup (as the reference does), issues the 9 parent
//      table reads (8 corners + the nearest voxel), then the 9 validity
//      reads, all in 32-bit index arithmetic (the wrapper keeps tables and
//      storages below 2^31 entries), and leaves the 8 corner rows
//      (as storage offsets, -1 where the corner is absent), the nearest
//      voxel's occupancy and, for the sums, the 8 corner weights (value
//      only) or the 3 cell fractions (with the derivatives) in shared
//      memory, small enough that registers, not shared memory, bound the
//      blocks an SM holds;
//   2. sums: the block walks its contiguous (kPoints, sum C) output span,
//      neighbouring lanes on neighbouring channels of one point, so they
//      read neighbouring floats of the same corner rows and every output
//      (feats, and jac / hmix / third, whose per-point spans are contiguous
//      too) is stored as contiguous runs.  A thread keeps one channel for
//      the whole span (its stage, storage column and scale are fixed;
//      sum C is at most the block size), so what it does a (point,
//      channel) is its 8 corner loads, all issued before any add (an
//      absent corner loads nothing and reads 0), and its 1, 7 or 8 sums.
// On the H100 the first form of this design (a thread walking the span
// element by element, choosing the stage and forming the weights for each)
// took times in proportion to the instructions it issued, about 2.6 a
// cycle on each SM in both modes, not to its bytes; hence the work moved
// out of the (point, channel) loop.
// The mode (value only: the mesh; value + J + mixed second derivatives:
// the render; + d3/dxdydz, the one non-zero third derivative of a trilinear
// cell, which the third-order backward of the eikonal and smoothness
// terms asks for: training) is a template parameter.  Each sum runs over
// the corners in the reference's order with the plain version's products
// (-fmad=false), so the outputs are equal bit for bit to
// ``sparse_trilinear_multi_plain``'s and the occupancy exactly equal.
//
// K3b sparse_trilinear_multi_bwd (training and finetune): the gradient
// with respect to each stage's storage, given the cotangents of the four
// outputs (any of them absent).  The JAX package gets it from XLA's
// autodiff of sparse_trilinear's gathers.
// Bound: bytes — per point and stage the same 8 table and validity reads
// as K3, the cotangents read once, and the (P*8, C) gradients, which the
// wrapper zero-fills (capacity-sized: most of the bound) before the
// kernel adds into them.
// Design.  A thread a point reading the cotangents at n * ctot + oc for
// each of 4 stages x 8 corners x 7 channels puts lanes 112 B apart (every
// warp load touches 32 sectors) and issues one scalar atomic a (point,
// corner, channel): 15.6 M at the training step's 69,632 points.  Here a
// block takes kPoints points in K3's two phases:
//   1. geometry: a thread a (point, stage) resolves the 8 corners' storage
//      offsets and the 3 cell fractions into shared memory, with K3's own
//      ``resolve_cell``;
//   2. sums: thread t keeps channel oc = t % ctot (its stage and storage
//      column fixed) and walks a run of consecutive points of the block,
//      so a warp's lanes read neighbouring channels of a point: each
//      cotangent span is read as contiguous runs.  For each (point,
//      channel) the 8 corners' coefficients x cotangents are contracted
//      axis by axis (the 8 cotangent terms w, dw/da, d2w/dadb, d3w/dxdydz
//      are the products of one factor per axis: the weight or the
//      derivative scale), 72 operations instead of about 180;
//   3. merging: the render's points are (rays, samples), so consecutive
//      points often share a stage's corner rows; a thread sums a corner's
//      contributions in registers while its row stays the same from one
//      point to the next and issues one fire-and-forget atomic
//      (``red.global.add.f32``) a run.
// A thread issues the next point's cotangent loads before the current
// point's sums.  The cotangents are read through their strides: the
// training graph hands the Jacobian's over with its last two axes
// transposed, and a copy to the contiguous layout cost about as much as
// the kernel's own reads.  Absent voxels and clamped-away corners get
// nothing, exactly where the forward read 0; a (point, channel) whose
// cotangents are all zero adds nothing.  The sums run in an order that
// changes from run to run.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 4;

struct Stage {
    const int* table;              // (res/2)^3 parent row or -1
    const unsigned char* cvalid;   // (P*8,) child validity
    const float* storage;          // (P*8, C)
    float* grad;                   // (P*8, C) storage gradient (K3b)
    int res;
    int C;
    int coff;                      // channel offset in the concatenated output
};

struct Stages {
    Stage s[kMaxStages];
    int n;
    int ctot;
};

// ---------------------------------------------------------------------------
// K3: phase 1 (geometry a (point, stage)), phase 2 (sums a (point, channel))
// ---------------------------------------------------------------------------

constexpr int kPoints = 64;              // points a block
constexpr int kK3Threads = 256;
constexpr int kValue = 0, kDerivs = 1, kThird = 2;   // MODE

// One axis of the cell at align_corners=True voxel centres: the low and
// high corner clamped to [0, res-1] in float (a far-off or NaN coordinate
// is never converted out of range), and the fraction.
struct CellAxis {
    int v0, v1;
    float f;
};

__device__ __forceinline__ CellAxis cell_axis(float p, int res) {
    const float hi = (float)(res - 1);
    const float c = (p + 1.0f) * 0.5f * hi;
    const float fl = floorf(c);
    CellAxis a;
    a.f = c - fl;
    a.v0 = (int)fminf(fmaxf(fl, 0.0f), hi);
    a.v1 = (int)fminf(fmaxf(fl + 1.0f, 0.0f), hi);
    return a;
}

// Nearest voxel at align_corners=False: floor(((p+1) R - 1) / 2 + 0.5), in
// float; ``inside`` as the plain version tests the unclamped index.
__device__ __forceinline__ int nearest_axis(float p, int res, bool& inside) {
    const float n = floorf(((p + 1.0f) * (float)res - 1.0f) * 0.5f + 0.5f);
    inside = inside && n >= 0.0f && n < (float)res;
    return (int)fminf(fmaxf(n, 0.0f), (float)(res - 1));
}

// An f32 add to global memory that returns nothing.  (The gradient's
// pointer reaches K3b through shared memory, so a plain atomicAdd would
// be a generic one, with a branch to a shared-memory spin loop.)
__device__ __forceinline__ void red_add(float* p, float v) {
    asm volatile("red.global.add.f32 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "f"(v)
                 : "memory");
}

// Phase 1 of K3 and K3b: a point's cell at one stage.  The 8 corners
// clamped to the border BEFORE the lookup (as the reference does), their
// 8 parent-table reads issued together, then the 8 validity reads (with
// NEAREST a 9th of each, the nearest voxel's), all in 32-bit index
// arithmetic; ``off`` receives each present corner's storage offset (row
// * C), -1 where absent, ``ax`` the three axes (their fractions ``f``), and
// with NEAREST ``occ`` the nearest voxel's occupancy.
template <bool NEAREST>
__device__ __forceinline__ void resolve_cell(const Stage& S, const float* p,
                                             CellAxis (&ax)[3], int (&off)[8], bool& occ) {
    constexpr int NL = NEAREST ? 9 : 8;
    const int res = S.res, half = res >> 1, hh = half * half;
    const float px = p[0], py = p[1], pz = p[2];
    ax[0] = cell_axis(px, res);
    ax[1] = cell_axis(py, res);
    ax[2] = cell_axis(pz, res);
    bool inside = true;
    int nx = 0, ny = 0, nz = 0;
    if constexpr (NEAREST) {
        nx = nearest_axis(px, res, inside);
        ny = nearest_axis(py, res, inside);
        nz = nearest_axis(pz, res, inside);
    }
    // lookup k: corner k = 4 ox + 2 oy + oz, then (k = 8) the nearest
    // voxel; parent index (px * half + py) * half + pz and slot, by axis
    const int vx[3] = {ax[0].v0, ax[0].v1, nx}, vy[3] = {ax[1].v0, ax[1].v1, ny},
              vz[3] = {ax[2].v0, ax[2].v1, nz};
    int pidx[NL], slot[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
        const int a = k == 8 ? 2 : (k >> 2) & 1, b = k == 8 ? 2 : (k >> 1) & 1,
                  c = k == 8 ? 2 : k & 1;
        pidx[k] = (vx[a] >> 1) * hh + (vy[b] >> 1) * half + (vz[c] >> 1);
        slot[k] = ((vx[a] & 1) << 2) | ((vy[b] & 1) << 1) | (vz[c] & 1);
    }
    int row[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) row[k] = __ldg(S.table + pidx[k]);
    unsigned char cv[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
        row[k] = row[k] * 8 + slot[k];
        cv[k] = row[k] >= 0 ? __ldg(S.cvalid + row[k]) : 0;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) off[k] = cv[k] ? row[k] * S.C : -1;
    if constexpr (NEAREST) occ = inside && cv[8];
}

template <int MODE>
__global__ void __launch_bounds__(kK3Threads)
sparse_trilinear_multi_kernel(const float* __restrict__ pts, int N, Stages st,
                              float* __restrict__ feats, unsigned char* __restrict__ occ,
                              float* __restrict__ jac, float* __restrict__ hmix,
                              float* __restrict__ third) {
    // (stage, point) cells, a stage's rows kPoints + 1 long (lanes on one
    // point's neighbouring stages hit other banks): the 8 corners' storage
    // offsets; value only, their 8 weights; with the derivatives, the 3
    // cell fractions (the sums form each corner's products from them)
    constexpr int kF = MODE == kValue ? 2 : 1;
    __shared__ int4 s_off[kMaxStages][2][kPoints + 1];
    __shared__ float4 s_f[kMaxStages][kF][kPoints + 1];
    __shared__ unsigned char s_occ[kMaxStages][kPoints];   // nearest voxel occupied
    __shared__ Stage s_st[kMaxStages];
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < kMaxStages; ++i) s_st[i] = st.s[i];
    }
    __syncthreads();
    const int ns = st.n, ctot = st.ctot;
    const int n0 = blockIdx.x * kPoints;
    const int np = min(kPoints, N - n0);

    // phase 1: a thread per (point, stage), points fastest
    for (int i = threadIdx.x; i < ns * kPoints; i += kK3Threads) {
        const int si = i / kPoints, j = i % kPoints;
        if (j >= np) continue;
        CellAxis a[3];
        int off[8];
        bool occ_near;
        resolve_cell<true>(s_st[si], pts + 3 * (long long)(n0 + j), a, off, occ_near);
        const CellAxis &ax = a[0], &ay = a[1], &az = a[2];
        s_off[si][0][j] = make_int4(off[0], off[1], off[2], off[3]);
        s_off[si][1][j] = make_int4(off[4], off[5], off[6], off[7]);
        s_occ[si][j] = occ_near;
        if constexpr (MODE == kValue) {
            // the weights as the plain version forms them: (wx * wy) * wz
            const float g[3] = {1.0f - ax.f, 1.0f - ay.f, 1.0f - az.f};
            float w[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
                w[k] = (((k >> 2) & 1 ? ax.f : g[0]) * ((k >> 1) & 1 ? ay.f : g[1])) *
                       (k & 1 ? az.f : g[2]);
            s_f[si][0][j] = make_float4(w[0], w[1], w[2], w[3]);
            s_f[si][kF - 1][j] = make_float4(w[4], w[5], w[6], w[7]);
        } else {
            s_f[si][0][j] = make_float4(ax.f, ay.f, az.f, 0.0f);
        }
    }
    __syncthreads();

    for (int j = threadIdx.x; j < np; j += kK3Threads) {
        bool any = false;
        for (int si = 0; si < ns; ++si) any = any || s_occ[si][j];
        occ[n0 + j] = any ? 1 : 0;
    }

    // phase 2: the block's (np, ctot) output span.  Thread t keeps channel
    // oc = t % ctot (so its stage, storage column and scale are fixed) and
    // takes points t / ctot, + pstep, ...; a warp's lanes stay on
    // neighbouring elements of the span (the wrapper keeps ctot <= the
    // block size)
    const int pstep = kK3Threads / ctot;
    if ((int)threadIdx.x >= pstep * ctot) return;
    const int oc = threadIdx.x % ctot;
    const int si = (ns > 1 && oc >= s_st[1].coff) + (ns > 2 && oc >= s_st[2].coff) +
                   (ns > 3 && oc >= s_st[3].coff);
    const Stage& S = s_st[si];
    const float* src = S.storage + (oc - S.coff);
    const float scale = 0.5f * (float)(S.res - 1);
    for (int j = threadIdx.x / ctot; j < np; j += pstep) {
        const int4 lo = s_off[si][0][j], hi = s_off[si][1][j];
        const int off[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        float val[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) val[k] = off[k] >= 0 ? __ldg(src + off[k]) : 0.0f;
        const long long e = (long long)(n0 + j) * ctot + oc;     // feats, third
        float v = 0.f;
        if constexpr (MODE == kValue) {
            const float4 w0 = s_f[si][0][j], w1 = s_f[si][kF - 1][j];
            const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int k = 0; k < 8; ++k) v += val[k] * w[k];
            feats[e] = v;
        } else {
            const float4 g = s_f[si][0][j];
            const float f[3] = {g.x, g.y, g.z};
            float dx = 0.f, dy = 0.f, dz = 0.f, dxy = 0.f, dxz = 0.f, dyz = 0.f, dxyz = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
                const float wx = ox ? f[0] : 1.0f - f[0];
                const float wy = oy ? f[1] : 1.0f - f[1];
                const float wz = oz ? f[2] : 1.0f - f[2];
                const float sx = ox ? scale : -scale;
                const float sy = oy ? scale : -scale;
                const float sz = oz ? scale : -scale;
                v += val[k] * (wx * wy * wz);
                dx += val[k] * (sx * wy * wz);
                dy += val[k] * (wx * sy * wz);
                dz += val[k] * (wx * wy * sz);
                dxy += val[k] * (sx * sy * wz);
                dxz += val[k] * (sx * wy * sz);
                dyz += val[k] * (wx * sy * sz);
                if constexpr (MODE == kThird) dxyz += val[k] * (sx * sy * sz);
            }
            feats[e] = v;
            const long long o = (long long)(n0 + j) * 3 * ctot + oc;
            jac[o] = dx;
            jac[o + ctot] = dy;
            jac[o + 2 * ctot] = dz;
            hmix[o] = dxy;
            hmix[o + ctot] = dxz;
            hmix[o + 2 * ctot] = dyz;
            if constexpr (MODE == kThird) third[e] = dxyz;
        }
    }
}

// The strides, in elements, of K3b's four cotangents (feats, jac, hmix,
// third): point n, derivative a (jac, hmix) and channel c at n * sn + a *
// sa + c * sc.  The training graph hands the Jacobian's cotangent over
// with its (a, c) axes transposed; reading it in place saves a copy.
struct CtLayout {
    long long sn[4];
    int sa[4], sc[4];
};

// K3b: phase 1 as K3's (resolve_cell, no nearest voxel), phase 2 a
// thread a channel over a run of consecutive points.  ``counts`` (or
// null) receives the (point, corner, channel) scatters of nonzero
// cotangents and the atomics issued.
__global__ void __launch_bounds__(kK3Threads)
sparse_trilinear_multi_bwd_kernel(const float* __restrict__ pts, int N, Stages st,
                                  const float* __restrict__ ct_feats,
                                  const float* __restrict__ ct_jac,
                                  const float* __restrict__ ct_hmix,
                                  const float* __restrict__ ct_third, CtLayout lay,
                                  unsigned long long* __restrict__ counts) {
    __shared__ int4 s_off[kMaxStages][2][kPoints + 1];
    __shared__ float4 s_f[kMaxStages][kPoints + 1];
    __shared__ Stage s_st[kMaxStages];
    __shared__ unsigned s_counts[2];
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < kMaxStages; ++i) s_st[i] = st.s[i];
        s_counts[0] = s_counts[1] = 0u;
    }
    __syncthreads();
    const int ns = st.n, ctot = st.ctot;
    const int n0 = blockIdx.x * kPoints;
    const int np = min(kPoints, N - n0);

    for (int i = threadIdx.x; i < ns * kPoints; i += kK3Threads) {
        const int si = i / kPoints, j = i % kPoints;
        if (j >= np) continue;
        CellAxis a[3];
        int off[8];
        bool unused;
        resolve_cell<false>(s_st[si], pts + 3 * (long long)(n0 + j), a, off, unused);
        s_off[si][0][j] = make_int4(off[0], off[1], off[2], off[3]);
        s_off[si][1][j] = make_int4(off[4], off[5], off[6], off[7]);
        s_f[si][j] = make_float4(a[0].f, a[1].f, a[2].f, 0.0f);
    }
    __syncthreads();

    // phase 2: ``groups`` runs of consecutive points, ctot channels each
    const int groups = kK3Threads / ctot;
    unsigned scatters = 0, atomics = 0;
    if ((int)threadIdx.x < groups * ctot) {
        const int oc = threadIdx.x % ctot, grp = threadIdx.x / ctot;
        const int per = (np + groups - 1) / groups;
        const int j0 = grp * per, j1 = min(np, j0 + per);
        const int si = (ns > 1 && oc >= s_st[1].coff) + (ns > 2 && oc >= s_st[2].coff) +
                       (ns > 3 && oc >= s_st[3].coff);
        const Stage& S = s_st[si];
        float* grad = S.grad + (oc - S.coff);
        const float scale = 0.5f * (float)(S.res - 1);
        int cur[8];
        float acc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) cur[k] = -1;
        // the cotangent tensor T[a][b][c] of point j, one factor an axis: 0
        // the weight, 1 the derivative scale (T000 feats, T100 dx, T010 dy,
        // T001 dz, T110 dxy, T101 dxz, T011 dyz, T111 dxdydz), index q =
        // 4 a + 2 b + c; the next point's loads are issued before this
        // point's sums
        auto load_t = [&](int j, float (&t)[8]) {
            const long long n = n0 + j;
#pragma unroll
            for (int q = 0; q < 8; ++q) t[q] = 0.0f;
            if (j >= j1) return;
            if (ct_feats != nullptr) t[0] = __ldg(ct_feats + n * lay.sn[0] + oc * lay.sc[0]);
            if (ct_jac != nullptr) {
                const float* q = ct_jac + n * lay.sn[1] + oc * lay.sc[1];
                t[4] = __ldg(q);
                t[2] = __ldg(q + lay.sa[1]);
                t[1] = __ldg(q + 2 * lay.sa[1]);
            }
            if (ct_hmix != nullptr) {
                const float* q = ct_hmix + n * lay.sn[2] + oc * lay.sc[2];
                t[6] = __ldg(q);
                t[5] = __ldg(q + lay.sa[2]);
                t[3] = __ldg(q + 2 * lay.sa[2]);
            }
            if (ct_third != nullptr) t[7] = __ldg(ct_third + n * lay.sn[3] + oc * lay.sc[3]);
        };
        float tn[8];
        load_t(j0, tn);
        for (int j = j0; j < j1; ++j) {
            float t[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) t[q] = tn[q];
            load_t(j + 1, tn);
            bool nz = false;
#pragma unroll
            for (int q = 0; q < 8; ++q) nz |= t[q] != 0.0f;
            if (!nz) continue;
            // index q = 4 a + 2 b + c of T; contract x, then y, then z
            const float4 f = s_f[si][j];
            const float A[2][2] = {{1.0f - f.x, -scale}, {f.x, scale}};   // [ox][a]
            const float B[2][2] = {{1.0f - f.y, -scale}, {f.y, scale}};
            const float Cz[2][2] = {{1.0f - f.z, -scale}, {f.z, scale}};
            float u[2][4];                                // [ox][2 b + c]
#pragma unroll
            for (int ox = 0; ox < 2; ++ox)
#pragma unroll
                for (int bc = 0; bc < 4; ++bc)
                    u[ox][bc] = t[bc] * A[ox][0] + t[4 + bc] * A[ox][1];
            float v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
                const float w0 = u[ox][0] * B[oy][0] + u[ox][2] * B[oy][1];   // c = 0
                const float w1 = u[ox][1] * B[oy][0] + u[ox][3] * B[oy][1];   // c = 1
                v[k] = w0 * Cz[oz][0] + w1 * Cz[oz][1];
            }
            const int4 lo = s_off[si][0][j], hi = s_off[si][1][j];
            const int off[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                if (off[k] < 0) continue;
                ++scatters;
                if (off[k] == cur[k]) {
                    acc[k] += v[k];
                    continue;
                }
                if (cur[k] >= 0) {
                    red_add(grad + cur[k], acc[k]);
                    ++atomics;
                }
                cur[k] = off[k];
                acc[k] = v[k];
            }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if (cur[k] >= 0) {
                red_add(grad + cur[k], acc[k]);
                ++atomics;
            }
        }
    }
    if (counts != nullptr) {
        atomicAdd(s_counts, scatters);
        atomicAdd(s_counts + 1, atomics);
        __syncthreads();
        if (threadIdx.x == 0) {
            atomicAdd(counts, (unsigned long long)s_counts[0]);
            atomicAdd(counts + 1, (unsigned long long)s_counts[1]);
        }
    }
}

Stages make_stages(int nstages, const long long* tables, const long long* cvalids,
                   const long long* storages, const long long* grads,
                   const int* res, const int* C) {
    Stages st;
    st.n = nstages;
    int coff = 0;
    for (int i = 0; i < nstages; ++i) {
        st.s[i].table = (const int*)tables[i];
        st.s[i].cvalid = (const unsigned char*)cvalids[i];
        st.s[i].storage = storages != nullptr ? (const float*)storages[i] : nullptr;
        st.s[i].grad = grads != nullptr ? (float*)grads[i] : nullptr;
        st.s[i].res = res[i];
        st.s[i].C = C[i];
        st.s[i].coff = coff;
        coff += C[i];
    }
    st.ctot = coff;
    return st;
}
// K3's and K3b's index rule over ``st``: 32-bit index arithmetic (N below
// 2^31, each table below 2^31 entries; the wrappers also keep each storage
// and validity array below 2^31), 1 to kK3Threads channels in all.
inline int k3_args_bad(long long N, const Stages& st) {
    if (N > (long long)INT_MAX - kPoints || st.ctot <= 0 || st.ctot > kK3Threads)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < st.n; ++i) {
        const long long half = st.s[i].res / 2;
        if (st.s[i].res < 2 || half * half * half >= (long long)INT_MAX)
            return (int)cudaErrorInvalidValue;
    }
    return 0;
}

// K3's launch over ``st`` in mode MODE.
template <int MODE>
int launch_k3(const float* pts, long long N, const Stages& st, float* feats,
              unsigned char* occ, float* jac, float* hmix, float* third, void* stream) {
    if (N <= 0) return 0;
    const int bad = k3_args_bad(N, st);
    if (bad) return bad;
    const unsigned blocks = (unsigned)((N + kPoints - 1) / kPoints);
    sparse_trilinear_multi_kernel<MODE><<<blocks, kK3Threads, 0, (cudaStream_t)stream>>>(
        pts, (int)N, st, feats, occ, jac, hmix, third);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pts (N, 3) f32.  Per stage i: tables[i] int32 ((res/2)^3), cvalids[i]
// bool (P*8), storages[i] f32 (P*8, C_i), res[i], C[i].  Outputs: feats
// (N, sum C) f32, occ (N,) bool, and with jac != NULL: jac, hmix
// (N, 3, sum C) f32.
int sparse_trilinear_multi(const float* pts, long long N, int nstages,
                           const long long* tables, const long long* cvalids,
                           const long long* storages, const int* res,
                           const int* C, float* feats, unsigned char* occ,
                           float* jac, float* hmix, void* stream) {
    if (nstages < 1 || nstages > kMaxStages) return (int)cudaErrorInvalidValue;
    const Stages st = make_stages(nstages, tables, cvalids, storages, nullptr, res, C);
    if (jac != nullptr)
        return launch_k3<kDerivs>(pts, N, st, feats, occ, jac, hmix, nullptr, stream);
    return launch_k3<kValue>(pts, N, st, feats, occ, nullptr, nullptr, nullptr, stream);
}

// The training variant: as above with jac, hmix and third (N, sum C) f32
// all written.
int sparse_trilinear_multi_third(const float* pts, long long N, int nstages,
                                 const long long* tables,
                                 const long long* cvalids,
                                 const long long* storages, const int* res,
                                 const int* C, float* feats, unsigned char* occ,
                                 float* jac, float* hmix, float* third,
                                 void* stream) {
    if (nstages < 1 || nstages > kMaxStages) return (int)cudaErrorInvalidValue;
    const Stages st = make_stages(nstages, tables, cvalids, storages, nullptr, res, C);
    return launch_k3<kThird>(pts, N, st, feats, occ, jac, hmix, third, stream);
}

// K3b.  grads[i] f32 (P*8, C_i), zero-filled by the caller, receive the
// storage gradients.  Cotangents: ct_feats (N, sum C), ct_jac and ct_hmix
// (N, 3, sum C), ct_third (N, sum C), each f32 or NULL (zero).  Extended:
// counts (2,) uint64 or NULL (see the kernel); ct_strides, 12 int64 or
// NULL (contiguous): (point, derivative, channel) strides of each
// cotangent in that order (the derivative's ignored for feats and third).
// K3's index rule.
int sparse_trilinear_multi_bwd(const float* pts, long long N, int nstages,
                               const long long* tables, const long long* cvalids,
                               const long long* grads, const int* res,
                               const int* C, const float* ct_feats,
                               const float* ct_jac, const float* ct_hmix,
                               const float* ct_third, void* stream,
                               unsigned long long* counts, const long long* ct_strides) {
    if (nstages < 1 || nstages > kMaxStages) return (int)cudaErrorInvalidValue;
    const Stages st = make_stages(nstages, tables, cvalids, nullptr, grads, res, C);
    const int bad = k3_args_bad(N, st);
    if (bad) return bad;
    CtLayout lay;
    for (int i = 0; i < 4; ++i) {
        const bool d = i == 1 || i == 2;              // (N, 3, sum C) or (N, sum C)
        lay.sn[i] = ct_strides ? ct_strides[3 * i] : (d ? 3 : 1) * (long long)st.ctot;
        lay.sa[i] = ct_strides ? (int)ct_strides[3 * i + 1] : (d ? st.ctot : 0);
        lay.sc[i] = ct_strides ? (int)ct_strides[3 * i + 2] : 1;
    }
    if (N > 0) {
        const unsigned blocks = (unsigned)((N + kPoints - 1) / kPoints);
        sparse_trilinear_multi_bwd_kernel<<<blocks, kK3Threads, 0, (cudaStream_t)stream>>>(
            pts, (int)N, st, ct_feats, ct_jac, ct_hmix, ct_third, lay, counts);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
