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
// K3b sparse_trilinear_multi_bwd (training): the gradient with respect to
// each stage's storage, given the cotangents of the four outputs.  The
// JAX package gets it from XLA's autodiff of sparse_trilinear's gathers.
// Bound: bytes — per point and stage the same 8 table and validity reads,
// the cotangents read once, 8 x C atomic adds into the (P*8, C) gradient.
// Design: one thread per point; for each stage the 8 corner rows are
// resolved as in K3; per corner one coefficient per cotangent (the weight
// for feats, dw/da for jac, d2w/dadb for hmix, d3w/dxdydz for third) is
// formed, and their sum over the cotangents of each channel is added to
// the corner's gradient row with f32 atomicAdd (order changes run to
// run).  Absent voxels and clamped-away corners get nothing, exactly where
// the forward read 0.

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

__device__ __forceinline__ long long lookup_row(const Stage& st, long long cx,
                                                long long cy, long long cz) {
    const long long half = st.res / 2;
    const int slot = (int)(((cx & 1) << 2) | ((cy & 1) << 1) | (cz & 1));
    const long long pidx = ((cx >> 1) * half + (cy >> 1)) * half + (cz >> 1);
    const int prow = st.table[pidx];
    if (prow < 0) return -1;
    const long long row = (long long)prow * 8 + slot;
    return st.cvalid[row] ? row : -1;
}

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

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
        const Stage& S = s_st[si];
        const int res = S.res, half = res >> 1, hh = half * half;
        const float* p = pts + 3 * (long long)(n0 + j);
        const float px = p[0], py = p[1], pz = p[2];
        const CellAxis ax = cell_axis(px, res), ay = cell_axis(py, res),
                       az = cell_axis(pz, res);
        bool inside = true;
        const int nx = nearest_axis(px, res, inside), ny = nearest_axis(py, res, inside),
                  nz = nearest_axis(pz, res, inside);
        // lookup k: corner k = 4 ox + 2 oy + oz, then (k = 8) the nearest
        // voxel; parent index (px * half + py) * half + pz and slot, by axis
        const int vx[3] = {ax.v0, ax.v1, nx}, vy[3] = {ay.v0, ay.v1, ny},
                  vz[3] = {az.v0, az.v1, nz};
        int pidx[9], slot[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            const int a = k == 8 ? 2 : (k >> 2) & 1, b = k == 8 ? 2 : (k >> 1) & 1,
                      c = k == 8 ? 2 : k & 1;
            pidx[k] = (vx[a] >> 1) * hh + (vy[b] >> 1) * half + (vz[c] >> 1);
            slot[k] = ((vx[a] & 1) << 2) | ((vy[b] & 1) << 1) | (vz[c] & 1);
        }
        int row[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) row[k] = __ldg(S.table + pidx[k]);
        unsigned char cv[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            row[k] = row[k] * 8 + slot[k];
            cv[k] = row[k] >= 0 ? __ldg(S.cvalid + row[k]) : 0;
        }
        // storage offset of each present corner, -1 where absent
        int off[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) off[k] = cv[k] ? row[k] * S.C : -1;
        s_off[si][0][j] = make_int4(off[0], off[1], off[2], off[3]);
        s_off[si][1][j] = make_int4(off[4], off[5], off[6], off[7]);
        s_occ[si][j] = inside && cv[8];
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

__global__ void sparse_trilinear_multi_bwd_kernel(
        const float* __restrict__ pts, long long N, Stages st,
        const float* __restrict__ ct_feats, const float* __restrict__ ct_jac,
        const float* __restrict__ ct_hmix, const float* __restrict__ ct_third) {
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const float p[3] = {pts[3 * n], pts[3 * n + 1], pts[3 * n + 2]};
    const int ctot = st.ctot;
    for (int si = 0; si < st.n; ++si) {
        const Stage& S = st.s[si];
        const long long res = S.res;
        const float scale = 0.5f * (float)(res - 1);
        float f[3];
        long long c0[3];
        for (int a = 0; a < 3; ++a) {
            const float c = (p[a] + 1.0f) * 0.5f * (float)(res - 1);
            const float fl = floorf(c);
            f[a] = c - fl;
            c0[a] = (long long)fl;
        }
        const int C = S.C;
        for (int k = 0; k < 8; ++k) {
            const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
            const long long row = lookup_row(S, clampll(c0[0] + ox, 0, res - 1),
                                             clampll(c0[1] + oy, 0, res - 1),
                                             clampll(c0[2] + oz, 0, res - 1));
            if (row < 0) continue;
            const float wx = ox ? f[0] : 1.0f - f[0];
            const float wy = oy ? f[1] : 1.0f - f[1];
            const float wz = oz ? f[2] : 1.0f - f[2];
            const float sx = ox ? scale : -scale;
            const float sy = oy ? scale : -scale;
            const float sz = oz ? scale : -scale;
            const float w = wx * wy * wz;
            const float jx = sx * wy * wz, jy = wx * sy * wz, jz = wx * wy * sz;
            const float hxy = sx * sy * wz, hxz = sx * wy * sz, hyz = wx * sy * sz;
            const float t3 = sx * sy * sz;
            float* g = S.grad + row * C;
            for (int c = 0; c < C; ++c) {
                const long long oc = S.coff + c;
                float v = 0.0f;
                if (ct_feats != nullptr) v += w * ct_feats[n * ctot + oc];
                if (ct_jac != nullptr) {
                    v += jx * ct_jac[(n * 3 + 0) * ctot + oc];
                    v += jy * ct_jac[(n * 3 + 1) * ctot + oc];
                    v += jz * ct_jac[(n * 3 + 2) * ctot + oc];
                }
                if (ct_hmix != nullptr) {
                    v += hxy * ct_hmix[(n * 3 + 0) * ctot + oc];
                    v += hxz * ct_hmix[(n * 3 + 1) * ctot + oc];
                    v += hyz * ct_hmix[(n * 3 + 2) * ctot + oc];
                }
                if (ct_third != nullptr) v += t3 * ct_third[n * ctot + oc];
                atomicAdd(g + c, v);
            }
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

constexpr int kThreads = 128;

inline unsigned blocks_for(long long n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

// K3's launch over ``st``: mode MODE, 32-bit index rule (N below 2^31, each
// table below 2^31 entries; the wrapper also keeps each storage and
// validity array below 2^31), 1 to kK3Threads channels in all.
template <int MODE>
int launch_k3(const float* pts, long long N, const Stages& st, float* feats,
              unsigned char* occ, float* jac, float* hmix, float* third, void* stream) {
    if (N <= 0) return 0;
    if (N > (long long)INT_MAX - kPoints || st.ctot <= 0 || st.ctot > kK3Threads)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < st.n; ++i) {
        const long long half = st.s[i].res / 2;
        if (st.s[i].res < 2 || half * half * half >= (long long)INT_MAX)
            return (int)cudaErrorInvalidValue;
    }
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
// (N, 3, sum C), ct_third (N, sum C), each f32 or NULL (zero).
int sparse_trilinear_multi_bwd(const float* pts, long long N, int nstages,
                               const long long* tables, const long long* cvalids,
                               const long long* grads, const int* res,
                               const int* C, const float* ct_feats,
                               const float* ct_jac, const float* ct_hmix,
                               const float* ct_third, void* stream) {
    if (nstages < 1 || nstages > kMaxStages) return (int)cudaErrorInvalidValue;
    const Stages st = make_stages(nstages, tables, cvalids, nullptr, grads, res, C);
    if (N > 0) {
        sparse_trilinear_multi_bwd_kernel<<<blocks_for(N), kThreads, 0,
                                            (cudaStream_t)stream>>>(
            pts, N, st, ct_feats, ct_jac, ct_hmix, ct_third);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
