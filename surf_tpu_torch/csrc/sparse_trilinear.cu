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
// Bound on the card: bytes gathered.  Per point and stage: 8 parent-table
// reads (4 B), 8 child-validity reads (1 B) and 8 storage rows (C*4 B),
// plus 1 table + 1 validity read for the occupancy; the outputs are
// (1 + 6 in render mode) * sum(C) floats.  Random gathers into tables of
// up to 174 MB (352^3 int32) make it sector-traffic bound.
//
// Design (correct first): one thread per point.  For each stage the 8
// corner rows are resolved once (clamped to the border BEFORE the lookup,
// as the reference does), then each channel accumulates value, 3 first
// and 3 mixed second derivatives over the corners, in the reference's
// corner order.  Stage descriptors are passed by value.  The training
// variant (``kThird``) also writes d3/dxdydz, the one non-zero third
// derivative of a trilinear cell, which the third-order backward of the
// eikonal and smoothness terms asks for.
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

template <bool kThird>
__global__ void sparse_trilinear_multi_kernel(const float* __restrict__ pts,
                                              long long N, Stages st,
                                              float* __restrict__ feats,
                                              unsigned char* __restrict__ occ,
                                              float* __restrict__ jac,
                                              float* __restrict__ hmix,
                                              float* __restrict__ third) {
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const float p[3] = {pts[3 * n], pts[3 * n + 1], pts[3 * n + 2]};
    const int ctot = st.ctot;
    bool seen = false;

    for (int si = 0; si < st.n; ++si) {
        const Stage& S = st.s[si];
        const long long res = S.res;

        // nearest occupancy, align_corners=False: floor(((p+1)R-1)/2 + 0.5)
        long long ni[3];
        bool inside = true;
        for (int a = 0; a < 3; ++a) {
            const float c = ((p[a] + 1.0f) * (float)res - 1.0f) * 0.5f;
            ni[a] = (long long)floorf(c + 0.5f);
            inside = inside && ni[a] >= 0 && ni[a] < res;
        }
        if (inside && lookup_row(S, ni[0], ni[1], ni[2]) >= 0) seen = true;

        // trilinear cell, align_corners=True voxel centres
        const float scale = 0.5f * (float)(res - 1);
        float f[3];
        long long c0[3];
        for (int a = 0; a < 3; ++a) {
            const float c = (p[a] + 1.0f) * 0.5f * (float)(res - 1);
            const float fl = floorf(c);
            f[a] = c - fl;
            c0[a] = (long long)fl;
        }
        long long rows[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            rows[k] = lookup_row(S,
                                 clampll(c0[0] + ((k >> 2) & 1), 0, res - 1),
                                 clampll(c0[1] + ((k >> 1) & 1), 0, res - 1),
                                 clampll(c0[2] + (k & 1), 0, res - 1));
        }
        const int C = S.C;
        for (int c = 0; c < C; ++c) {
            float v = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
            float dxy = 0.f, dxz = 0.f, dyz = 0.f, dxyz = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                if (rows[k] < 0) continue;
                const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
                const float wx = ox ? f[0] : 1.0f - f[0];
                const float wy = oy ? f[1] : 1.0f - f[1];
                const float wz = oz ? f[2] : 1.0f - f[2];
                const float val = S.storage[rows[k] * C + c];
                v += val * (wx * wy * wz);
                if (jac != nullptr) {
                    const float sx = ox ? scale : -scale;
                    const float sy = oy ? scale : -scale;
                    const float sz = oz ? scale : -scale;
                    dx += val * (sx * wy * wz);
                    dy += val * (wx * sy * wz);
                    dz += val * (wx * wy * sz);
                    dxy += val * (sx * sy * wz);
                    dxz += val * (sx * wy * sz);
                    dyz += val * (wx * sy * sz);
                    if (kThird) dxyz += val * (sx * sy * sz);
                }
            }
            const int oc = S.coff + c;
            feats[n * ctot + oc] = v;
            if (jac != nullptr) {
                jac[(n * 3 + 0) * ctot + oc] = dx;
                jac[(n * 3 + 1) * ctot + oc] = dy;
                jac[(n * 3 + 2) * ctot + oc] = dz;
                hmix[(n * 3 + 0) * ctot + oc] = dxy;
                hmix[(n * 3 + 1) * ctot + oc] = dxz;
                hmix[(n * 3 + 2) * ctot + oc] = dyz;
                if (kThird) third[n * ctot + oc] = dxyz;
            }
        }
    }
    occ[n] = seen ? 1 : 0;
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
    if (N > 0) {
        sparse_trilinear_multi_kernel<false><<<blocks_for(N), kThreads, 0,
                                               (cudaStream_t)stream>>>(
            pts, N, st, feats, occ, jac, hmix, nullptr);
    }
    return (int)cudaGetLastError();
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
    if (N > 0) {
        sparse_trilinear_multi_kernel<true><<<blocks_for(N), kThreads, 0,
                                              (cudaStream_t)stream>>>(
            pts, N, st, feats, occ, jac, hmix, third);
    }
    return (int)cudaGetLastError();
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
