// K4 gather_conv: out[r] = sum_t x[idx[r, t]] . W[t], with idx = -1
// reading zero — every sparse 3x3x3 convolution of the hybrid U-Net as
// one neighbour-row gather plus a (T*Cin x Cout) product.
//
// Replaces (surf_tpu/nn/reg_net.py), forward values: subm_conv_child_nbr
// (:359), subm_conv_parent_nbr (:398), down_conv_c2p_nbr (:429),
// up_conv_p2c_nbr (:464), down_conv_parent_to_dense (:709) and
// up_conv_dense_to_parent (:748); and the grid-form convs' forward values
// (:566, :593, :622, :652).  The caller builds one (rows, T) int32 index
// table per variant from the parent table (the TPU's box-64 and per-slot
// weight layouts are not needed: the table already says which row each
// tap reads).  Training: the input gradient of every variant is this same
// kernel on the transposed table (idx_t[j, t] = r where idx[r, t] = j;
// each table is one-to-one per tap) with W[t] transposed.
//
// K4w gather_conv_dw: dW[t] = sum_r x[idx[r, t]]^T ct[r] (idx -1
// skipped), the weight gradient.  Replaces the dW halves of the JAX VJPs
// _scc_bwd (reg_net.py:368), _scp_bwd (:407), _dcp_bwd (:439), _upc_bwd
// (:473), _down_p2d_bwd (:719), _up_d2p_bwd (:758) and of the grid-form
// VJPs (:574, :602, :633, :661).
//
// What bounds them on the H100: bytes and latency, never operations.  The
// tables are capacity-sized (3,145,728 x 27 int32 = 340 MB at 704^3, a
// tenth of a millisecond at 3.35 TB/s) while the present (row, tap) pairs
// are few (2.7 % of them in the validate's 704^3 conv0 table, 253 of 85 M
// in the training step's): 2 * pairs * Cin * Cout flops is 0.6 GFLOP at
// the densest call, about 0.009 ms at f32's 67 TFLOP/s, so tensor cores
// (which would also need TF32, which the port does not use) buy nothing.
// The gathers of x rows hit L2 (a live neighbourhood's rows are reused
// by up to 27 rows); the latency of the table -> row -> product chain is
// what a kernel that walks rows one by one waits on.
//
// Design (both kernels):
// * Persistent blocks of 8 warps, as many as fit on the 132 SMs, each warp
//   walking groups of 32 consecutive rows.  32-bit offsets throughout
//   (the wrappers and the C entries refuse more).
// * A group first takes the ballot of its live rows: with a live-row mask
//   (one byte a row: the rows a conv_tables table keeps; the transposed
//   and grid-form tables have none) a dead row costs one byte and no
//   table entry.  The live rows' table entries are copied into a per-warp
//   tile with cp.async (all in flight at once, no registers held); lane i
//   then scans row i into its present-tap mask.  A row without a present
//   tap is written zero (K4) or skipped (K4w); absent taps cost nothing.
// * K4: lane = (row slot, output channel), S <= 32 / Cout rows a step.  A
//   step copies its rows' gathered x rows (present taps only, 16 bytes a
//   copy when Cin % 4 == 0) into a per-warp stage in shared memory, every
//   copy in flight at once, then each lane sums its output over its row's
//   taps and input channels from there, W[t] staged once a block.  Each
//   sum runs in one fixed order (taps ascending, then channels) in one
//   lane with no atomics: the output is the same bit for bit from run to
//   run, as the validate's cascade must be.
// * K4w: lane = (channel group, output channel), one row at a time:
//   G = 32 / Cout groups split the input channels, up to 8 x loads of 16
//   bytes in flight a lane; each present (row, tap) adds x[j, ci] *
//   ct[r, co] to the block's dW partial in shared memory (native shared
//   f32 atomics, a warp's 32 on consecutive words), and at the end one
//   global atomicAdd per nonzero (t, ci, co) a block.  The sums' order is
//   run-dependent (atomics), within K4w's stated tolerance.  No block
//   barrier between row groups.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 32;             // rows a warp group: one a lane
constexpr int kMaxT = 27;
constexpr int kTile = kGroup * kMaxT;  // int32 table entries a warp stages
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageWords = 2048;      // K4's stage of gathered x rows a warp

struct Layout {
    int R, T, Cin, Cout;
    int C4;        // chunks of VEC input channels
    int G;         // lane groups: 32 / Cout
    int CinP;      // K4's W row stride in shared memory (words)
    int S;         // K4's rows a step (slots)
    int XsSlot;    // K4's stage words a slot
    int C4P;       // a power of two >= C4
    unsigned mT;   // e / T == (e * mT) >> 16 for e < 32 * 27
    unsigned mC;   // e / Cout == (e * mC) >> 16 for e < 32 * 32
};

// float4 or float, by VEC
template <int VEC> struct Vec;
template <> struct Vec<4> {
    using T = float4;
    __device__ static T load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
    __device__ static T lds(const float* p) { return *reinterpret_cast<const float4*>(p); }
    __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ static float at(const T& v, int u) {
        return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
    }
};
template <> struct Vec<1> {
    using T = float;
    __device__ static T load(const float* p) { return __ldg(p); }
    __device__ static T lds(const float* p) { return *p; }
    __device__ static T zero() { return 0.f; }
    __device__ static float at(const T& v, int) { return v; }
};

// K4w's shared-memory index of (t, ci = c * VEC + u, co): [t][u][c][co]
template <int VEC>
__device__ __forceinline__ int widx(const Layout& L, int t, int u, int c, int co) {
    return ((t * VEC + u) * L.C4 + c) * L.Cout + co;
}

// An asynchronous copy of BYTES (4 or 16) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
}

// Stages the live rows' table entries of group r0 into ``tile`` (an
// asynchronous copy, no registers held) and returns, in lane i, the
// present taps of row r0 + i (bit t; 0 for a dead row).
__device__ __forceinline__ unsigned stage_group(const Layout& L, const int* __restrict__ idx,
                                                const unsigned char* __restrict__ live,
                                                int r0, int* tile, int lane) {
    const int r = r0 + lane;
    const bool lv = r < L.R && (live == nullptr || live[r] != 0);
    const unsigned lm = __ballot_sync(kFull, lv);
    if (lm == 0) return 0;
    const int n = (L.R - r0 < kGroup ? L.R - r0 : kGroup) * L.T;
    const int* base = idx + r0 * L.T;
    for (int k = 0; k < L.T; ++k) {
        const int e = k * 32 + lane;
        if (e < n && ((lm >> ((e * L.mT) >> 16)) & 1u)) cp_async<4>(tile + e, base + e);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    // lane i scans row i (a stride of T words: no bank conflict for odd T)
    unsigned m = 0;
    if (lv)
        for (int t = 0; t < L.T; ++t) m |= (unsigned)(tile[lane * L.T + t] >= 0) << t;
    return m;
}

// Takes up to U taps from ``um`` (warp-uniform), -1 past the last.
template <int U>
__device__ __forceinline__ void next_taps(unsigned& um, int (&tb)[U]) {
#pragma unroll
    for (int q = 0; q < U; ++q) {
        tb[q] = -1;
        if (um) {
            tb[q] = __ffs(um) - 1;
            um &= um - 1;
        }
    }
}

// K4.  Lane = (row slot, output channel): S rows of a group at a time
// (S <= 32 / Cout), each lane summing one output over every present tap
// and input channel of its row.  A step first copies the S rows' gathered
// x rows (their present taps only) into the warp's stage in shared memory,
// all copies in flight at once, then sums from shared memory: W[t] as
// [t][co][ci] (rows CinP words apart), the stage as [slot][t][ci] (slots
// XsSlot words apart), so a warp's 16-byte reads fall in distinct banks.
template <int VEC, int NC>
__global__ void __launch_bounds__(kThreads, 1)
gather_conv_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   const unsigned char* __restrict__ live, const float* __restrict__ w,
                   float* __restrict__ out, Layout L) {
    extern __shared__ float smem[];
    const int CinP = L.CinP, S = L.S;
    float* ws = smem;
    float* xs_all = ws + L.T * L.Cout * CinP;
    int* tiles = reinterpret_cast<int*>(xs_all + kWarps * S * L.XsSlot);
    int* srows = tiles + kWarps * kTile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* tile = tiles + warp * kTile;
    float* xs = xs_all + warp * S * L.XsSlot;
    int* srow = srows + warp * 32;

    for (int e = threadIdx.x; e < L.T * L.Cin * L.Cout; e += kThreads) {
        const int co = e % L.Cout, ci = (e / L.Cout) % L.Cin, t = e / (L.Cout * L.Cin);
        ws[(t * L.Cout + co) * CinP + ci] = w[e];
    }
    __syncthreads();

    using V = Vec<VEC>;
    const int slot = lane / L.Cout, co = lane % L.Cout;
    // the stage copy: lanes per (slot, tap) = C4P, a power of two >= C4
    const int cl = lane & (L.C4P - 1), per = 32 / L.C4P;
    const int ngroups = (L.R + kGroup - 1) / kGroup;
    for (int g = blockIdx.x * kWarps + warp; g < ngroups; g += gridDim.x * kWarps) {
        const int r0 = g * kGroup;
        const int nrows = L.R - r0 < kGroup ? L.R - r0 : kGroup;
        const unsigned m = stage_group(L, idx, live, r0, tile, lane);
        unsigned lm = __ballot_sync(kFull, m != 0);
        // zeros for the rows without a present tap, coalesced
        for (int e = lane; e < nrows * L.Cout; e += 32)
            if (!((lm >> ((e * L.mC) >> 16)) & 1u)) out[r0 * L.Cout + e] = 0.f;
        while (lm) {
            // this step's rows: the S lowest remaining; slot s takes the s-th
            const int n = __popc(lm) < S ? __popc(lm) : S;
            unsigned take = 0;
            for (int q = 0; q < n; ++q) {
                take |= lm & (0u - lm);        // the lowest remaining row
                lm &= lm - 1;
            }
            if ((take >> lane) & 1u) srow[__popc(take & ((1u << lane) - 1u))] = lane;
            __syncwarp();
            // copy the present taps' x rows into the stage
            for (int st = lane / L.C4P; st < n * L.T; st += per) {
                const int s = (st * L.mT) >> 16, t = st - s * L.T;
                const int j = tile[srow[s] * L.T + t];
                if (j >= 0 && cl < L.C4)
                    cp_async<4 * VEC>(xs + s * L.XsSlot + t * L.Cin + cl * VEC,
                                      x + j * L.Cin + cl * VEC);
            }
            asm volatile("cp.async.wait_all;\n" ::: "memory");
            __syncwarp();
            const int row = slot < n ? srow[slot] : -1;
            const unsigned mm = __shfl_sync(kFull, m, row < 0 ? 0 : row) & (row < 0 ? 0u : ~0u);
            const float* xr = xs + (slot < n ? slot : 0) * L.XsSlot;
            float acc = 0.f;
            unsigned pm = mm;
            while (pm) {
                const int t = __ffs(pm) - 1;
                pm &= pm - 1;
                const float* xt = xr + t * L.Cin;
                const float* wt = ws + (t * L.Cout + co) * CinP;
                for (int c0 = 0; c0 < L.C4; c0 += NC) {
#pragma unroll
                    for (int c = 0; c < NC; ++c) {
                        if (c0 + c >= L.C4) break;
                        const typename V::T xv = V::lds(xt + (c0 + c) * VEC);
                        const typename V::T wv = V::lds(wt + (c0 + c) * VEC);
#pragma unroll
                        for (int u = 0; u < VEC; ++u)
                            acc = __fmaf_rn(V::at(xv, u), V::at(wv, u), acc);
                    }
                }
            }
            if (row >= 0) out[(r0 + row) * L.Cout + co] = acc;
            __syncwarp();     // the stage and srow are rewritten by the next step
        }
        __syncwarp();         // the tile is rewritten by the next group
    }
}

// K4w.  Lane = (channel group cg, output channel co), one row at a time:
// G = 32 / Cout groups split the input channels in chunks of VEC; the
// block's dW partial in shared memory as [t][u][chunk][co], so a warp's
// atomics touch 32 consecutive words.
template <int VEC, int NK, int U>
__global__ void __launch_bounds__(kThreads, 2)
gather_conv_dw_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                      const unsigned char* __restrict__ live, const float* __restrict__ ct,
                      float* __restrict__ dw, Layout L) {
    extern __shared__ float smem[];
    const int nw = L.T * L.Cin * L.Cout;
    float* dws = smem;
    int* tiles = reinterpret_cast<int*>(smem + ((nw + 3) & ~3));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* tile = tiles + warp * kTile;

    for (int e = threadIdx.x; e < nw; e += kThreads) dws[e] = 0.f;
    __syncthreads();

    using V = Vec<VEC>;
    const int co = lane % L.Cout, cg = lane / L.Cout;
    const bool active = cg < L.G;
    const int ngroups = (L.R + kGroup - 1) / kGroup;
    for (int g = blockIdx.x * kWarps + warp; g < ngroups; g += gridDim.x * kWarps) {
        const int r0 = g * kGroup;
        const unsigned m = stage_group(L, idx, live, r0, tile, lane);
        unsigned lm = __ballot_sync(kFull, m != 0);
        while (lm) {
            const int i = __ffs(lm) - 1;
            lm &= lm - 1;
            unsigned pm = __shfl_sync(kFull, m, i);
            const int* trow = tile + i * L.T;
            const float cv = active ? __ldg(ct + (r0 + i) * L.Cout + co) : 0.f;
            while (pm) {
                int tb[U], jb[U];
                next_taps<U>(pm, tb);
#pragma unroll
                for (int q = 0; q < U; ++q) jb[q] = tb[q] >= 0 ? trow[tb[q]] : -1;
                for (int k0 = 0; k0 * L.G < L.C4; k0 += NK) {
                    typename V::T xv[U][NK];
#pragma unroll
                    for (int q = 0; q < U; ++q)
#pragma unroll
                        for (int k = 0; k < NK; ++k) {
                            const int c = cg + (k0 + k) * L.G;
                            xv[q][k] = (jb[q] >= 0 && active && c < L.C4)
                                ? V::load(x + jb[q] * L.Cin + c * VEC) : V::zero();
                        }
#pragma unroll
                    for (int q = 0; q < U; ++q)
#pragma unroll
                        for (int k = 0; k < NK; ++k) {
                            const int c = cg + (k0 + k) * L.G;
                            if (jb[q] >= 0 && active && c < L.C4) {
#pragma unroll
                                for (int u = 0; u < VEC; ++u)
                                    atomicAdd(dws + widx<VEC>(L, tb[q], u, c, co),
                                              V::at(xv[q][k], u) * cv);
                            }
                        }
                }
            }
        }
        __syncwarp();     // the tile is rewritten by the next group
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nw; e += kThreads) {
        const int co2 = e % L.Cout, ci = (e / L.Cout) % L.Cin, t = e / (L.Cout * L.Cin);
        const float v = dws[widx<VEC>(L, t, ci % VEC, ci / VEC, co2)];
        if (v != 0.f) atomicAdd(dw + e, v);
    }
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

Layout make_layout(const float* x, int R, int T, int Cin, int Cout, int* vec) {
    Layout L;
    L.R = R; L.T = T; L.Cin = Cin; L.Cout = Cout;
    *vec = (Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) ? 4 : 1;
    L.C4 = Cin / *vec;
    L.G = 32 / Cout;
    // an odd number of VEC-word units a W row: distinct banks by co
    L.CinP = *vec * (L.C4 | 1);
    // a slot's stage: T rows of Cin words plus an odd number of VEC-word
    // units, at most kStageWords a warp
    L.XsSlot = T * Cin + *vec;
    if ((L.XsSlot / *vec) % 2 == 0) L.XsSlot += *vec;
    L.S = kStageWords / L.XsSlot;
    if (L.S > 32 / Cout) L.S = 32 / Cout;
    if (L.S < 1) L.S = 1;
    L.C4P = 1;
    while (L.C4P < L.C4) L.C4P *= 2;
    L.mT = (65536u + T - 1) / T;
    L.mC = (65536u + Cout - 1) / Cout;
    return L;
}

size_t tiles_bytes() { return (size_t)kWarps * kTile * 4; }

// Occupancy-sized persistent grid, no more blocks than row groups need.
template <typename K>
int launch(K kernel, size_t smem, const Layout& L, cudaStream_t stream,
           const float* x, const int* idx, const unsigned char* live, const float* third,
           float* out) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int ngroups = (L.R + kGroup - 1) / kGroup;
    const int need = (ngroups + kWarps - 1) / kWarps;
    const int cap = per_sm * sm_count();
    const int blocks = need < cap ? need : cap;
    kernel<<<blocks, kThreads, smem, stream>>>(x, idx, live, third, out, L);
    return (int)cudaGetLastError();
}

// K4's instances: VEC 4 with NC >= Cin / 4 float4 a tap unrolled, or the
// scalar form for Cin % 4 != 0 (or x off 16 bytes).
int dispatch_fwd(const Layout& L, int vec, cudaStream_t stream, const float* x,
                 const int* idx, const unsigned char* live, const float* w, float* out) {
    const size_t smem = ((size_t)L.T * L.Cout * L.CinP + (size_t)kWarps * L.S * L.XsSlot) * 4
        + tiles_bytes() + (size_t)kWarps * 32 * 4;
    if (vec == 1)
        return launch(gather_conv_kernel<1, 4>, smem, L, stream, x, idx, live, w, out);
    if (L.C4 <= 2)
        return launch(gather_conv_kernel<4, 2>, smem, L, stream, x, idx, live, w, out);
    if (L.C4 <= 4)
        return launch(gather_conv_kernel<4, 4>, smem, L, stream, x, idx, live, w, out);
    return launch(gather_conv_kernel<4, 8>, smem, L, stream, x, idx, live, w, out);
}

// K4w's instances: VEC 4 with NK float4 a lane a tap and U taps a batch
// (U * NK = 8 float4 in flight), or the scalar form.
int dispatch_dw(const Layout& L, int vec, cudaStream_t stream, const float* x,
                const int* idx, const unsigned char* live, const float* ct, float* dw) {
    const size_t smem = (size_t)((L.T * L.Cin * L.Cout + 3) & ~3) * 4 + tiles_bytes();
    const int nk = (L.C4 + L.G - 1) / L.G;
    if (vec == 1)
        return launch(gather_conv_dw_kernel<1, 4, 4>, smem, L, stream, x, idx, live, ct, dw);
    if (nk <= 1)
        return launch(gather_conv_dw_kernel<4, 1, 8>, smem, L, stream, x, idx, live, ct, dw);
    if (nk <= 2)
        return launch(gather_conv_dw_kernel<4, 2, 4>, smem, L, stream, x, idx, live, ct, dw);
    return launch(gather_conv_dw_kernel<4, 4, 2>, smem, L, stream, x, idx, live, ct, dw);
}

}  // namespace

extern "C" {

// K4.  x (M, Cin) f32, idx (R, T) int32 (-1 = zero), w (T, Cin, Cout) f32,
// out (R, Cout) f32; T <= 27, Cin, Cout <= 32, R * max(T, Cout) and M * Cin
// below 2^31.  live (R,) bytes or null: a row whose byte is 0 reads no
// table entry and is written zero.
int gather_conv(const float* x, const int* idx, const float* w, float* out, long long R,
                int T, int Cin, int Cout, void* stream, const unsigned char* live) {
    if (T > kMaxT || Cin < 1 || Cin > 32 || Cout < 1 || Cout > 32 || R >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (R <= 0) return 0;
    if (T <= 0)
        return (int)cudaMemsetAsync(out, 0, (size_t)R * Cout * 4, (cudaStream_t)stream);
    int vec;
    const Layout L = make_layout(x, (int)R, T, Cin, Cout, &vec);
    return dispatch_fwd(L, vec, (cudaStream_t)stream, x, idx, live, w, out);
}

// K4w.  x (M, Cin) f32, idx (R, T) int32 (-1 = skipped), ct (R, Cout)
// f32; dw (T, Cin, Cout) f32 zero-filled by the caller; live as for K4
// (a row whose byte is 0 is skipped).
int gather_conv_dw(const float* x, const int* idx, const float* ct, float* dw, long long R,
                   int T, int Cin, int Cout, void* stream, const unsigned char* live) {
    if (T > kMaxT || Cin < 1 || Cin > 32 || Cout < 1 || Cout > 32 || R >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (R <= 0 || T <= 0) return 0;
    int vec;
    const Layout L = make_layout(x, (int)R, T, Cin, Cout, &vec);
    return dispatch_dw(L, vec, (cudaStream_t)stream, x, idx, live, ct, dw);
}

}  // extern "C"
