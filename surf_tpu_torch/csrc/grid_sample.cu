// K1 bilinear_sample_2d and K2 trilinear_sample_3d: dense image / volume
// sampling with zero padding, value path.
//
// Replaces (surf_tpu/ops/grid_sample.py):
//   K1: _bilinear_core (:78, public bilinear_sample_2d :133) and _bsp_core
//       (:205, public bilinear_sample_packed :193) — the packed form is a
//       TPU gather layout; K1 reads the unpacked (V, H, W, C) image.
//   K2: _trilinear_core_cm (:347, public trilinear_sample_3d_cm :328) and
//       the values of trilinear_sample_3d (:278), trilinear_sample_packed_3d
//       (:612) and PackedVolume (:435).
//
// Bound on the card: bytes.  Each sample reads its coordinates, 4 (K1) or
// 8 (K2) corner rows of C values and writes C values; at most a few FLOPs
// per byte.  The main-path images and volumes (<= 0.7 GB) are gathered at
// random, so the achievable rate is set by L2/HBM sector traffic, not by
// arithmetic.
//
// K1 design.  What keeps such a gather from its byte bound is
// instructions: work that belongs to the sample, done once per (sample,
// channel), and 64-bit index divisions.  So each sample's geometry is
// computed once (``bilinear_taps``: one float2 load, floor, the four
// corner weights, a 4-bit mask of the corners inside, tested in float so
// a far-off or NaN coordinate is never converted), all index arithmetic
// is 32-bit (the wrapper keeps the image below 2^31 elements; the output
// offset is 64-bit), and the grid is (points, views), so no thread
// divides by N.
// Two launch shapes, chosen on C:
//   * rows (C = 1, 3, or 4 on a 16-byte aligned image): one thread per
//     sample; C = 4 reads each corner row and writes the output row as
//     one 16-byte vector;
//   * spread (C = 19, the fused pyramid, and any other C): a block takes
//     256 samples; its threads compute their geometry into shared memory,
//     then walk the block's contiguous (256, C) output span, neighbouring
//     lanes on neighbouring channels of one sample, so each corner row is
//     read and each output row written as a contiguous span (16-byte
//     vectors when C is a multiple of 4 and the image is aligned).
// Every thread issues its four corner loads before it adds any (a corner
// outside reads a texel that exists and is added with weight 0, as the
// plain version adds its clamped read times 0), so four gathers are in
// flight at once.  The corner sum runs in the reference's order (0,0),
// (1,0), (0,1), (1,1) from 0, with the plain PyTorch version's operation
// order (built with -fmad=false, so the floors and products agree).  No
// atomics: the output is the same bit for bit from run to run.
//
// K2 design.  The path calls K2 at C = 1 on the bf16 704^3 matching
// volume: 8 two-byte gathers a sample, each in a 32-byte sector of its
// own.  At build_z_vals the sectors a call touches fit in L2 (under 31
// MB), so what costs is the instructions and the gathers' requests, not
// the memory's bytes.  One thread per sample
// (no division by C; C = 1 a template parameter, a run-time-C loop for
// the rest); each axis's geometry once (``tri_axis``: floor, the two
// clamped voxel indices and inside flags, tested and clamped in float, so
// a far-off or NaN coordinate is never converted out of range); 32-bit
// voxel offsets (the wrapper keeps the volume below 2^31 elements).  The
// 8 corners are clamped to the volume and all 8 loads are issued before
// any add; an outside corner is added with weight 0, as the plain version
// multiplies its clamped read by its 0/1 inside mask.  Each corner is one
// 2-byte load: reading a z-pair (z0, z0+1) as one 4-byte word where its
// offset is even, and a second word where not, measured 1.4x slower at
// build_z_vals on the H100.  The corner sum runs in the reference's order
// from the first term, with the plain version's operation order
// (-fmad=false), so the output is equal bit for bit to
// ``trilinear_sample_plain``.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float unnormalize(float c, int size, int align) {
    if (align) return (c + 1.0f) * 0.5f * (float)(size - 1);
    return ((c + 1.0f) * (float)size - 1.0f) * 0.5f;
}

// d(unnormalized coordinate) / d(coordinate) along an axis of ``size``.
__device__ __forceinline__ float coord_scale(int size, int normalized, int align) {
    if (!normalized) return 1.0f;
    return align ? 0.5f * (float)(size - 1) : 0.5f * (float)size;
}

// ---------------------------------------------------------------------------
// K1 / K1b: one sample's bilinear geometry
// ---------------------------------------------------------------------------

struct Taps {
    int off;        // texel index of the (0,0) corner in the (V*H*W) image
    int mask;       // bit k: corner k inside the image
    float fx, fy;   // fractional position
};

// Corner k in the reference's order: (ox, oy) = (k & 1, k >> 1).
__device__ __forceinline__ float corner_wx(const Taps& t, int k) {
    return (k & 1) ? t.fx : 1.0f - t.fx;
}
__device__ __forceinline__ float corner_wy(const Taps& t, int k) {
    return (k >> 1) ? t.fy : 1.0f - t.fy;
}
__device__ __forceinline__ int corner_texel(const Taps& t, int k, int W) {
    return t.off + (k & 1) + ((k >> 1) ? W : 0);
}

// Corner k's texel if it is inside, else ``fallback`` (a texel that
// exists), and its weight, 0 outside: the forward reads every corner and
// adds value * weight, as the plain version adds its clamped read times 0.
__device__ __forceinline__ int safe_texel(const Taps& t, int k, int fallback, int W) {
    return ((t.mask >> k) & 1) ? corner_texel(t, k, W) : fallback;
}
__device__ __forceinline__ float corner_weight(const Taps& t, int k) {
    return ((t.mask >> k) & 1) ? corner_wx(t, k) * corner_wy(t, k) : 0.0f;
}

__device__ __forceinline__ Taps bilinear_taps(float2 c, int v, int H, int W,
                                              int normalized, int align) {
    float x = c.x, y = c.y;
    if (normalized) {
        x = unnormalize(x, W, align);
        y = unnormalize(y, H, align);
    }
    const float x0f = floorf(x), y0f = floorf(y);
    Taps t;
    t.fx = x - x0f;
    t.fy = y - y0f;
    const bool vx0 = x0f >= 0.0f && x0f < (float)W;
    const bool vx1 = x0f >= -1.0f && x0f < (float)(W - 1);
    const bool vy0 = y0f >= 0.0f && y0f < (float)H;
    const bool vy1 = y0f >= -1.0f && y0f < (float)(H - 1);
    t.mask = (int)(vx0 && vy0) | (int)(vx1 && vy0) << 1 | (int)(vx0 && vy1) << 2 |
             (int)(vx1 && vy1) << 3;
    const int x0 = t.mask ? (int)x0f : 0, y0 = t.mask ? (int)y0f : 0;
    t.off = (v * H + y0) * W + x0;
    return t;
}

// K floats from p: 16-byte vectors when K is a multiple of 4 (the caller
// guarantees the alignment), else one at a time.
template <int K>
__device__ __forceinline__ void load_vec(float (&r)[K], const float* p) {
    if constexpr (K % 4 == 0) {
#pragma unroll
        for (int i = 0; i < K; i += 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
            r[i] = q.x; r[i + 1] = q.y; r[i + 2] = q.z; r[i + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < K; ++i) r[i] = __ldg(p + i);
    }
}

// K floats to p, as ``load_vec`` reads them.
template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[K]) {
    if constexpr (K % 4 == 0) {
#pragma unroll
        for (int i = 0; i < K; i += 4)
            *reinterpret_cast<float4*>(p + i) = make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
    } else {
#pragma unroll
        for (int i = 0; i < K; ++i) p[i] = r[i];
    }
}

// ---------------------------------------------------------------------------
// K1, rows: one thread per sample, CT in {1, 3, 4}
// ---------------------------------------------------------------------------

template <int CT>
__global__ void __launch_bounds__(kThreads)
bilinear_rows_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                     float* __restrict__ out, int H, int W, int N, int normalized,
                     int align) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= N) return;
    const int v = blockIdx.y;
    const long long vn = (long long)v * N + p;
    const Taps t = bilinear_taps(coords[vn], v, H, W, normalized, align);
    // all four loads in flight at once
    float r[4][CT];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        load_vec<CT>(r[k], img + safe_texel(t, k, v * H * W, W) * CT);
    float acc[CT];
#pragma unroll
    for (int i = 0; i < CT; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float w = corner_weight(t, k);
#pragma unroll
        for (int i = 0; i < CT; ++i) acc[i] += r[k][i] * w;
    }
    store_vec<CT>(out + vn * CT, acc);
}

// ---------------------------------------------------------------------------
// K1, spread: a block of 256 samples, its (256, C) output span walked by
// channel (VEC channels a thread); CT = 0 takes C at run time
// ---------------------------------------------------------------------------

template <int VEC>
__device__ __forceinline__ void madd(float (&acc)[VEC], const float (&r)[VEC], float w) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += r[i] * w;
}

template <int CT, int VEC>
__global__ void __launch_bounds__(kThreads)
bilinear_spread_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                       float* __restrict__ out, int H, int W, int C_rt, int N,
                       int normalized, int align) {
    __shared__ float4 s_w[kThreads];     // the four corner weights, 0 outside
    __shared__ int4 s_tex[kThreads];     // the four corner texels (safe)
    const int C = CT ? CT : C_rt;
    const int v = blockIdx.y;
    const int p0 = blockIdx.x * kThreads;
    const int n = min(kThreads, N - p0);
    const long long row0 = (long long)v * N + p0;
    if ((int)threadIdx.x < n) {
        const Taps t = bilinear_taps(coords[row0 + threadIdx.x], v, H, W, normalized,
                                     align);
        s_w[threadIdx.x] = make_float4(corner_weight(t, 0), corner_weight(t, 1),
                                       corner_weight(t, 2), corner_weight(t, 3));
        const int vbase = v * H * W;
        s_tex[threadIdx.x] = make_int4(safe_texel(t, 0, vbase, W), safe_texel(t, 1, vbase, W),
                                       safe_texel(t, 2, vbase, W), safe_texel(t, 3, vbase, W));
    }
    __syncthreads();
    const int chunks = C / VEC;                  // per sample
    const int span = n * chunks;
    float* o = out + row0 * C;
#pragma unroll 4
    for (int e = threadIdx.x; e < span; e += kThreads) {
        const int s = e / chunks;
        const int c = (e - s * chunks) * VEC;
        const float4 w = s_w[s];
        const int4 tex = s_tex[s];
        float r[4][VEC];
        load_vec<VEC>(r[0], img + tex.x * C + c);
        load_vec<VEC>(r[1], img + tex.y * C + c);
        load_vec<VEC>(r[2], img + tex.z * C + c);
        load_vec<VEC>(r[3], img + tex.w * C + c);
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
        madd<VEC>(acc, r[0], w.x);
        madd<VEC>(acc, r[1], w.y);
        madd<VEC>(acc, r[2], w.z);
        madd<VEC>(acc, r[3], w.w);
        store_vec<VEC>(o + e * VEC, acc);
    }
}

// ---------------------------------------------------------------------------
// K2: one thread per sample; CT = 1 (the path's C) or 0 (C at run time)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One axis of a sample's trilinear cell: the low and high corner's voxel
// index clamped to the volume, their 0/1 inside masks and the fraction f
// (g = 1 - f), as the plain version forms them.
struct Axis {
    int i0, i1;
    float in0, in1;
    float f, g;
};

__device__ __forceinline__ Axis tri_axis(float c, int size) {
    const float c0 = floorf(c), hi = (float)(size - 1);
    Axis a;
    a.f = c - c0;
    a.g = 1.0f - a.f;
    a.i0 = (int)fminf(fmaxf(c0, 0.0f), hi);
    a.i1 = (int)fminf(fmaxf(c0 + 1.0f, 0.0f), hi);
    a.in0 = (c0 >= 0.0f && c0 < (float)size) ? 1.0f : 0.0f;
    a.in1 = (c0 >= -1.0f && c0 < hi) ? 1.0f : 0.0f;
    return a;
}

template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
trilinear_kernel(const T* __restrict__ vol, const float* __restrict__ coords,
                 float* __restrict__ out, int X, int Y, int Z, int C_rt, int N,
                 int normalized, int align) {
    const int C = CT ? CT : C_rt;
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= N) return;
    const float* co = coords + 3 * (long long)p;
    float x = co[0], y = co[1], z = co[2];
    if (normalized) {
        x = unnormalize(x, X, align);
        y = unnormalize(y, Y, align);
        z = unnormalize(z, Z, align);
    }
    const Axis ax = tri_axis(x, X), ay = tri_axis(y, Y), az = tri_axis(z, Z);
    // corner k = 4 ox + 2 oy + oz: its (x, y) row's first voxel, its weight
    // times its inside mask, in the plain version's operation order
    int row[4];
    float w[8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
        row[r] = (((r >> 1) ? ax.i1 : ax.i0) * Y + ((r & 1) ? ay.i1 : ay.i0)) * Z;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
        const float wk = ((ox ? ax.f : ax.g) * (oy ? ay.f : ay.g)) * (oz ? az.f : az.g);
        const float in = ((ox ? ax.in1 : ax.in0) * (oy ? ay.in1 : ay.in0)) *
                         (oz ? az.in1 : az.in0);
        w[k] = wk * in;
    }
    if constexpr (CT == 1) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = to_float(vol[row[k >> 1] + ((k & 1) ? az.i1 : az.i0)]);
        float acc = v[0] * w[0];
#pragma unroll
        for (int k = 1; k < 8; ++k) acc = acc + v[k] * w[k];
        out[p] = acc;
    } else {
        float* o = out + (long long)p * C;
        for (int c = 0; c < C; ++c) {
            float v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
                v[k] = to_float(vol[(row[k >> 1] + ((k & 1) ? az.i1 : az.i0)) * C + c]);
            float acc = v[0] * w[0];
#pragma unroll
            for (int k = 1; k < 8; ++k) acc = acc + v[k] * w[k];
            o[c] = acc;
        }
    }
}

// ---------------------------------------------------------------------------
// K1b / K2b: the backward of K1 / K2 (training).
//
// Replaces (surf_tpu/ops/grid_sample.py): K1b _bilinear_core_bwd (:102)
// and _bsp_bwd (:223; its d_packed unpacks to the same d_image); K2b
// _tri_cm_bwd (:355).
//
// Bound on the card: bytes.  Per sample: its coordinates and C cotangents
// read, 4 (8) corner rows of C values read when d_coords is wanted, 4 (8)
// x C atomic adds into d_image / d_volume, 2 (3) coordinate gradients
// written.
//
// K1b design.  What keeps such a scatter from its byte bound is the
// atomics it issues (a scalar one for every corner and channel is 16 a
// point at C = 4) and, on the main path, zeros: the back_project
// cotangent is zero on every inactive child row, which at the training
// step's stage 3 is every row.  One thread per sample on a (points,
// views) grid, with 32-bit index arithmetic:
//   * the cotangent row is read once (a 16-byte vector at C = 4); a row
//     that is all zero scatters nothing (adding exact zeros changes
//     nothing) and writes d_coords = 0 without reading the image;
//   * before each corner's scatter the warp groups its lanes by the
//     corner's texel (__match_any_sync) and sums each group's rows into
//     its lowest lane by a shuffle tree (at most 5 steps), so a texel that
//     several lanes hit takes one atomic;
//   * a row is added with Hopper's vector float atomics where it is
//     aligned (one 16-byte atomicAdd at C = 4; C a multiple of 4 in
//     16-byte chunks), else channel by channel;
//   * d_coords' per-corner dot product reads each corner row once, from
//     the same row loads.
// The sums into d_image run in an order that changes from run to run
// (atomics across warps, a shuffle tree within one); d_coords is summed
// per sample in the reference's corner and channel order.
//
// K2b design.  The path calls K2b at C = 1 on `depth_render`'s bf16
// matching volume (88^3 to 704^3), with 2.5 to 9.8 M samples laid out
// (rays, samples): neighbouring samples walk one ray, and neighbouring rays
// are less than a voxel apart.  The gradient is summed in f32 and cast to
// bf16 once.  Two things keep such a scatter from its byte bound:
//   * the full-volume f32 buffer.  At 704^3 zero-filling 1.4 GB and
//     casting it (1.4 GB read, 0.7 GB written) is 3.5 GB of traffic, when
//     the samples of a stage lie in thin bands around the previous depth
//     and touch a few per cent of the volume.  For a large volume (the
//     wrapper's rule) the bricked form keeps a map of 8^3-voxel bricks:
//     ``trilinear_bwd_mark_kernel`` marks the bricks that the in-range
//     corners of the samples with a nonzero cotangent fall in (plain
//     stores, a warp's lanes in one brick marking it once),
//     ``trilinear_bwd_zero_kernel`` zeroes the marked bricks of the
//     uninitialised f32 buffer, the scatter adds into it, and
//     ``trilinear_bwd_finish_kernel`` writes the bf16 output in one linear
//     pass, the cast of a marked brick or zeros.  A small volume takes the
//     single pass: the wrapper zero-fills the f32 buffer, the finish pass
//     casts all of it;
//   * the atomics, 8 a sample, where neighbouring lanes often hold one
//     cell.  ``trilinear_bwd_scatter_kernel`` gives a warp 32 consecutive
//     samples at a time; the lanes in a row in one cell sum their 8
//     corner values into the run's first lane by a segmented shuffle sum
//     (``run_sum``), and that lane adds each nonzero sum with one
//     fire-and-forget global atomic (``red.global.add.f32``); a warp whose
//     cotangents are all zero does nothing.  The warps on the card at one
//     time take far-apart chunks of samples (``spread_chunk``): on
//     neighbouring rays their atomics meet on the same voxels, which the
//     L2 serialises.  On the H100, merging further
//     before the atomics lost: a block-wide hash table in shared memory
//     (its f32 adds are compare-and-swap loops there) and
//     __match_any_sync over 8 corners (its cost grows with the distinct
//     keys in a warp, which along a ray are many) both cost more than the
//     global atomics they saved.  Offsets are 32-bit (the wrapper keeps
//     the volume below 2^31 elements).  That kernel is the C = 1 form
//     only; any other C (K2s's C = 16; none on the path) takes the rows
//     form, ``trilinear_bwd_scatter_rows_kernel``, which merges the same
//     runs a row at a time and adds each merged row with 16-byte vector
//     atomics where C is a multiple of 4 and the rows are aligned, scalar
//     ones otherwise (the K2s block below).
// d_coords, when asked, is ``trilinear_bwd_coords_kernel``: a thread a
// sample, the corners in the reference's order, channels summed in order,
// the product rule through the fractional weights (corner indices carry
// no gradient).  The d_volume sums run in an order that changes from run
// to run.
// ---------------------------------------------------------------------------

// The shuffle schedule that sums every group of peers (the lanes holding
// one key) into its lowest lane: a tree over the group's ranks.  Step s
// adds the value of src[s] (-1: nothing); the steps are warp-uniform.
struct PeerTree {
    int src[5];
    int steps;
};

__device__ __forceinline__ PeerTree peer_tree(unsigned peers, int lane) {
    PeerTree t;
    t.steps = 0;
#pragma unroll
    for (int s = 0; s < 5; ++s) t.src[s] = -1;
    int rank = __popc(peers & ((1u << lane) - 1u));
    unsigned rest = peers & ~((2u << lane) - 1u);        // peers above this lane
#pragma unroll
    for (int s = 0; s < 5; ++s) {
        if (!__any_sync(kFull, rest != 0u)) break;
        t.src[s] = __ffs(rest) - 1;
        t.steps = s + 1;
        rest &= ~__ballot_sync(kFull, rank & 1);
        rank >>= 1;
    }
    return t;
}

template <int K>
__device__ __forceinline__ void tree_sum(const PeerTree& t, float (&x)[K]) {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
        if (s >= t.steps) break;
        const int src = t.src[s];
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const float o = __shfl_sync(kFull, x[i], src < 0 ? 0 : src);
            if (src >= 0) x[i] += o;
        }
    }
}

// Adds K values at p with atomics: 16-byte vector atomics when K is a
// multiple of 4 (the caller guarantees the alignment), else one at a time.
template <int K>
__device__ __forceinline__ void atomic_add_row(float* p, const float (&x)[K]) {
    if constexpr (K % 4 == 0) {
#pragma unroll
        for (int i = 0; i < K; i += 4)
            atomicAdd(reinterpret_cast<float4*>(p + i),
                      make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
    } else {
#pragma unroll
        for (int i = 0; i < K; ++i) atomicAdd(p + i, x[i]);
    }
}

// Corner k's weight in K1b's scatter: the bilinear weight wx wy or, with
// DIR (K1s), its derivative along the sample's direction scaled to pixel
// units (hx, hy): d_x w_k hx + d_y w_k hy, as the plain version forms it
// (an inside corner's 0/1 flag is 1).
template <bool DIR>
__device__ __forceinline__ float bilinear_scatter_weight(const Taps& t, int k, float hx,
                                                         float hy) {
    const float wx = corner_wx(t, k), wy = corner_wy(t, k);
    if constexpr (!DIR) return wx * wy;
    return ((k & 1) ? wy : -wy) * hx + ((k >> 1) ? wx : -wx) * hy;
}

// CT in {1, 3, 4} (and 16 for K1s): the whole row in registers (16-byte
// vectors where CT is a multiple of 4).  CT = 0: C at run time, in chunks
// of VEC channels (4: 16-byte vectors, C a multiple of 4 and the rows
// aligned; else 1).  DIR: K1s, the directional weights of ``h`` (V, N);
// a corner whose weight is 0 scatters nothing, and d_coords is not written.
template <int CT, int VEC, bool DIR>
__global__ void __launch_bounds__(kThreads)
bilinear_bwd_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                    const float2* __restrict__ h, const float* __restrict__ ct,
                    float* __restrict__ d_img, float2* __restrict__ d_coords, int H, int W,
                    int C_rt, int N, int normalized, int align) {
    constexpr int K = CT ? CT : VEC;             // channels a chunk
    const int C = CT ? CT : C_rt;
    const int p = blockIdx.x * kThreads + threadIdx.x;
    const int v = blockIdx.y;
    const int lane = threadIdx.x & 31;
    // lanes past the end stay for the warp's collectives and scatter nothing
    const bool live = p < N;
    const long long vn = (long long)v * N + (live ? p : N - 1);
    const Taps t = bilinear_taps(coords[vn], v, H, W, normalized, align);
    float hx = 0.0f, hy = 0.0f;
    if constexpr (DIR) {
        const float2 hv = h[vn];
        hx = hv.x * coord_scale(W, normalized, align);
        hy = hv.y * coord_scale(H, normalized, align);
    }
    const float* g = ct + vn * C;
    float row[K];                                // the whole row when CT != 0
    bool nz = false;
    if constexpr (CT != 0) {
        load_vec<K>(row, g);
#pragma unroll
        for (int i = 0; i < K; ++i) nz |= row[i] != 0.0f;
    } else {
        for (int c = 0; c < C; ++c) nz |= __ldg(g + c) != 0.0f;
    }
    const int scatter = (live && nz) ? t.mask : 0;

    if (d_img != nullptr && __any_sync(kFull, scatter != 0)) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float w = bilinear_scatter_weight<DIR>(t, k, hx, hy);
            const bool on = ((scatter >> k) & 1) && (!DIR || w != 0.0f);
            const int texel = on ? corner_texel(t, k, W) : -1;
            const unsigned peers = __match_any_sync(kFull, texel);
            const bool leader = (peers & ((1u << lane) - 1u)) == 0u;
            const PeerTree tree = peer_tree(peers, lane);
            float* dst = d_img + (long long)texel * C;
            for (int c = 0; c < C; c += K) {
                float x[K];
                if constexpr (CT != 0) {
#pragma unroll
                    for (int i = 0; i < K; ++i) x[i] = row[i];
                } else {
                    load_vec<K>(x, g + c);
                }
#pragma unroll
                for (int i = 0; i < K; ++i) x[i] *= w;
                tree_sum<K>(tree, x);
                if (on && leader) atomic_add_row<K>(dst + c, x);
            }
        }
    }

    if (!DIR && d_coords != nullptr && live) {
        float dx = 0.0f, dy = 0.0f;
        if (nz) {
            // the four corner rows loaded before any is used; a corner
            // outside contributes s = 0, as in the plain version
            float s[4];
            if constexpr (CT != 0) {
                float r[4][K];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    load_vec<K>(r[k], img + safe_texel(t, k, v * H * W, W) * K);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    s[k] = 0.0f;
#pragma unroll
                    for (int i = 0; i < K; ++i) s[k] += r[k][i] * row[i];
                }
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float* q = img + (long long)safe_texel(t, k, v * H * W, W) * C;
                    s[k] = 0.0f;
                    for (int c = 0; c < C; c += K) {
                        float a[K], b[K];
                        load_vec<K>(a, q + c);
                        load_vec<K>(b, g + c);
#pragma unroll
                        for (int i = 0; i < K; ++i) s[k] += a[i] * b[i];
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float sk = ((t.mask >> k) & 1) ? s[k] : 0.0f;
                dx += sk * ((k & 1) ? 1.0f : -1.0f) * corner_wy(t, k);
                dy += sk * ((k >> 1) ? 1.0f : -1.0f) * corner_wx(t, k);
            }
        }
        d_coords[vn] = make_float2(dx * coord_scale(W, normalized, align),
                                   dy * coord_scale(H, normalized, align));
    }
}

// One sample's trilinear cell for K2b: the low corner (x0, y0, z0), the
// fractions, and an 8-bit mask of the corners inside the volume (bit k =
// 4 ox + 2 oy + oz), tested in float before any conversion, so a far-off or
// NaN coordinate has mask 0 and is never converted.
struct Cell3 {
    int x0, y0, z0;
    int mask;
    float fx, fy, fz;
};

__device__ __forceinline__ Cell3 tri_cell(const float* co, int X, int Y, int Z,
                                          int normalized, int align) {
    float x = co[0], y = co[1], z = co[2];
    if (normalized) {
        x = unnormalize(x, X, align);
        y = unnormalize(y, Y, align);
        z = unnormalize(z, Z, align);
    }
    const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
    Cell3 c;
    c.fx = x - x0f;
    c.fy = y - y0f;
    c.fz = z - z0f;
    // per axis: bit 0 the low corner inside, bit 1 the high one
    const int mx = (int)(x0f >= 0.0f && x0f < (float)X) | (int)(x0f >= -1.0f && x0f < (float)(X - 1)) << 1;
    const int my = (int)(y0f >= 0.0f && y0f < (float)Y) | (int)(y0f >= -1.0f && y0f < (float)(Y - 1)) << 1;
    const int mz = (int)(z0f >= 0.0f && z0f < (float)Z) | (int)(z0f >= -1.0f && z0f < (float)(Z - 1)) << 1;
    c.mask = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
        c.mask |= (((mx >> ((k >> 2) & 1)) & (my >> ((k >> 1) & 1)) & (mz >> (k & 1))) & 1) << k;
    c.x0 = c.mask ? (int)x0f : 0;
    c.y0 = c.mask ? (int)y0f : 0;
    c.z0 = c.mask ? (int)z0f : 0;
    return c;
}

// Corner k's voxel and its weight (wx * wy) * wz, as the plain version
// forms them.
__device__ __forceinline__ int cell_voxel(const Cell3& c, int k, int Y, int Z) {
    return ((c.x0 + ((k >> 2) & 1)) * Y + (c.y0 + ((k >> 1) & 1))) * Z + c.z0 + (k & 1);
}
__device__ __forceinline__ float cell_weight(const Cell3& c, int k) {
    const float wx = ((k >> 2) & 1) ? c.fx : 1.0f - c.fx;
    const float wy = ((k >> 1) & 1) ? c.fy : 1.0f - c.fy;
    const float wz = (k & 1) ? c.fz : 1.0f - c.fz;
    return wx * wy * wz;
}

// Corner k's weight in K2b's scatter: the trilinear weight (``dirs``
// null) or, for K2s, its derivative along the sample's direction scaled
// to voxel units (hx, hy, hz): d_x w_k hx + d_y w_k hy + d_z w_k hz.
__device__ __forceinline__ float scatter_weight(const Cell3& c, int k, bool dirs, float hx,
                                                float hy, float hz) {
    if (!dirs) return cell_weight(c, k);
    const float wx = ((k >> 2) & 1) ? c.fx : 1.0f - c.fx;
    const float wy = ((k >> 1) & 1) ? c.fy : 1.0f - c.fy;
    const float wz = (k & 1) ? c.fz : 1.0f - c.fz;
    const float dx = ((k >> 2) & 1) ? wy * wz : -(wy * wz);
    const float dy = ((k >> 1) & 1) ? wx * wz : -(wx * wz);
    const float dz = (k & 1) ? wx * wy : -(wx * wy);
    return dx * hx + dy * hy + dz * hz;
}

constexpr int kBwdRun = 4;                        // 32-sample chunks a warp
constexpr int kBwdWarps = kThreads / 32;
constexpr int kBwdTile = kThreads * kBwdRun;      // samples a block
constexpr int kBrick = 8;                         // brick edge, voxels

// Runs of lanes holding one key (a key compared with the previous
// lane's): each lane's run end, from the warp's run heads.
__device__ __forceinline__ int run_end(bool head, int lane) {
    const unsigned heads = __ballot_sync(kFull, head);
    const unsigned above = heads & ~((2u << lane) - 1u);
    return above ? __ffs(above) - 2 : 31;
}

// x summed over each run into its first lane (a segmented sum by
// doubling: lane i adds lane i + d's partial sum while i + d is in its
// run), with the steps runs of up to ``len`` lanes need (warp-uniform).
template <int K>
__device__ __forceinline__ void run_sum(float (&x)[K], int lane, int end, int len = 32) {
#pragma unroll
    for (int d = 1; d < len; d <<= 1) {
        const bool in = lane + d <= end;
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const float o = __shfl_down_sync(kFull, x[i], d);
            if (in) x[i] += o;
        }
    }
}

// A cell's key for run detection: its low corner, each index + 1 in 21
// bits (a side below 2^21 - 1); -1 - lane for a sample with no corner in
// range, so it is a run of its own.
__device__ __forceinline__ long long cell_key(const Cell3& c, int lane) {
    if (c.mask == 0) return -1 - lane;
    return ((long long)(c.x0 + 1) << 42) | ((long long)(c.y0 + 1) << 21) | (c.z0 + 1);
}

// An f32 add to global memory that returns nothing.
__device__ __forceinline__ void red_add(float* p, float v) {
    asm volatile("red.global.add.f32 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "f"(v));
}

// The bricked form's first pass: the bricks that a sample's in-range
// corners fall in, for every sample with a nonzero cotangent row, marked 1
// in ``bricks`` by plain stores (a lane leaves a brick to the previous
// lane when that lane marks it too).
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_mark_kernel(const float* __restrict__ coords, const float* __restrict__ ct,
                          int* __restrict__ bricks, int X, int Y, int Z, int C, int N,
                          int normalized, int align) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int BY = (Y + kBrick - 1) / kBrick, BZ = (Z + kBrick - 1) / kBrick;
    Cell3 c;
    c.mask = 0;
    if (p < N) {
        bool nz = false;
        for (int ch = 0; ch < C; ++ch) nz |= __ldg(ct + (long long)p * C + ch) != 0.0f;
        if (nz) c = tri_cell(coords + 3 * p, X, Y, Z, normalized, align);
    }
    if (!__any_sync(kFull, c.mask != 0)) return;
    int b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        b[k] = -1;
        if ((c.mask >> k) & 1)
            b[k] = (((c.x0 + ((k >> 2) & 1)) / kBrick) * BY + (c.y0 + ((k >> 1) & 1)) / kBrick) *
                       BZ + (c.z0 + (k & 1)) / kBrick;
        bool repeat = false;
#pragma unroll
        for (int j = 0; j < k; ++j) repeat |= b[j] == b[k];
        const int key = repeat ? -1 : b[k];
        const int prev = __shfl_up_sync(kFull, key, 1);
        if (key >= 0 && (lane == 0 || prev != key)) bricks[key] = 1;
    }
}

// The bricked form's second pass: a thread reads one brick's mark; the
// warp zeroes its marked bricks' voxels in ``buf`` (f32, (X, Y, Z, C))
// together, a lane two of a brick's 64 (x, y) rows.
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_zero_kernel(const int* __restrict__ bricks, float* __restrict__ buf, int X, int Y,
                          int Z, int C, int n_bricks) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    unsigned todo = __ballot_sync(kFull, t < n_bricks && bricks[t] != 0);
    const int BY = (Y + kBrick - 1) / kBrick, BZ = (Z + kBrick - 1) / kBrick;
    while (todo) {
        const int b = t - lane + __ffs(todo) - 1;
        todo &= todo - 1;
        const int bz = b % BZ, bxy = b / BZ, by = bxy % BY, bx = bxy / BY;
        const int z0 = bz * kBrick, span = min(kBrick, Z - z0) * C;
        for (int r = lane; r < kBrick * kBrick; r += 32) {
            const int x = bx * kBrick + r / kBrick, y = by * kBrick + r % kBrick;
            if (x >= X || y >= Y) continue;
            float* row = buf + ((long long)(x * Y + y) * Z + z0) * C;
            if (span % 4 == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
                for (int i = 0; i < span; i += 4)
                    *reinterpret_cast<float4*>(row + i) = make_float4(0.f, 0.f, 0.f, 0.f);
            } else {
                for (int i = 0; i < span; ++i) row[i] = 0.0f;
            }
        }
    }
}

// A block's counts (``s_counts``, zeroed at its start) added into
// ``counts`` (or null): each thread's scatters and atomics.
__device__ __forceinline__ void flush_counts(unsigned long long* counts, unsigned* s_counts,
                                             unsigned scatters, unsigned atomics) {
    if (counts == nullptr) return;
    __syncthreads();
    atomicAdd(s_counts, scatters);
    atomicAdd(s_counts + 1, atomics);
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicAdd(counts, (unsigned long long)s_counts[0]);
        atomicAdd(counts + 1, (unsigned long long)s_counts[1]);
    }
}

// The chunk of 32 * kBwdRun samples that warp w takes, of ``chunks``: the
// chunks in kSpread interleaved streams, so the warps on the card at one
// time work on samples far apart (far-apart rays), not on neighbouring
// rays whose atomics meet on the same voxels; -1 past the end.
constexpr int kSpread = 64;
__device__ __forceinline__ int spread_chunk(int w, int chunks) {
    const int per = (chunks + kSpread - 1) / kSpread;
    const int q = (w % kSpread) * per + w / kSpread;
    return q < chunks ? q : -1;
}

// d_volume's scatter into ``dst`` (f32 (X, Y, Z, C), zero where it is
// added to), with the trilinear weights or, given ``dirs`` (N, 3), K2s's
// directional ones (``scatter_weight``).  A warp takes kBwdRun chunks of
// 32 consecutive samples (``spread_chunk`` picks which), and the lanes in
// a row in one cell sum what they add into the run's first lane
// (``run_sum``).  ``counts`` (or null) receives the (corner, channel)
// scatters of nonzero cotangents and the global atomics issued.
//
// C = 1 (K2b on the path): the run's first lane adds each nonzero sum of
// its 8 corner values with one global atomic.
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_scatter_kernel(const float* __restrict__ coords, const float* __restrict__ ct,
                             const float* __restrict__ dirs, float* __restrict__ dst, int X,
                             int Y, int Z, int N, int normalized, int align,
                             unsigned long long* __restrict__ counts) {
    __shared__ unsigned s_counts[2];
    if (counts != nullptr && threadIdx.x < 2) s_counts[threadIdx.x] = 0u;
    const int lane = threadIdx.x & 31;
    const bool dir = dirs != nullptr;
    const float sx = coord_scale(X, normalized, align), sy = coord_scale(Y, normalized, align),
                sz = coord_scale(Z, normalized, align);
    unsigned scatters = 0, atomics = 0;
    const int chunk = spread_chunk(blockIdx.x * kBwdWarps + (threadIdx.x >> 5),
                                   (N + 32 * kBwdRun - 1) / (32 * kBwdRun));
    for (int it = 0; it < kBwdRun && chunk >= 0; ++it) {
        const int p = (chunk * kBwdRun + it) * 32 + lane;
        float hx = 0.0f, hy = 0.0f, hz = 0.0f;
        if (dir && p < N) {
            hx = __ldg(dirs + 3 * p) * sx;
            hy = __ldg(dirs + 3 * p + 1) * sy;
            hz = __ldg(dirs + 3 * p + 2) * sz;
        }
        Cell3 c;
        c.mask = 0;
        const float g = p < N ? __ldg(ct + p) : 0.0f;
        if (!__any_sync(kFull, g != 0.0f)) continue;
        if (p < N) c = tri_cell(coords + 3 * p, X, Y, Z, normalized, align);
        if (g != 0.0f) scatters += __popc(c.mask);
        // the lanes in a row in one cell (neighbouring samples of a ray; a
        // zero cotangent adds 0) sum into the run's first lane
        const long long key = cell_key(c, lane);
        const long long prev = __shfl_up_sync(kFull, key, 1);
        const bool head = lane == 0 || prev != key;
        float x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            x[k] = c.mask ? g * scatter_weight(c, k, dir, hx, hy, hz) : 0.0f;
        run_sum<8>(x, lane, run_end(head, lane));
        if (!head) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if (!((c.mask >> k) & 1) || x[k] == 0.0f) continue;
            red_add(dst + cell_voxel(c, k, Y, Z), x[k]);
            ++atomics;
        }
    }
    flush_counts(counts, s_counts, scatters, atomics);
}

// C != 1, the rows form: a sample whose cotangent row is all zero, a
// corner outside and a corner whose weight is 0 add nothing.  The run
// sums each corner's row VEC channels at a time, and its first lane adds
// the sum with one atomic a VEC channels where a lane of the run scatters
// that corner: 16-byte vector atomics at VEC = 4 (C a multiple of 4, the
// cotangent and the sum 16-byte aligned), scalar ones at VEC = 1.  The
// shuffle sum takes the steps the warp's longest run needs: none where no
// two neighbouring lanes share a cell.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_scatter_rows_kernel(const float* __restrict__ coords, const float* __restrict__ ct,
                                  const float* __restrict__ dirs, float* __restrict__ dst,
                                  int X, int Y, int Z, int C, int N, int normalized, int align,
                                  unsigned long long* __restrict__ counts) {
    __shared__ unsigned s_counts[2];
    if (counts != nullptr && threadIdx.x < 2) s_counts[threadIdx.x] = 0u;
    const int lane = threadIdx.x & 31;
    const bool dir = dirs != nullptr;
    const float sx = coord_scale(X, normalized, align), sy = coord_scale(Y, normalized, align),
                sz = coord_scale(Z, normalized, align);
    unsigned scatters = 0, atomics = 0;
    const int chunk = spread_chunk(blockIdx.x * kBwdWarps + (threadIdx.x >> 5),
                                   (N + 32 * kBwdRun - 1) / (32 * kBwdRun));
    for (int it = 0; it < kBwdRun && chunk >= 0; ++it) {
        const int p = (chunk * kBwdRun + it) * 32 + lane;
        const bool live = p < N;
        const float* g = ct + (long long)(live ? p : 0) * C;
        bool nz = false;
        for (int c = 0; live && c < C && !nz; c += VEC) {
            float x[VEC];
            load_vec<VEC>(x, g + c);
#pragma unroll
            for (int i = 0; i < VEC; ++i) nz |= x[i] != 0.0f;
        }
        if (!__any_sync(kFull, nz)) continue;
        Cell3 cell;
        cell.mask = 0;
        if (nz) cell = tri_cell(coords + 3 * (long long)p, X, Y, Z, normalized, align);
        float hx = 0.0f, hy = 0.0f, hz = 0.0f;
        if (dir && nz) {
            hx = __ldg(dirs + 3 * (long long)p) * sx;
            hy = __ldg(dirs + 3 * (long long)p + 1) * sy;
            hz = __ldg(dirs + 3 * (long long)p + 2) * sz;
        }
        // the runs of lanes in one cell, and the warp's longest
        const long long key = cell_key(cell, lane);
        const long long prev = __shfl_up_sync(kFull, key, 1);
        const bool head = lane == 0 || prev != key;
        const int end = run_end(head, lane);
        const int len = (int)__reduce_max_sync(kFull, (unsigned)(end - lane + 1));
        const unsigned run = ((2u << end) - 1u) & ~((1u << lane) - 1u);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const float w = scatter_weight(cell, k, dir, hx, hy, hz);
            // a run shares its cell, so its first lane knows the voxel
            // though its own weight may be 0
            const bool inside = (cell.mask >> k) & 1;
            const bool on = inside && w != 0.0f;
            const unsigned ons = __ballot_sync(kFull, on);
            if (ons == 0u) continue;
            if (on) scatters += C;
            const bool issue = head && (ons & run) != 0u;
            float* d = dst + (long long)(inside ? cell_voxel(cell, k, Y, Z) : 0) * C;
            for (int c = 0; c < C; c += VEC) {
                float x[VEC];
                load_vec<VEC>(x, g + c);
#pragma unroll
                for (int i = 0; i < VEC; ++i) x[i] = on ? x[i] * w : 0.0f;
                run_sum<VEC>(x, lane, end, len);
                if (issue) {
                    atomic_add_row<VEC>(d + c, x);
                    ++atomics;
                }
            }
        }
    }
    flush_counts(counts, s_counts, scatters, atomics);
}

// The volume-dtype (bf16) gradient in one linear pass: a warp an (x, y)
// row, a lane 8 voxels of z at a time; a touched brick's values are the
// f32 buffer's cast, an untouched one's zeros (``bricks`` null: every
// brick touched, the single-pass form).  ``fast``: C = 1, Z a multiple of
// 8 and both volumes 16-byte aligned (a lane's 8 voxels as two float4
// loads and one 16-byte store).
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_finish_kernel(const float* __restrict__ buf, const int* __restrict__ bricks,
                            __nv_bfloat16* __restrict__ out, int X, int Y, int Z, int C,
                            int fast) {
    const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    if (row >= X * Y) return;
    const int lane = threadIdx.x & 31;
    const int x = row / Y, y = row - x * Y;
    const int BY = (Y + kBrick - 1) / kBrick, BZ = (Z + kBrick - 1) / kBrick;
    const int* bmap = bricks == nullptr ? nullptr
                                        : bricks + ((x / kBrick) * BY + y / kBrick) * BZ;
    const long long base = (long long)row * Z * C;
    for (int bz = lane; bz < BZ; bz += 32) {
        const bool touched = bmap == nullptr || bmap[bz] != 0;
        const long long e0 = base + (long long)bz * kBrick * C;
        if (fast) {
            uint4 o = make_uint4(0u, 0u, 0u, 0u);
            if (touched) {
                const float4 a = *reinterpret_cast<const float4*>(buf + e0);
                const float4 b = *reinterpret_cast<const float4*>(buf + e0 + 4);
                const __nv_bfloat162 h0 = __floats2bfloat162_rn(a.x, a.y);
                const __nv_bfloat162 h1 = __floats2bfloat162_rn(a.z, a.w);
                const __nv_bfloat162 h2 = __floats2bfloat162_rn(b.x, b.y);
                const __nv_bfloat162 h3 = __floats2bfloat162_rn(b.z, b.w);
                o = make_uint4(*reinterpret_cast<const unsigned*>(&h0),
                               *reinterpret_cast<const unsigned*>(&h1),
                               *reinterpret_cast<const unsigned*>(&h2),
                               *reinterpret_cast<const unsigned*>(&h3));
            }
            *reinterpret_cast<uint4*>(out + e0) = o;
        } else {
            const int n = min(kBrick, Z - bz * kBrick) * C;
            for (int i = 0; i < n; ++i)
                out[e0 + i] = __float2bfloat16_rn(touched ? buf[e0 + i] : 0.0f);
        }
    }
}

// d_coords: a thread a sample, the corners in the reference's order and
// the channels in order, as the plain version sums them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_coords_kernel(const T* __restrict__ vol, const float* __restrict__ coords,
                            const float* __restrict__ ct, float* __restrict__ d_coords,
                            int X, int Y, int Z, int C, int N, int normalized, int align) {
    const int n = blockIdx.x * kThreads + threadIdx.x;
    if (n >= N) return;
    const Cell3 c = tri_cell(coords + 3 * n, X, Y, Z, normalized, align);
    const float* g = ct + (long long)n * C;
    float dx = 0.0f, dy = 0.0f, dz = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        if (!((c.mask >> k) & 1)) continue;
        const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
        const float wx = ox ? c.fx : 1.0f - c.fx;
        const float wy = oy ? c.fy : 1.0f - c.fy;
        const float wz = oz ? c.fz : 1.0f - c.fz;
        const T* v = vol + (long long)cell_voxel(c, k, Y, Z) * C;
        float s = 0.0f;
        for (int ch = 0; ch < C; ++ch) s += to_float(v[ch]) * __ldg(g + ch);
        dx += s * (ox ? 1.0f : -1.0f) * wy * wz;
        dy += s * wx * (oy ? 1.0f : -1.0f) * wz;
        dz += s * wx * wy * (oz ? 1.0f : -1.0f);
    }
    d_coords[3 * n] = dx * coord_scale(X, normalized, align);
    d_coords[3 * n + 1] = dy * coord_scale(Y, normalized, align);
    d_coords[3 * n + 2] = dz * coord_scale(Z, normalized, align);
}

// ---------------------------------------------------------------------------
// K1g / K1s / K2g / K2s: the second order of K1 and K2, the backward of
// K1b's and K2b's d_coords for its cotangent h (the d_image / d_volume
// cotangent's terms are K1 / K2 and K1b's / K2b's d_coords).
//
// Replaces: the second derivatives that XLA's autodiff takes of
// surf_tpu/ops/grid_sample.py's trilinear_sample_3d (:278, plain gathers)
// and of _bilinear_core's VJP (:102, JAX code), which
// lookup_volume(mode="grad") (:678) and the alt grids
// (surf_tpu/ops/alt_grids.py) need for an eikonal loss through a volume
// lookup (the reference's gridsample_grad2 CUDA extension).
//
// With the corner weights w_k at the unnormalized position u = s x + c,
// h'_a = s_a h_a, the directional weight dw_k = sum_a d_a w_k h'_a and
// S_k = sum_c V[i_k, c] ct[c]:
//   * K1g / K2g, a gather, one pass over a sample's 4 (8) corner rows: the
//     directional term sum_k dw_k V[i_k] (N, C), d ct, and the Hessian
//     term s_b sum_{a != b} h'_a sum_k d_a d_b w_k S_k (N, 2 or 3), d
//     coords (the unmixed d_a^2 w_k are 0);
//   * K1s / K2s, a scatter: dw_k ct into the corners, d image / d volume.
// Bound on the card: bytes, as K1 / K2 and K1b / K2b (a few FLOPs a byte
// read).  What keeps a gather from it is the latency of its corner loads
// (too few in flight when a thread walks a wide row channel by channel)
// and the instructions per (sample, channel); what keeps a scatter from it
// is its atomics.  A term whose cotangent or output is not wanted is
// skipped (a null pointer).
//
// K1g is K1's spread form: the geometry staged once in shared memory, the
// (256, C) span walked in 16-byte chunks on neighbouring lanes, the
// Hessian's channel sums reduced across a sample's lanes
// (``bilinear_bwd2_gather_kernel``).  K2g has three forms, chosen on C:
//   * spread (C a multiple of 4 with the volume rows, the cotangent and
//     the directional term aligned for 4-channel vectors; compile-time
//     C = 16, the grad lookups' width): a block of 256 threads takes
//     256 / P samples, P lanes each (C / 4 chunks rounded up to a power
//     of two, at most 32: 4 at C = 16, so 8 samples a warp).  The first
//     threads stage each sample's 8 voxel rows, 8 directional weights, h',
//     fractions and inside mask (``Tri2Stage``); a lane then issues the 8
//     loads of its 4-channel chunk of the 8 corner rows (16 bytes each,
//     8 for bf16) before any add, so a sample's 8 x 64-byte span is read
//     by 4 neighbouring lanes in 32 requests in flight at once, writes
//     its directional chunk as one 16-byte store and forms its part of
//     each S_k from the same registers; a butterfly of shuffles sums the
//     parts over the sample's lanes (neighbours in one warp) and its first
//     lane writes the Hessian row (``tri2_hess``).  Small tiles give the
//     training step's 69,632 points 1,088 blocks, about 8 an SM;
//   * a thread a sample with compile-time C = 1 (the sphere grid's bf16
//     matching volume): each axis's geometry once (``tri_axis``), the 8
//     corner loads issued before any add, and both terms from those 8
//     registers, as K2's C = 1 form reads them;
//   * a thread a sample with C at run time (any other C, or rows off
//     their alignment): a channel's 8 corner values loaded once feed both
//     terms, so each corner row is read once.
// The gathers use the plain versions' operation order (-fmad=false): the
// directional term equals the plain version bit for bit, as K1 / K2 do;
// the Hessian term sums channels in another order than PyTorch's sum in
// the plain version (equal at C = 1).
//
// K1s is ``bilinear_bwd_kernel`` with DIR: all-zero cotangent rows and
// zero weights scatter nothing, the lanes on one texel are summed into one
// (__match_any_sync and the peer tree), a row is added with 16-byte vector
// atomics.  K2s is K2b's scatter with ``dirs`` (its f32 sum and, for a
// bf16 volume, its bricked form and bf16 cast).  At C = 1 it is K2b's run
// merge (``trilinear_bwd_scatter_kernel``, one ``red.global.add.f32`` a
// merged corner).  At any other C it is the rows form
// (``trilinear_bwd_scatter_rows_kernel``, C at run time): an all-zero
// cotangent row, a corner outside and a zero weight add nothing; the lanes
// in a row in one cell sum each corner's row into the run's first lane (a
// segmented shuffle sum of as many steps as the warp's longest run needs,
// none where no two lanes share a cell), VEC channels at a time, and that
// lane adds it with one atomic a VEC channels: VEC = 4 where C is a
// multiple of 4 and the cotangent and the f32 sum are 16-byte aligned
// (at C = 16 four 16-byte atomics a (sample, corner) row in place of
// sixteen scalar ones), else VEC = 1.  One kernel serves both widths; a
// compile-time C = 16 instance that held the cotangent row in registers
// was dropped, the run-time loop reloading each 16-byte chunk from L1.
// Merging the lanes on one voxel per corner instead (__match_any_sync
// and the peer tree, as K1s does) was measured against the run on the
// H100 at C = 16: at the training step's ray-ordered points both rules
// merged the same rows (a warp's 32 consecutive samples lie on one or two
// rays, and a ray's samples in one cell are neighbouring lanes), and the
// match costs a __match_any_sync a corner where the run costs one key
// compare a sample, so the run was kept.  What is left at C = 16 is the
// wrapper's zero fill of the full f32 sum, which is the byte bound itself
// (the output), and the atomics' read-modify-writes of sectors the zero
// fill has pushed out of L2.  The
// scatters' sums, and K1g's Hessian where a sample's chunks do not divide
// a warp (shared-memory atomics), run in an order that changes from run
// to run.
// ---------------------------------------------------------------------------

// K1g's shared geometry of a block's samples (``bilinear_bwd2_gather_kernel``).
struct Bwd2Stage {
    int4 tex[kThreads];       // the four corner texels (safe)
    float4 dw[kThreads];      // the four directional weights, 0 outside
    float2 h[kThreads];       // h' = (s_x h_x, s_y h_y)
    int mask[kThreads];       // bit k: corner k inside
    float4 S[kThreads];       // the shared-memory form's S_k sums
};

// K1g's Hessian row of a sample from its S_k: M = sum_k (+-in_k) S_k in the
// reference's corner order (d_x d_y w_k = +1 at corners 0 and 3, -1 at 1
// and 2), then (M h'_y s_x, M h'_x s_y), as the plain version forms them.
__device__ __forceinline__ float2 bwd2_hess(const float (&S)[4], int mask, float2 hv,
                                            float sx, float sy) {
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float t = S[k] * (((mask >> k) & 1) ? 1.0f : 0.0f);
        const float tk = (k == 0 || k == 3) ? t : -t;
        m = k == 0 ? tk : m + tk;
    }
    return make_float2((m * hv.y) * sx, (m * hv.x) * sy);
}

// K1g, spread: a block of 256 samples.  Its threads stage each sample's
// geometry (``Bwd2Stage``), then walk the block's (256, C) span in
// VEC-channel chunks, neighbouring lanes on neighbouring chunks of one
// sample.  A chunk issues its four corner loads before any add, writes
// its directional chunk sum_k dw_k r_k (the plain version's order, from
// the first term) and, for the Hessian, forms its part of each S_k from
// the same loads and its ct chunk.  Where a sample's chunks divide 32
// they sit on neighbouring lanes of one warp, which sum their parts by a
// butterfly of shuffles; else the parts are added into shared memory.
// The sample's first chunk (or its thread, in the shared-memory form)
// then writes its Hessian row (``bwd2_hess``).
template <int CT, int VEC>
__global__ void __launch_bounds__(kThreads)
bilinear_bwd2_gather_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                            const float2* __restrict__ h, const float* __restrict__ ct,
                            float* __restrict__ dir, float2* __restrict__ hess, int H, int W,
                            int C_rt, int N, int normalized, int align) {
    __shared__ Bwd2Stage st;
    const int C = CT ? CT : C_rt;
    const int v = blockIdx.y;
    const int p0 = blockIdx.x * kThreads;
    const int n = min(kThreads, N - p0);
    const long long row0 = (long long)v * N + p0;
    const float sx = coord_scale(W, normalized, align), sy = coord_scale(H, normalized, align);
    const int chunks = C / VEC;                  // per sample
    const bool lanes = 32 % chunks == 0;         // a sample's chunks on one warp
    const int i = threadIdx.x;
    if (i < n) {
        const Taps t = bilinear_taps(coords[row0 + i], v, H, W, normalized, align);
        const float2 hv = h[row0 + i];
        const float hx = hv.x * sx, hy = hv.y * sy;
        float dw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float wx = corner_wx(t, k), wy = corner_wy(t, k);
            const float in = ((t.mask >> k) & 1) ? 1.0f : 0.0f;
            dw[k] = (((k & 1) ? wy : -wy) * hx + ((k >> 1) ? wx : -wx) * hy) * in;
        }
        const int vbase = v * H * W;
        st.tex[i] = make_int4(safe_texel(t, 0, vbase, W), safe_texel(t, 1, vbase, W),
                              safe_texel(t, 2, vbase, W), safe_texel(t, 3, vbase, W));
        st.dw[i] = make_float4(dw[0], dw[1], dw[2], dw[3]);
        st.h[i] = make_float2(hx, hy);
        st.mask[i] = t.mask;
        st.S[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    const int span = n * chunks;
    float* od = dir == nullptr ? nullptr : dir + row0 * C;
    const float* g = ct == nullptr ? nullptr : ct + row0 * C;
    // a trip count the whole block shares, for the warps' shuffles
#pragma unroll 4
    for (int base = 0; base < span; base += kThreads) {
        const int e = base + i;
        const bool on = e < span;
        const int s = on ? e / chunks : 0;
        const int c = (e - s * chunks) * VEC;
        float S[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (on) {
            const int4 tex = st.tex[s];
            float r[4][VEC];
            load_vec<VEC>(r[0], img + tex.x * C + c);
            load_vec<VEC>(r[1], img + tex.y * C + c);
            load_vec<VEC>(r[2], img + tex.z * C + c);
            load_vec<VEC>(r[3], img + tex.w * C + c);
            if (od != nullptr) {
                const float4 w = st.dw[s];
                float acc[VEC];
#pragma unroll
                for (int j = 0; j < VEC; ++j) acc[j] = r[0][j] * w.x;
#pragma unroll
                for (int j = 0; j < VEC; ++j) acc[j] = acc[j] + r[1][j] * w.y;
#pragma unroll
                for (int j = 0; j < VEC; ++j) acc[j] = acc[j] + r[2][j] * w.z;
#pragma unroll
                for (int j = 0; j < VEC; ++j) acc[j] = acc[j] + r[3][j] * w.w;
                store_vec<VEC>(od + e * VEC, acc);
            }
            if (hess != nullptr) {
                float q[VEC];
                load_vec<VEC>(q, g + e * VEC);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    S[k] = r[k][0] * q[0];
#pragma unroll
                    for (int j = 1; j < VEC; ++j) S[k] = S[k] + r[k][j] * q[j];
                }
            }
        }
        if (hess == nullptr) continue;
        if (lanes) {
            for (int d = 1; d < chunks; d <<= 1) {
#pragma unroll
                for (int k = 0; k < 4; ++k) S[k] += __shfl_xor_sync(kFull, S[k], d);
            }
            if (on && c == 0) hess[row0 + s] = bwd2_hess(S, st.mask[s], st.h[s], sx, sy);
        } else if (on) {
            atomicAdd(&st.S[s].x, S[0]);
            atomicAdd(&st.S[s].y, S[1]);
            atomicAdd(&st.S[s].z, S[2]);
            atomicAdd(&st.S[s].w, S[3]);
        }
    }
    if (hess != nullptr && !lanes) {
        __syncthreads();
        if (i < n) {
            const float4 q = st.S[i];
            const float S[4] = {q.x, q.y, q.z, q.w};
            hess[row0 + i] = bwd2_hess(S, st.mask[i], st.h[i], sx, sy);
        }
    }
}

// K2g's geometry of one sample: its 8 corners' voxels clamped to the
// volume as K2 reads them, the directional weights dw_k (0 outside), a mask
// of the corners inside (bit k = 4 ox + 2 oy + oz), the fractions and
// h' = s h, in the plain version's operation order.
struct Tri2 {
    int vox[8];
    float dw[8];
    int mask;
    float fx, fy, fz;
    float hx, hy, hz;
};

__device__ __forceinline__ Tri2 tri2_geometry(const float* co, const float* hp, int X, int Y,
                                              int Z, int normalized, int align) {
    float x = co[0], y = co[1], z = co[2];
    if (normalized) {
        x = unnormalize(x, X, align);
        y = unnormalize(y, Y, align);
        z = unnormalize(z, Z, align);
    }
    Tri2 t;
    t.hx = hp[0] * coord_scale(X, normalized, align);
    t.hy = hp[1] * coord_scale(Y, normalized, align);
    t.hz = hp[2] * coord_scale(Z, normalized, align);
    const Axis ax = tri_axis(x, X), ay = tri_axis(y, Y), az = tri_axis(z, Z);
    t.fx = ax.f;
    t.fy = ay.f;
    t.fz = az.f;
    t.mask = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
        const float wx = ox ? ax.f : ax.g, wy = oy ? ay.f : ay.g, wz = oz ? az.f : az.g;
        const float in =
            ((ox ? ax.in1 : ax.in0) * (oy ? ay.in1 : ay.in0)) * (oz ? az.in1 : az.in0);
        const float pyz = wy * wz, pxz = wx * wz, pxy = wx * wy;
        t.dw[k] = ((ox ? pyz : -pyz) * t.hx + (oy ? pxz : -pxz) * t.hy +
                   (oz ? pxy : -pxy) * t.hz) * in;
        t.mask |= (in != 0.0f) << k;
        t.vox[k] = ((ox ? ax.i1 : ax.i0) * Y + (oy ? ay.i1 : ay.i0)) * Z + (oz ? az.i1 : az.i0);
    }
    return t;
}

// K2g's Hessian row of a sample from its channel sums S_k: M_xy, M_xz and
// M_yz over the corners in the reference's order (the mixed second
// derivatives of w_k are +-wz, +-wy, +-wx), then the three coordinates,
// as the plain version forms them.
__device__ __forceinline__ void tri2_hess(const float (&S)[8], int mask, float fx, float fy,
                                          float fz, float hx, float hy, float hz, float sx,
                                          float sy, float sz, float* o) {
    float mxy = 0.0f, mxz = 0.0f, myz = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
        const float wx = ox ? fx : 1.0f - fx, wy = oy ? fy : 1.0f - fy,
                    wz = oz ? fz : 1.0f - fz;
        const float sk = S[k] * (((mask >> k) & 1) ? 1.0f : 0.0f);
        const float txy = sk * ((ox == oy) ? wz : -wz);
        const float txz = sk * ((ox == oz) ? wy : -wy);
        const float tyz = sk * ((oy == oz) ? wx : -wx);
        mxy = k == 0 ? txy : mxy + txy;
        mxz = k == 0 ? txz : mxz + txz;
        myz = k == 0 ? tyz : myz + tyz;
    }
    o[0] = (mxy * hy + mxz * hz) * sx;
    o[1] = (mxy * hx + myz * hz) * sy;
    o[2] = (mxz * hx + myz * hy) * sz;
}

// K2g, rows: one thread a sample; CT = 1 (the sphere grid's C) or 0 (C at
// run time).  A channel's 8 corner values are loaded before any is added
// and feed both terms, so each corner row is read once.
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
trilinear_bwd2_gather_kernel(const T* __restrict__ vol, const float* __restrict__ coords,
                             const float* __restrict__ h, const float* __restrict__ ct,
                             float* __restrict__ dir, float* __restrict__ hess, int X, int Y,
                             int Z, int C_rt, int N, int normalized, int align) {
    const int C = CT ? CT : C_rt;
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= N) return;
    const Tri2 t = tri2_geometry(coords + 3 * (long long)p, h + 3 * (long long)p, X, Y, Z,
                                 normalized, align);
    float* od = dir == nullptr ? nullptr : dir + (long long)p * C;
    const float* g = ct + (long long)p * C;
    float S[8];
    for (int c = 0; c < C; ++c) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = to_float(vol[t.vox[k] * C + c]);
        if (od != nullptr) {
            float acc = v[0] * t.dw[0];
#pragma unroll
            for (int k = 1; k < 8; ++k) acc = acc + v[k] * t.dw[k];
            od[c] = acc;
        }
        if (hess != nullptr) {
            const float gc = __ldg(g + c);
#pragma unroll
            for (int k = 0; k < 8; ++k) S[k] = c == 0 ? v[k] * gc : S[k] + v[k] * gc;
        }
    }
    if (hess != nullptr)
        tri2_hess(S, t.mask, t.fx, t.fy, t.fz, t.hx, t.hy, t.hz,
                  coord_scale(X, normalized, align), coord_scale(Y, normalized, align),
                  coord_scale(Z, normalized, align), hess + 3 * (long long)p);
}

// Four channels from p: one 16-byte load (f32) or 8-byte load (bf16),
// the caller guaranteeing the alignment.
__device__ __forceinline__ void load4(float (&r)[4], const float* p) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
}
__device__ __forceinline__ void load4(float (&r)[4], const __nv_bfloat16* p) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = __uint_as_float(q.x << 16); r[1] = __uint_as_float(q.x & 0xffff0000u);
    r[2] = __uint_as_float(q.y << 16); r[3] = __uint_as_float(q.y & 0xffff0000u);
}

// K2g's shared geometry of a block's samples (``trilinear_bwd2_spread_kernel``).
struct Tri2Stage {
    int4 vox[2][kThreads];    // the 8 corner voxels (clamped)
    float4 dw[2][kThreads];   // the 8 directional weights, 0 outside
    float4 h[kThreads];       // h' and the inside mask's bits
    float4 f[kThreads];       // the fractions
};

// The lanes of a sample in K2g's spread form: C / 4 chunks rounded up to a
// power of two, at most 32 (a lane then takes every 32nd chunk).
__host__ __device__ constexpr int spread_lanes(int chunks) {
    return chunks > 16 ? 32 : chunks > 8 ? 16 : chunks > 4 ? 8 : chunks > 2 ? 4
         : chunks > 1 ? 2 : 1;
}

// K2g, spread (C a multiple of 4, the rows aligned): a block of 256
// threads takes 256 / P samples, P lanes each (P = 4 at C = 16).  The
// first threads stage each sample's geometry (``Tri2Stage``); then a
// lane walks its sample's chunks of 4 channels (one at C = 16), issues
// the 8 corner loads of a chunk before any add, writes its directional
// chunk as one 16-byte store (the plain version's order, from the first
// term) and forms its part of each S_k from the same loads and its ct
// chunk.  The sample's lanes are neighbours in one warp: a butterfly of
// shuffles sums their parts, and the first lane writes the Hessian row.
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
trilinear_bwd2_spread_kernel(const T* __restrict__ vol, const float* __restrict__ coords,
                             const float* __restrict__ h, const float* __restrict__ ct,
                             float* __restrict__ dir, float* __restrict__ hess, int X, int Y,
                             int Z, int C_rt, int N, int normalized, int align) {
    __shared__ Tri2Stage st;
    const int C = CT ? CT : C_rt;
    const int chunks = C / 4;
    constexpr int PCT = CT ? spread_lanes(CT / 4) : 0;
    const int P = PCT ? PCT : spread_lanes(chunks);
    const int tile = kThreads / P;
    const int p0 = blockIdx.x * tile;
    const int n = min(tile, N - p0);
    const int i = threadIdx.x;
    if (i < n) {
        const long long p = p0 + i;
        const Tri2 t = tri2_geometry(coords + 3 * p, h + 3 * p, X, Y, Z, normalized, align);
        st.vox[0][i] = make_int4(t.vox[0], t.vox[1], t.vox[2], t.vox[3]);
        st.vox[1][i] = make_int4(t.vox[4], t.vox[5], t.vox[6], t.vox[7]);
        st.dw[0][i] = make_float4(t.dw[0], t.dw[1], t.dw[2], t.dw[3]);
        st.dw[1][i] = make_float4(t.dw[4], t.dw[5], t.dw[6], t.dw[7]);
        st.h[i] = make_float4(t.hx, t.hy, t.hz, __int_as_float(t.mask));
        st.f[i] = make_float4(t.fx, t.fy, t.fz, 0.0f);
    }
    __syncthreads();
    const int s = i / P, j = i - s * P;           // the sample, its lane
    const bool on = s < n;
    float S[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) S[k] = 0.0f;
    if (on) {
        const int4 va = st.vox[0][s], vb = st.vox[1][s];
        const int vox[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
        const float4 wa = st.dw[0][s], wb = st.dw[1][s];
        const float dw[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const long long row = (long long)(p0 + s) * C;
        for (int c4 = j; c4 < chunks; c4 += P) {
            const int c = c4 * 4;
            float r[8][4];
#pragma unroll
            for (int k = 0; k < 8; ++k) load4(r[k], vol + vox[k] * C + c);
            if (dir != nullptr) {
                float acc[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[q] = r[0][q] * dw[0];
#pragma unroll
                for (int k = 1; k < 8; ++k) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[q] = acc[q] + r[k][q] * dw[k];
                }
                *reinterpret_cast<float4*>(dir + row + c) =
                    make_float4(acc[0], acc[1], acc[2], acc[3]);
            }
            if (hess != nullptr) {
                float g[4];
                load4(g, ct + row + c);
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    S[k] = S[k] + (((r[k][0] * g[0] + r[k][1] * g[1]) + r[k][2] * g[2]) +
                                   r[k][3] * g[3]);
            }
        }
    }
    if (hess == nullptr) return;
    for (int d = 1; d < P; d <<= 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) S[k] += __shfl_xor_sync(kFull, S[k], d);
    }
    if (on && j == 0) {
        const float4 hv = st.h[s], fv = st.f[s];
        tri2_hess(S, __float_as_int(hv.w), fv.x, fv.y, fv.z, hv.x, hv.y, hv.z,
                  coord_scale(X, normalized, align), coord_scale(Y, normalized, align),
                  coord_scale(Z, normalized, align), hess + 3 * (long long)(p0 + s));
    }
}

inline unsigned blocks_for(long long total) {
    return (unsigned)((total + kThreads - 1) / kThreads);
}

inline bool aligned(const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// K1 / K1b's size and alignment rule: the image below 2^31 elements (32-bit
// texel offsets), N points a view within int range, coordinates (and
// d_coords) 8-byte aligned for their float2 loads and stores.
inline int bilinear_args_ok(int V, int H, int W, int C, long long N, const void* coords) {
    if ((long long)V * H * W * C >= (long long)INT_MAX || V > 65535 ||
        N > (long long)INT_MAX - kThreads)
        return (int)cudaErrorInvalidValue;
    if (!aligned(coords, 8)) return (int)cudaErrorMisalignedAddress;
    return 0;
}

// K1b's kernel for its C (DIR: K1s, whose img and d_coords are null).
template <bool DIR>
void bilinear_bwd_launch(const float* img, const float2* co, const float2* h, const float* ct,
                         float* d_img, float2* dco, int V, int H, int W, int C, int n,
                         int normalized, int align, cudaStream_t s) {
    const dim3 grid(blocks_for(n), V);
    // 16-byte rows: the image, the cotangent and the gradient image aligned
    const bool vec = C % 4 == 0 && aligned(img, 16) && aligned(ct, 16) &&
                     (d_img == nullptr || aligned(d_img, 16));
    if constexpr (DIR) {
        if (C == 16 && vec) {
            bilinear_bwd_kernel<16, 4, true><<<grid, kThreads, 0, s>>>(
                img, co, h, ct, d_img, dco, H, W, C, n, normalized, align);
            return;
        }
    }
    if (C == 1) {
        bilinear_bwd_kernel<1, 1, DIR><<<grid, kThreads, 0, s>>>(img, co, h, ct, d_img, dco,
                                                                 H, W, C, n, normalized, align);
    } else if (C == 3) {
        bilinear_bwd_kernel<3, 1, DIR><<<grid, kThreads, 0, s>>>(img, co, h, ct, d_img, dco,
                                                                 H, W, C, n, normalized, align);
    } else if (C == 4 && vec) {
        bilinear_bwd_kernel<4, 4, DIR><<<grid, kThreads, 0, s>>>(img, co, h, ct, d_img, dco,
                                                                 H, W, C, n, normalized, align);
    } else if (vec) {
        bilinear_bwd_kernel<0, 4, DIR><<<grid, kThreads, 0, s>>>(img, co, h, ct, d_img, dco,
                                                                 H, W, C, n, normalized, align);
    } else {
        bilinear_bwd_kernel<0, 1, DIR><<<grid, kThreads, 0, s>>>(img, co, h, ct, d_img, dco,
                                                                 H, W, C, n, normalized, align);
    }
}

// K2g's form for its C: spread where C is a multiple of 4 and the volume
// rows, the cotangent and the directional term are aligned for 4-channel
// vectors (compile-time C = 16, else C at run time), else a thread a
// sample (compile-time C = 1, else C at run time).
template <typename T>
void tri_bwd2_gather_launch(const T* vol, const float* coords, const float* h, const float* ct,
                            float* dir, float* hess, int X, int Y, int Z, int C, int n,
                            int normalized, int align, cudaStream_t s) {
    const bool vec = C % 4 == 0 && aligned(vol, 4 * sizeof(T)) &&
                     (ct == nullptr || aligned(ct, 16)) && (dir == nullptr || aligned(dir, 16));
    if (vec) {
        const int tile = kThreads / spread_lanes(C / 4);
        const unsigned grid = (unsigned)((n + tile - 1) / tile);
        if (C == 16)
            trilinear_bwd2_spread_kernel<T, 16><<<grid, kThreads, 0, s>>>(
                vol, coords, h, ct, dir, hess, X, Y, Z, C, n, normalized, align);
        else
            trilinear_bwd2_spread_kernel<T, 0><<<grid, kThreads, 0, s>>>(
                vol, coords, h, ct, dir, hess, X, Y, Z, C, n, normalized, align);
    } else if (C == 1) {
        trilinear_bwd2_gather_kernel<T, 1><<<blocks_for(n), kThreads, 0, s>>>(
            vol, coords, h, ct, dir, hess, X, Y, Z, C, n, normalized, align);
    } else {
        trilinear_bwd2_gather_kernel<T, 0><<<blocks_for(n), kThreads, 0, s>>>(
            vol, coords, h, ct, dir, hess, X, Y, Z, C, n, normalized, align);
    }
}

// K2b's and K2s's size rule: the volume below 2^31 elements, each side
// below 2^21 - 1 (``cell_key``'s fields), the bricked form with both
// gradient buffers.
inline int tri_bwd_args_ok(int X, int Y, int Z, int C, long long N, const float* d_vol,
                           const void* d_vol_out, const int* bricks) {
    constexpr int kSide = (1 << 21) - 1;
    if (N < 0 || C <= 0 || X <= 0 || Y <= 0 || Z <= 0 || X >= kSide || Y >= kSide ||
        Z >= kSide || (long long)X * Y * Z * C >= (long long)INT_MAX ||
        N > (long long)INT_MAX - kBwdTile ||
        (bricks != nullptr && (d_vol == nullptr || d_vol_out == nullptr)))
        return (int)cudaErrorInvalidValue;
    return 0;
}

// The d_volume passes of K2b (dirs null) and K2s: the bricked form's mark
// and zero passes, the scatter into the f32 sum d_vol, and the cast into
// d_vol_out (bf16) where given.
inline void tri_scatter(const float* coords, const float* ct, const float* dirs, float* d_vol,
                        int X, int Y, int Z, int C, int n, int normalized, int align,
                        void* d_vol_out, int* bricks, unsigned long long* counts,
                        cudaStream_t s) {
    if (bricks != nullptr && n > 0) {
        const int n_bricks = ((X + kBrick - 1) / kBrick) * ((Y + kBrick - 1) / kBrick) *
                             ((Z + kBrick - 1) / kBrick);
        trilinear_bwd_mark_kernel<<<blocks_for(n), kThreads, 0, s>>>(
            coords, ct, bricks, X, Y, Z, C, n, normalized, align);
        trilinear_bwd_zero_kernel<<<blocks_for(n_bricks), kThreads, 0, s>>>(
            bricks, d_vol, X, Y, Z, C, n_bricks);
    }
    if (n > 0) {
        // warps for every chunk of every stream (``spread_chunk``)
        const int chunks = (n + 32 * kBwdRun - 1) / (32 * kBwdRun);
        const int warps = kSpread * ((chunks + kSpread - 1) / kSpread);
        const unsigned grid = (unsigned)((warps + kBwdWarps - 1) / kBwdWarps);
        if (C == 1)
            trilinear_bwd_scatter_kernel<<<grid, kThreads, 0, s>>>(
                coords, ct, dirs, d_vol, X, Y, Z, n, normalized, align, counts);
        else if (C % 4 == 0 && aligned(ct, 16) && aligned(d_vol, 16))
            trilinear_bwd_scatter_rows_kernel<4><<<grid, kThreads, 0, s>>>(
                coords, ct, dirs, d_vol, X, Y, Z, C, n, normalized, align, counts);
        else
            trilinear_bwd_scatter_rows_kernel<1><<<grid, kThreads, 0, s>>>(
                coords, ct, dirs, d_vol, X, Y, Z, C, n, normalized, align, counts);
    }
    if (d_vol_out != nullptr) {
        const int fast = C == 1 && Z % kBrick == 0 && aligned(d_vol, 16) &&
                         aligned(d_vol_out, 16);
        trilinear_bwd_finish_kernel<<<blocks_for((long long)X * Y * 32), kThreads, 0, s>>>(
            d_vol, bricks, (__nv_bfloat16*)d_vol_out, X, Y, Z, C, fast);
    }
}

}  // namespace

extern "C" {

// img (V, H, W, C) f32, coords (V, N, 2) f32, out (V, N, C) f32
int bilinear_sample_2d(const float* img, const float* coords, float* out,
                       int V, int H, int W, int C, long long N,
                       int normalized, int align, void* stream) {
    if (V <= 0 || N <= 0 || C <= 0) return 0;
    const int bad = bilinear_args_ok(V, H, W, C, N, coords);
    if (bad) return bad;
    const dim3 grid(blocks_for(N), V);
    cudaStream_t s = (cudaStream_t)stream;
    const float2* co = reinterpret_cast<const float2*>(coords);
    const int n = (int)N;
    const bool vec = aligned(img, 16) && aligned(out, 16);
    if (C == 1) {
        bilinear_rows_kernel<1><<<grid, kThreads, 0, s>>>(img, co, out, H, W, n,
                                                          normalized, align);
    } else if (C == 3) {
        bilinear_rows_kernel<3><<<grid, kThreads, 0, s>>>(img, co, out, H, W, n,
                                                          normalized, align);
    } else if (C == 4 && vec) {
        bilinear_rows_kernel<4><<<grid, kThreads, 0, s>>>(img, co, out, H, W, n,
                                                          normalized, align);
    } else if (C == 19) {
        bilinear_spread_kernel<19, 1><<<grid, kThreads, 0, s>>>(img, co, out, H, W, C, n,
                                                                normalized, align);
    } else if (C % 4 == 0 && vec) {
        bilinear_spread_kernel<0, 4><<<grid, kThreads, 0, s>>>(img, co, out, H, W, C, n,
                                                               normalized, align);
    } else {
        bilinear_spread_kernel<0, 1><<<grid, kThreads, 0, s>>>(img, co, out, H, W, C, n,
                                                               normalized, align);
    }
    return (int)cudaGetLastError();
}

// vol (X, Y, Z, C) f32 or bf16, coords (N, 3) f32, out (N, C) f32.  The
// volume below 2^31 elements (32-bit voxel offsets).
int trilinear_sample_3d(const void* vol, int is_bf16, const float* coords,
                        float* out, int X, int Y, int Z, int C, long long N,
                        int normalized, int align, void* stream) {
    if (N <= 0 || C <= 0) return 0;
    const long long voxels = (long long)X * Y * Z;
    if (X <= 0 || Y <= 0 || Z <= 0 || voxels * C >= (long long)INT_MAX ||
        N > (long long)INT_MAX - kThreads)
        return (int)cudaErrorInvalidValue;
    const unsigned grid = blocks_for(N);
    cudaStream_t s = (cudaStream_t)stream;
    const int n = (int)N;
    if (is_bf16) {
        const __nv_bfloat16* v = (const __nv_bfloat16*)vol;
        if (C == 1)
            trilinear_kernel<__nv_bfloat16, 1><<<grid, kThreads, 0, s>>>(
                v, coords, out, X, Y, Z, C, n, normalized, align);
        else
            trilinear_kernel<__nv_bfloat16, 0><<<grid, kThreads, 0, s>>>(
                v, coords, out, X, Y, Z, C, n, normalized, align);
    } else {
        const float* v = (const float*)vol;
        if (C == 1)
            trilinear_kernel<float, 1><<<grid, kThreads, 0, s>>>(
                v, coords, out, X, Y, Z, C, n, normalized, align);
        else
            trilinear_kernel<float, 0><<<grid, kThreads, 0, s>>>(
                v, coords, out, X, Y, Z, C, n, normalized, align);
    }
    return (int)cudaGetLastError();
}

// K1b.  img (V, H, W, C) f32, coords (V, N, 2) f32, ct (V, N, C) f32;
// d_img (V, H, W, C) f32 zero-filled by the caller, or NULL; d_coords
// (V, N, 2) f32, or NULL.
int bilinear_sample_2d_bwd(const float* img, const float* coords,
                           const float* ct, float* d_img, float* d_coords,
                           int V, int H, int W, int C, long long N,
                           int normalized, int align, void* stream) {
    if (V <= 0 || N <= 0 || C <= 0) return 0;
    int bad = bilinear_args_ok(V, H, W, C, N, coords);
    if (!bad && d_coords != nullptr && !aligned(d_coords, 8))
        bad = (int)cudaErrorMisalignedAddress;
    if (bad) return bad;
    bilinear_bwd_launch<false>(img, reinterpret_cast<const float2*>(coords), nullptr, ct,
                               d_img, reinterpret_cast<float2*>(d_coords), V, H, W, C, (int)N,
                               normalized, align, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// K2b.  vol (X, Y, Z, C) f32 or bf16, coords (N, 3) f32, ct (N, C) f32;
// d_vol (X, Y, Z, C) f32 zero-filled by the caller, or NULL; d_coords
// (N, 3) f32, or NULL.  Extended (the old arguments keep their order):
// d_vol_out (X, Y, Z, C) bf16, or NULL: receives d_vol's cast; bricks, or
// NULL: the bricked form's map of ceil(X/8) ceil(Y/8) ceil(Z/8) int32
// zero-filled by the caller, d_vol then uninitialised (its untouched
// bricks are never read) and d_vol_out required; counts (2,) uint64 or
// NULL: adds the (corner, channel) scatters of nonzero cotangents and the
// global atomics issued.  The volume below 2^31 elements, each side below
// 2^21 - 1.
int trilinear_sample_3d_bwd(const void* vol, int is_bf16, const float* coords,
                            const float* ct, float* d_vol, float* d_coords,
                            int X, int Y, int Z, int C, long long N,
                            int normalized, int align, void* stream,
                            void* d_vol_out, int* bricks, unsigned long long* counts) {
    const int bad = tri_bwd_args_ok(X, Y, Z, C, N, d_vol, d_vol_out, bricks);
    if (bad) return bad;
    cudaStream_t s = (cudaStream_t)stream;
    const int n = (int)N;
    if (d_vol != nullptr)
        tri_scatter(coords, ct, nullptr, d_vol, X, Y, Z, C, n, normalized, align, d_vol_out,
                    bricks, counts, s);
    if (d_coords != nullptr && n > 0) {
        if (is_bf16)
            trilinear_bwd_coords_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
                (const __nv_bfloat16*)vol, coords, ct, d_coords, X, Y, Z, C, n, normalized,
                align);
        else
            trilinear_bwd_coords_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
                (const float*)vol, coords, ct, d_coords, X, Y, Z, C, n, normalized, align);
    }
    return (int)cudaGetLastError();
}

// K1g.  img (V, H, W, C) f32, coords and h (V, N, 2) f32, ct (V, N, C) f32
// (read for hess only, else NULL); dir (V, N, C) f32 or NULL; hess (V, N, 2)
// f32 or NULL.  coords, h and hess 8-byte aligned.
int bilinear_sample_2d_bwd2_gather(const float* img, const float* coords, const float* h,
                                   const float* ct, float* dir, float* hess, int V, int H,
                                   int W, int C, long long N, int normalized, int align,
                                   void* stream) {
    if (V <= 0 || N <= 0 || C <= 0 || (dir == nullptr && hess == nullptr)) return 0;
    if (hess != nullptr && ct == nullptr) return (int)cudaErrorInvalidValue;
    int bad = bilinear_args_ok(V, H, W, C, N, coords);
    if (!bad && (!aligned(h, 8) || (hess != nullptr && !aligned(hess, 8))))
        bad = (int)cudaErrorMisalignedAddress;
    if (bad) return bad;
    const dim3 grid(blocks_for(N), V);
    cudaStream_t s = (cudaStream_t)stream;
    const float2* co = reinterpret_cast<const float2*>(coords);
    const float2* hv = reinterpret_cast<const float2*>(h);
    float2* he = reinterpret_cast<float2*>(hess);
    const int n = (int)N;
    // 16-byte rows: the image, the cotangent and the directional term aligned
    const bool vec = C % 4 == 0 && aligned(img, 16) && (ct == nullptr || aligned(ct, 16)) &&
                     (dir == nullptr || aligned(dir, 16));
    if (C == 1)
        bilinear_bwd2_gather_kernel<1, 1><<<grid, kThreads, 0, s>>>(img, co, hv, ct, dir, he,
                                                                    H, W, C, n, normalized,
                                                                    align);
    else if (C == 3)
        bilinear_bwd2_gather_kernel<3, 3><<<grid, kThreads, 0, s>>>(img, co, hv, ct, dir, he,
                                                                    H, W, C, n, normalized,
                                                                    align);
    else if (C == 4 && vec)
        bilinear_bwd2_gather_kernel<4, 4><<<grid, kThreads, 0, s>>>(img, co, hv, ct, dir, he,
                                                                    H, W, C, n, normalized,
                                                                    align);
    else if (C == 16 && vec)
        bilinear_bwd2_gather_kernel<16, 4><<<grid, kThreads, 0, s>>>(img, co, hv, ct, dir, he,
                                                                     H, W, C, n, normalized,
                                                                     align);
    else if (vec)
        bilinear_bwd2_gather_kernel<0, 4><<<grid, kThreads, 0, s>>>(img, co, hv, ct, dir, he,
                                                                    H, W, C, n, normalized,
                                                                    align);
    else
        bilinear_bwd2_gather_kernel<0, 1><<<grid, kThreads, 0, s>>>(img, co, hv, ct, dir, he,
                                                                    H, W, C, n, normalized,
                                                                    align);
    return (int)cudaGetLastError();
}

// K1s, K1b's scatter with the directional weights.  coords and h (V, N, 2)
// f32, 8-byte aligned; ct (V, N, C) f32; d_img (V, H, W, C) f32 zero-filled
// by the caller.
int bilinear_sample_2d_bwd2_scatter(const float* coords, const float* h, const float* ct,
                                    float* d_img, int V, int H, int W, int C, long long N,
                                    int normalized, int align, void* stream) {
    if (V <= 0 || N <= 0 || C <= 0) return 0;
    int bad = bilinear_args_ok(V, H, W, C, N, coords);
    if (!bad && !aligned(h, 8)) bad = (int)cudaErrorMisalignedAddress;
    if (bad) return bad;
    bilinear_bwd_launch<true>(nullptr, reinterpret_cast<const float2*>(coords),
                              reinterpret_cast<const float2*>(h), ct, d_img, nullptr, V, H, W,
                              C, (int)N, normalized, align, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// K2g.  vol (X, Y, Z, C) f32 or bf16, coords and h (N, 3) f32, ct (N, C)
// f32 (read for hess only, else NULL); dir (N, C) f32 or NULL; hess (N, 3)
// f32 or NULL.  The volume below 2^31 elements.
int trilinear_sample_3d_bwd2_gather(const void* vol, int is_bf16, const float* coords,
                                    const float* h, const float* ct, float* dir, float* hess,
                                    int X, int Y, int Z, int C, long long N, int normalized,
                                    int align, void* stream) {
    if (N <= 0 || C <= 0 || (dir == nullptr && hess == nullptr)) return 0;
    if (X <= 0 || Y <= 0 || Z <= 0 || (long long)X * Y * Z * C >= (long long)INT_MAX ||
        N > (long long)INT_MAX - kThreads || (hess != nullptr && ct == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16)
        tri_bwd2_gather_launch((const __nv_bfloat16*)vol, coords, h, ct, dir, hess, X, Y, Z, C,
                               (int)N, normalized, align, s);
    else
        tri_bwd2_gather_launch((const float*)vol, coords, h, ct, dir, hess, X, Y, Z, C, (int)N,
                               normalized, align, s);
    return (int)cudaGetLastError();
}

// K2s.  coords and h (N, 3) f32, ct (N, C) f32; d_vol, d_vol_out, bricks
// and counts as K2b's (d_vol required).
int trilinear_sample_3d_bwd2_scatter(const float* coords, const float* h, const float* ct,
                                     float* d_vol, int X, int Y, int Z, int C, long long N,
                                     int normalized, int align, void* stream, void* d_vol_out,
                                     int* bricks, unsigned long long* counts) {
    int bad = tri_bwd_args_ok(X, Y, Z, C, N, d_vol, d_vol_out, bricks);
    if (!bad && d_vol == nullptr) bad = (int)cudaErrorInvalidValue;
    if (bad) return bad;
    tri_scatter(coords, ct, h, d_vol, X, Y, Z, C, (int)N, normalized, align, d_vol_out, bricks,
                counts, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

}  // extern "C"
