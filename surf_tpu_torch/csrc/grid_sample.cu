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
// K2 design (correct first): one thread per (sample, channel), channel
// fastest, so the threads of a warp read neighbouring channels of the same
// corner rows and write one contiguous output row.  Coordinates are
// unnormalized in the kernel with the same operation order as the plain
// PyTorch version (built with -fmad=false, so the floors agree).  The
// corner sum runs in the reference's corner order.  No shared memory.

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

template <typename T>
__device__ __forceinline__ float load(const T* p, long long i);
template <>
__device__ __forceinline__ float load<float>(const float* p, long long i) {
    return p[i];
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     long long i) {
    return __bfloat162float(p[i]);
}

template <typename T>
__global__ void trilinear_kernel(const T* __restrict__ vol,
                                 const float* __restrict__ coords,
                                 float* __restrict__ out,
                                 int X, int Y, int Z, int C, long long total,
                                 int normalized, int align) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int c = (int)(i % C);
    const long long n = i / C;
    float x = coords[3 * n], y = coords[3 * n + 1], z = coords[3 * n + 2];
    if (normalized) {
        x = unnormalize(x, X, align);
        y = unnormalize(y, Y, align);
        z = unnormalize(z, Z, align);
    }
    const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
    const float fx = x - x0f, fy = y - y0f, fz = z - z0f;
    const long long x0 = (long long)x0f, y0 = (long long)y0f, z0 = (long long)z0f;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
        const long long cx = x0 + ox, cy = y0 + oy, cz = z0 + oz;
        const bool valid = cx >= 0 && cx < X && cy >= 0 && cy < Y &&
                           cz >= 0 && cz < Z;
        const float w = (ox ? fx : 1.0f - fx) * (oy ? fy : 1.0f - fy) *
                        (oz ? fz : 1.0f - fz);
        if (valid) acc += load(vol, ((cx * Y + cy) * Z + cz) * C + c) * w;
    }
    out[i] = acc;
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
// K2b design (correct first): one thread per sample; it loops over the
// corners in the reference's order and over the channels, adds ct * w
// into the gradient volume with f32 atomicAdd (the order of the sums
// changes from run to run) and accumulates the coordinate gradient by the
// product rule through the fractional weights (corner indices carry no
// gradient).  K2b always accumulates into an f32 buffer; the wrapper casts
// it to a bf16 volume's dtype.  Either gradient may be skipped (null).
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

// CT in {1, 3, 4}: the whole row in registers (16-byte vectors at 4).
// CT = 0: C at run time, in chunks of VEC channels (4: 16-byte vectors,
// C a multiple of 4 and the rows aligned; else 1).
template <int CT, int VEC>
__global__ void __launch_bounds__(kThreads)
bilinear_bwd_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                    const float* __restrict__ ct, float* __restrict__ d_img,
                    float2* __restrict__ d_coords, int H, int W, int C_rt, int N,
                    int normalized, int align) {
    constexpr int K = CT ? CT : VEC;             // channels a chunk
    const int C = CT ? CT : C_rt;
    const int p = blockIdx.x * kThreads + threadIdx.x;
    const int v = blockIdx.y;
    const int lane = threadIdx.x & 31;
    // lanes past the end stay for the warp's collectives and scatter nothing
    const bool live = p < N;
    const long long vn = (long long)v * N + (live ? p : N - 1);
    const Taps t = bilinear_taps(coords[vn], v, H, W, normalized, align);
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
            const bool on = (scatter >> k) & 1;
            const int texel = on ? corner_texel(t, k, W) : -1;
            const unsigned peers = __match_any_sync(kFull, texel);
            const bool leader = (peers & ((1u << lane) - 1u)) == 0u;
            const PeerTree tree = peer_tree(peers, lane);
            const float w = corner_wx(t, k) * corner_wy(t, k);
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

    if (d_coords != nullptr && live) {
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
        float sx = 1.0f, sy = 1.0f;
        if (normalized) {
            sx = align ? 0.5f * (float)(W - 1) : 0.5f * (float)W;
            sy = align ? 0.5f * (float)(H - 1) : 0.5f * (float)H;
        }
        d_coords[vn] = make_float2(dx * sx, dy * sy);
    }
}

template <typename T>
__global__ void trilinear_bwd_kernel(const T* __restrict__ vol,
                                     const float* __restrict__ coords,
                                     const float* __restrict__ ct,
                                     float* __restrict__ d_vol,
                                     float* __restrict__ d_coords,
                                     int X, int Y, int Z, int C, long long N,
                                     int normalized, int align) {
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    float x = coords[3 * n], y = coords[3 * n + 1], z = coords[3 * n + 2];
    float sx = 1.0f, sy = 1.0f, sz = 1.0f;
    if (normalized) {
        x = unnormalize(x, X, align);
        y = unnormalize(y, Y, align);
        z = unnormalize(z, Z, align);
        sx = align ? 0.5f * (float)(X - 1) : 0.5f * (float)X;
        sy = align ? 0.5f * (float)(Y - 1) : 0.5f * (float)Y;
        sz = align ? 0.5f * (float)(Z - 1) : 0.5f * (float)Z;
    }
    const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
    const float fx = x - x0f, fy = y - y0f, fz = z - z0f;
    const long long x0 = (long long)x0f, y0 = (long long)y0f, z0 = (long long)z0f;
    const float* g = ct + n * C;
    float dx = 0.0f, dy = 0.0f, dz = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
        const long long cx = x0 + ox, cy = y0 + oy, cz = z0 + oz;
        if (!(cx >= 0 && cx < X && cy >= 0 && cy < Y && cz >= 0 && cz < Z)) continue;
        const float wx = ox ? fx : 1.0f - fx;
        const float wy = oy ? fy : 1.0f - fy;
        const float wz = oz ? fz : 1.0f - fz;
        const float w = wx * wy * wz;
        const long long off = ((cx * Y + cy) * Z + cz) * C;
        float s = 0.0f;
        for (int c = 0; c < C; ++c) {
            const float gc = g[c];
            if (d_vol != nullptr) atomicAdd(d_vol + off + c, gc * w);
            if (d_coords != nullptr) s += load(vol, off + c) * gc;
        }
        dx += s * (ox ? 1.0f : -1.0f) * wy * wz;
        dy += s * wx * (oy ? 1.0f : -1.0f) * wz;
        dz += s * wx * wy * (oz ? 1.0f : -1.0f);
    }
    if (d_coords != nullptr) {
        d_coords[3 * n] = dx * sx;
        d_coords[3 * n + 1] = dy * sy;
        d_coords[3 * n + 2] = dz * sz;
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

// vol (X, Y, Z, C) f32 or bf16, coords (N, 3) f32, out (N, C) f32
int trilinear_sample_3d(const void* vol, int is_bf16, const float* coords,
                        float* out, int X, int Y, int Z, int C, long long N,
                        int normalized, int align, void* stream) {
    const long long total = N * C;
    if (total > 0) {
        if (is_bf16) {
            trilinear_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0,
                                              (cudaStream_t)stream>>>(
                (const __nv_bfloat16*)vol, coords, out, X, Y, Z, C, total,
                normalized, align);
        } else {
            trilinear_kernel<float><<<blocks_for(total), kThreads, 0,
                                      (cudaStream_t)stream>>>(
                (const float*)vol, coords, out, X, Y, Z, C, total,
                normalized, align);
        }
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
    const dim3 grid(blocks_for(N), V);
    cudaStream_t s = (cudaStream_t)stream;
    const float2* co = reinterpret_cast<const float2*>(coords);
    float2* dco = reinterpret_cast<float2*>(d_coords);
    const int n = (int)N;
    // 16-byte rows: the image, the cotangent and the gradient image aligned
    const bool vec = C % 4 == 0 && aligned(img, 16) && aligned(ct, 16) &&
                     (d_img == nullptr || aligned(d_img, 16));
    if (C == 1) {
        bilinear_bwd_kernel<1, 1><<<grid, kThreads, 0, s>>>(img, co, ct, d_img, dco, H, W,
                                                            C, n, normalized, align);
    } else if (C == 3) {
        bilinear_bwd_kernel<3, 1><<<grid, kThreads, 0, s>>>(img, co, ct, d_img, dco, H, W,
                                                            C, n, normalized, align);
    } else if (C == 4 && vec) {
        bilinear_bwd_kernel<4, 4><<<grid, kThreads, 0, s>>>(img, co, ct, d_img, dco, H, W,
                                                            C, n, normalized, align);
    } else if (vec) {
        bilinear_bwd_kernel<0, 4><<<grid, kThreads, 0, s>>>(img, co, ct, d_img, dco, H, W,
                                                            C, n, normalized, align);
    } else {
        bilinear_bwd_kernel<0, 1><<<grid, kThreads, 0, s>>>(img, co, ct, d_img, dco, H, W,
                                                            C, n, normalized, align);
    }
    return (int)cudaGetLastError();
}

// K2b.  vol (X, Y, Z, C) f32 or bf16, coords (N, 3) f32, ct (N, C) f32;
// d_vol (X, Y, Z, C) f32 zero-filled by the caller, or NULL; d_coords
// (N, 3) f32, or NULL.
int trilinear_sample_3d_bwd(const void* vol, int is_bf16, const float* coords,
                            const float* ct, float* d_vol, float* d_coords,
                            int X, int Y, int Z, int C, long long N,
                            int normalized, int align, void* stream) {
    if (N > 0) {
        if (is_bf16) {
            trilinear_bwd_kernel<__nv_bfloat16><<<blocks_for(N), kThreads, 0,
                                                  (cudaStream_t)stream>>>(
                (const __nv_bfloat16*)vol, coords, ct, d_vol, d_coords, X, Y,
                Z, C, N, normalized, align);
        } else {
            trilinear_bwd_kernel<float><<<blocks_for(N), kThreads, 0,
                                          (cudaStream_t)stream>>>(
                (const float*)vol, coords, ct, d_vol, d_coords, X, Y, Z, C, N,
                normalized, align);
        }
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
