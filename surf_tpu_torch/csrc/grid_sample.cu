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
// Design (correct first): one thread per (sample, channel), channel
// fastest, so the threads of a warp read neighbouring channels of the same
// corner rows and write one contiguous output row.  Coordinates are
// unnormalized in the kernel with the same operation order as the plain
// PyTorch version (built with -fmad=false, so the floors agree).  The
// corner sum runs in the reference's corner order.  No shared memory.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float unnormalize(float c, int size, int align) {
    if (align) return (c + 1.0f) * 0.5f * (float)(size - 1);
    return ((c + 1.0f) * (float)size - 1.0f) * 0.5f;
}

__global__ void bilinear_kernel(const float* __restrict__ img,
                                const float* __restrict__ coords,
                                float* __restrict__ out,
                                int H, int W, int C, long long N,
                                long long total, int normalized, int align) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int c = (int)(i % C);
    const long long vn = i / C;            // (view, sample)
    const long long v = vn / N;
    float x = coords[2 * vn];
    float y = coords[2 * vn + 1];
    if (normalized) {
        x = unnormalize(x, W, align);
        y = unnormalize(y, H, align);
    }
    const float x0f = floorf(x), y0f = floorf(y);
    const float fx = x - x0f, fy = y - y0f;
    const long long x0 = (long long)x0f, y0 = (long long)y0f;
    const float* base = img + v * (long long)H * W * C;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int ox = k & 1, oy = k >> 1;   // (0,0), (1,0), (0,1), (1,1)
        const long long cx = x0 + ox, cy = y0 + oy;
        const bool valid = cx >= 0 && cx < W && cy >= 0 && cy < H;
        const float w = (ox ? fx : 1.0f - fx) * (oy ? fy : 1.0f - fy);
        if (valid) acc += base[(cy * W + cx) * C + c] * w;
    }
    out[i] = acc;
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

constexpr int kThreads = 256;

inline unsigned blocks_for(long long total) {
    return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// img (V, H, W, C) f32, coords (V, N, 2) f32, out (V, N, C) f32
int bilinear_sample_2d(const float* img, const float* coords, float* out,
                       int V, int H, int W, int C, long long N,
                       int normalized, int align, void* stream) {
    const long long total = (long long)V * N * C;
    if (total > 0) {
        bilinear_kernel<<<blocks_for(total), kThreads, 0,
                          (cudaStream_t)stream>>>(
            img, coords, out, H, W, C, N, total, normalized, align);
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

}  // extern "C"
