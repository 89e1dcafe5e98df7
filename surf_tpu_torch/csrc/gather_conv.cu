// K4 gather_conv: out[r] = sum_t x[idx[r, t]] . W[t], with idx = -1
// reading zero — every sparse 3x3x3 convolution of the hybrid U-Net as
// one neighbour-row gather plus a (T*Cin x Cout) product.
//
// Replaces (surf_tpu/nn/reg_net.py), forward values: subm_conv_child_nbr
// (:359), subm_conv_parent_nbr (:398), down_conv_c2p_nbr (:429),
// up_conv_p2c_nbr (:464), down_conv_parent_to_dense (:709) and
// up_conv_dense_to_parent (:748).  The caller builds one (rows, T) index
// table per variant from the parent table (the TPU's box-64 and per-slot
// weight layouts are not needed: the table already says which row each
// tap reads).
//
// Bound on the card: bytes.  Per output row: T int32 indices, up to T
// gathered input rows of Cin floats (L2-resident reuse between the rows
// of a parent), Cout floats written; 2*T*Cin*Cout FLOPs per row is at
// most ~55 KFLOP against ~2-4 KB moved, under the f32 ridge point.
//
// Design (correct first): one thread per (row, output channel), channel
// fastest: a warp's threads share the gathered input row (broadcast loads)
// and read neighbouring columns of W[t].  W (<= 27*32*32 floats) stays in
// L1/L2.  f32 accumulation in tap-major, input-channel-minor order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_conv_kernel(const float* __restrict__ x,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ w,
                                   float* __restrict__ out, long long total,
                                   int T, int Cin, int Cout) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int o = (int)(i % Cout);
    const long long r = i / Cout;
    const int* ir = idx + r * T;
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
        const int j = ir[t];
        if (j < 0) continue;
        const float* xr = x + (long long)j * Cin;
        const float* wt = w + (long long)t * Cin * Cout + o;
        for (int c = 0; c < Cin; ++c) acc += xr[c] * wt[(long long)c * Cout];
    }
    out[i] = acc;
}

}  // namespace

extern "C" {

// x (M, Cin) f32, idx (R, T) int32 (-1 = zero), w (T, Cin, Cout) f32,
// out (R, Cout) f32
int gather_conv(const float* x, const int* idx, const float* w, float* out,
                long long R, int T, int Cin, int Cout, void* stream) {
    const long long total = R * Cout;
    if (total > 0) {
        const int threads = 256;
        const unsigned blocks = (unsigned)((total + threads - 1) / threads);
        gather_conv_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            x, idx, w, out, total, T, Cin, Cout);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
