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
//
// Training: the input gradient of every variant is this same kernel on
// the transposed table (idx_t[j, t] = r where idx[r, t] = j; each conv's
// table is one-to-one per tap) with W[t] transposed.
//
// K4w gather_conv_dw: dW[t] = sum_r x[idx[r, t]]^T ct[r] (idx -1 skipped),
// the weight gradient.  Replaces the dW halves of the JAX VJPs _scc_bwd
// (reg_net.py:368), _scp_bwd (:407), _dcp_bwd (:439), _upc_bwd (:473),
// _down_p2d_bwd (:719) and _up_d2p_bwd (:758).  Bound: bytes — the table,
// the gathered rows of x and ct are read, 2*T*Cin*Cout flops per row.
// Design (correct first): a block per (row tile, tap); it stages 32 rows
// of gathered x and of ct in shared memory at a time, each thread keeps
// the sums of up to 4 (cin, cout) pairs in registers, and at the end of
// the tile adds them to dW with one f32 atomicAdd per pair.

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

constexpr int kDwThreads = 256;
constexpr int kDwChunk = 32;       // rows staged in shared memory at a time
constexpr int kDwRows = 2048;      // rows per block
constexpr int kMaxC = 32;

__global__ void gather_conv_dw_kernel(const float* __restrict__ x,
                                      const int* __restrict__ idx,
                                      const float* __restrict__ ct,
                                      float* __restrict__ dw, long long R,
                                      int T, int Cin, int Cout) {
    __shared__ float xs[kDwChunk][kMaxC];
    __shared__ float cs[kDwChunk][kMaxC];
    const int t = blockIdx.y;
    const long long r0 = (long long)blockIdx.x * kDwRows;
    const long long r1 = r0 + kDwRows < R ? r0 + kDwRows : R;
    const int npairs = Cin * Cout;
    float acc[kMaxC * kMaxC / kDwThreads];
#pragma unroll
    for (int q = 0; q < kMaxC * kMaxC / kDwThreads; ++q) acc[q] = 0.0f;
    for (long long rc = r0; rc < r1; rc += kDwChunk) {
        for (int e = threadIdx.x; e < kDwChunk * kMaxC; e += kDwThreads) {
            const int rr = e / kMaxC, c = e % kMaxC;
            const long long r = rc + rr;
            float xv = 0.0f, cv = 0.0f;
            if (r < r1) {
                if (c < Cin) {
                    const int j = idx[r * T + t];
                    if (j >= 0) xv = x[(long long)j * Cin + c];
                }
                if (c < Cout) cv = ct[r * Cout + c];
            }
            xs[rr][c] = xv;
            cs[rr][c] = cv;
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kMaxC * kMaxC / kDwThreads; ++q) {
            const int p = threadIdx.x + q * kDwThreads;
            if (p < npairs) {
                const int ci = p / Cout, co = p % Cout;
                float a = acc[q];
                for (int rr = 0; rr < kDwChunk; ++rr) a += xs[rr][ci] * cs[rr][co];
                acc[q] = a;
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kMaxC * kMaxC / kDwThreads; ++q) {
        const int p = threadIdx.x + q * kDwThreads;
        if (p < npairs) {
            const int ci = p / Cout, co = p % Cout;
            atomicAdd(dw + ((long long)t * Cin + ci) * Cout + co, acc[q]);
        }
    }
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

// K4w.  x (M, Cin) f32, idx (R, T) int32 (-1 = skipped), ct (R, Cout)
// f32; dw (T, Cin, Cout) f32 zero-filled by the caller.
int gather_conv_dw(const float* x, const int* idx, const float* ct, float* dw,
                   long long R, int T, int Cin, int Cout, void* stream) {
    if (Cin > kMaxC || Cout > kMaxC) return (int)cudaErrorInvalidValue;
    if (R > 0 && T > 0) {
        const dim3 grid((unsigned)((R + kDwRows - 1) / kDwRows), (unsigned)T);
        gather_conv_dw_kernel<<<grid, kDwThreads, 0, (cudaStream_t)stream>>>(
            x, idx, ct, dw, R, T, Cin, Cout);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
