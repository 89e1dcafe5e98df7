// K5 sdf_lattice_mlp: the SDF network's value at the mesh lattice's points,
// pinned to +100 where no stage's nearest voxel is occupied, in one launch:
// the positional embedding, every hidden layer (product, bias, Softplus with
// beta 100 and threshold 20), the stage features appended to each layer's
// input, the skip layer's [h, x_in] / sqrt(2), and of the last layer the
// SDF column alone (the lattice keeps nothing else).
//
// Replaces no TPU kernel: the JAX package leaves the SDF MLP to XLA
// (surf_tpu/nn/sdf_net.py ``mlp``), which fuses the glue into its matrix
// products.  In the port the same function was cuBLAS's f32 SGEMM plus
// PyTorch's ``cat``, bias and five elementwise launches of Softplus around
// each layer, every (n, 156) activation going to device memory and back
// about ten times a layer; at the lattice's 2,097,152 points a call that
// was about 60 ms, and the lattice's ~33 calls most of a DTU validate's
// device time.
//
// Bound on the card: operations.  A point needs about 99 k multiply-adds
// (27x128 + 156x128 + 156x101 + 3x156x128 + 156 at the published widths)
// against 12 B of point, 112 B of features, the occupancy byte and 4 B of
// output: about 6.2 ms a call at 67 TFLOP/s, and 0.05 ms of bytes.
//
// Rounding.  The arithmetic stays FP32, no TF32, and follows the plain
// version's on the card operation for operation, so that the lattice is
// that version's bit for bit nearly everywhere (marching cubes puts a
// vertex at u0 / (u0 - u1), which a change in the last bit of two nearly
// equal corner values moves by a large share of a cell): each product
// sums its terms in the plain version's order [h | x_in | features] with
// one FFMA a term from 0, as cuBLAS's f32 SGEMM does (the zero rows of a
// slice add exact zeros); the bias is added after; the skip's 1/sqrt(2)
// scales the activations, not the weights; a division by a constant is a
// product by its reciprocal, as PyTorch's division by a Python number is.
// This file's own arithmetic is ``fmaf``, ``__fmul_rn`` and ``__fadd_rn``.
// On the H100 the library functions (sinf, cosf, expf, log1pf) equal
// PyTorch's bit for bit, and cuBLAS sums in order, but for the last 64
// rows of a 2,097,152-row product (a full lattice call), which it hands to
// a split-K kernel: there, and only there, the plain version differs.
//
// Design.  A block of 256 threads takes tiles of kP = 128 points,
// persistently, and keeps each tile's activations in shared memory for all
// the layers, channel-major: act[row][point], with the rows of a canonical
// layer input [h (128 rows) | x_in (E) | features (F)] (184 rows at the
// published widths).  A layer's input is a set of 8-row slices of act: the
// concatenation is an index, not a copy.  The wrapper lays every layer's
// weights out as those slices, (8, 128) each, zero where a row is absent
// from that layer (x_in outside the skip layer), and the whole list of
// slices (about 416 KB) is streamed from L2 through a three-deep cp.async
// ring, the next slice in flight while this one computes, across layer and
// tile boundaries.  Each thread keeps an 8-point x 8-output register tile
// (64 sums), reading per row one float4 pair of activations and one of
// weights: 4 shared loads for 64 FMAs.  The epilogue adds the bias, applies
// Softplus (precise ``expf``/``log1pf``) and writes the layer's output over
// the h rows once every thread has read them.  The last layer is a dot
// product a point over the canonical rows.  At 184 rows a block holds 97 KB
// of activations and 12 KB of ring, so two blocks share an SM and one's
// epilogue overlaps the other's products.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kP = 128;            // points a tile
constexpr int kN = 128;            // outputs of a hidden layer (padded)
constexpr int kK = 8;              // rows of a weight slice
constexpr int kStages = 3;         // weight slices in the ring
constexpr int kThreads = 256;
constexpr int kPitch = kP + 4;     // floats a row of act: float4 stores of
                                   // 8 output rows fall on distinct banks
constexpr int kMaxLayers = 16;
constexpr int kMaxSlices = 512;
constexpr int kSliceFloats = kK * kN;
// x / sqrt(2) as PyTorch computes it on the card: x * (1 / RN(sqrt(2)))
constexpr float kInvSqrt2 = 1.0f / 1.41421356237309515f;

struct Params {
    const float* pts;              // (n, 3)
    const float* feats;            // (n, F)
    const unsigned char* occ;      // (n,) bool
    const float* w;                // (slices, 8, 128)
    const float* bias;             // (n_hidden, 128)
    const float* w_last;           // (rows,) the SDF column on the canonical rows
    float* out;                    // (n,)
    long long n;
    float b_last;
    float scale;
    int F, E, multires, rows, e_row, f_row, n_hidden;
    unsigned skip;                 // bit l: layer l takes [h, x_in] / sqrt(2)
    int layer_end[kMaxLayers];     // cumulative slices, layer by layer
    short slice_row[kMaxSlices];   // first act row of each slice
};

__device__ __forceinline__ void cp_async16(void* smem, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// torch.nn.Softplus(beta=100, threshold=20) as the port writes it
// (nn/core.py softplus_beta): linear where 100 x > 20, else
// log1p(exp(100 x)) / 100, the quotient taken as PyTorch takes it on the
// card: its division by a Python number multiplies by the number's
// reciprocal in float (RN(1/100) is 0.01f), and so does this.
__device__ __forceinline__ float softplus100(float x) {
    const float z = __fmul_rn(x, 100.0f);
    return z > 20.0f ? x : __fmul_rn(log1pf(expf(z)), 0.01f);
}

// ``__grid_constant__``: the slice table is indexed in the parameter space
// itself, not copied to each thread's stack
__global__ void __launch_bounds__(kThreads, 2) lattice_mlp(const __grid_constant__ Params p) {
    extern __shared__ float4 smem4[];
    float* act = reinterpret_cast<float*>(smem4);          // (rows, kPitch)
    float* ring = act + p.rows * kPitch;                   // (kStages, 8, 128)
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    // a warp covers 8 output groups x 4 point groups, so each of its
    // shared loads touches 128 distinct bytes at most
    const int tx = (lane & 7) | ((warp & 1) << 3);         // outputs tx*4 + {0..3, 64..67}
    const int ty = (lane >> 3) | ((warp >> 1) << 2);       // points ty*4 + {0..3, 64..67}

    const long long ntiles = (p.n + kP - 1) / kP;
    const long long mine = ntiles > blockIdx.x ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const int per_tile = p.layer_end[p.n_hidden - 1];

    for (int i = tid; i < p.rows * kPitch; i += kThreads) act[i] = 0.0f;

    // The block's stream of weight slices: every tile runs the same list.
    // The loader's place in it is kept as counters (no 64-bit division a
    // slice): ld_slice in the list, ld_left slices still to load; slice g
    // goes to ring stage g % kStages, and ``stage`` is the one computed.
    long long ld_left = mine * per_tile;
    int ld_slice = 0, ld_stage = 0, stage = 0;
    auto load = [&]() {
        if (ld_left > 0) {
            const float* src = p.w + (size_t)ld_slice * kSliceFloats;
            float* dst = ring + ld_stage * kSliceFloats;
            for (int i = tid * 4; i < kSliceFloats; i += kThreads * 4) cp_async16(dst + i, src + i);
            --ld_left;
            if (++ld_slice == per_tile) ld_slice = 0;
        }
        if (++ld_stage == kStages) ld_stage = 0;
        cp_async_commit();
    };
    for (int i = 0; i < kStages - 1; ++i) load();

    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const long long base = tile * kP;
        __syncthreads();                                   // the last tile's reads are done
        // the embedding (embedder.py's order: x, then sin, cos of x 2^i)
        if (tid < kP) {
            const long long q = base + tid;
            for (int d = 0; d < 3; ++d) {
                const float x = q < p.n ? __fmul_rn(p.pts[q * 3 + d], p.scale) : 0.0f;
                act[(p.e_row + d) * kPitch + tid] = x;
                float f = 1.0f;
                for (int i = 0; i < p.multires; ++i, f *= 2.0f) {
                    act[(p.e_row + 3 * (1 + 2 * i) + d) * kPitch + tid] = sinf(__fmul_rn(x, f));
                    act[(p.e_row + 3 * (2 + 2 * i) + d) * kPitch + tid] = cosf(__fmul_rn(x, f));
                }
            }
        }
        // the stage features, read along the point-major rows
        const int nf = kP * p.F;
        for (int i = tid; i < nf; i += kThreads) {
            const int q = i / p.F, c = i - q * p.F;
            act[(p.f_row + c) * kPitch + q] =
                base + q < p.n ? p.feats[base * p.F + i] : 0.0f;
        }

        for (int layer = 0; layer < p.n_hidden; ++layer) {
            float acc[8][8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
            const int s_end = p.layer_end[layer];
            for (int s = layer ? p.layer_end[layer - 1] : 0; s < s_end; ++s) {
                cp_async_wait_ring();
                __syncthreads();                           // this slice landed, the last one read
                load();                                    // into the stage read last
                const float* wt = ring + stage * kSliceFloats + tx * 4;
                if (++stage == kStages) stage = 0;
                const float* at = act + p.slice_row[s] * kPitch + ty * 4;
#pragma unroll
                for (int k = 0; k < kK; ++k) {
                    const float4 a0 = *reinterpret_cast<const float4*>(at + k * kPitch);
                    const float4 a1 = *reinterpret_cast<const float4*>(at + k * kPitch + 64);
                    const float4 b0 = *reinterpret_cast<const float4*>(wt + k * kN);
                    const float4 b1 = *reinterpret_cast<const float4*>(wt + k * kN + 64);
                    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                    for (int i = 0; i < 8; ++i)
#pragma unroll
                        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
                }
            }
            __syncthreads();                               // every read of the input is done
            // the skip's 1/sqrt(2) on the activations, as the plain version
            // scales them: the output of a layer that feeds a skip layer, and
            // x_in once layer 0 has read it
            const bool to_skip = (p.skip >> (layer + 1)) & 1u;
            if (layer == 0 && p.skip != 0u)
                for (int i = tid; i < p.E * kP; i += kThreads)
                    act[(p.e_row + i / kP) * kPitch + i % kP] =
                        __fmul_rn(act[(p.e_row + i / kP) * kPitch + i % kP], kInvSqrt2);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int o = tx * 4 + (j & 3) + (j >> 2) * 64;
                const float bj = p.bias[layer * kN + o];
                float v[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    v[i] = softplus100(__fadd_rn(acc[i][j], bj));
                    if (to_skip) v[i] = __fmul_rn(v[i], kInvSqrt2);
                }
                float* dst = act + o * kPitch + ty * 4;
                *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
                *reinterpret_cast<float4*>(dst + 64) = make_float4(v[4], v[5], v[6], v[7]);
            }
        }
        __syncthreads();                                   // the last hidden layer is written
        if (tid < kP && base + tid < p.n) {
            const long long q = base + tid;
            float sdf = 0.0f;
            for (int r = 0; r < p.rows; ++r) sdf = fmaf(act[r * kPitch + tid], p.w_last[r], sdf);
            p.out[q] = p.occ[q] ? __fmul_rn(__fadd_rn(sdf, p.b_last), 1.0f / p.scale) : 100.0f;
        }
    }
}

}  // namespace

extern "C" {

// pts (n, 3) f32, feats (n, F) f32, occ (n,) bool; w (slices, 8, 128) f32
// with slice_row[s] the first canonical row of slice s and layer_end[l] the
// slices of layers 0..l; skip, bit l: layer l is a skip layer; bias
// (n_hidden, 128); w_last (rows,) and b_last the last layer's SDF column.
// Writes out (n,) f32.  Returns a CUDA error code (0: launched).
int sdf_lattice_mlp(const float* pts, const float* feats, const unsigned char* occ,
                    long long n, int F, int multires, float scale, const float* w,
                    const int* slice_row, const int* layer_end, int n_hidden,
                    unsigned skip, const float* bias, const float* w_last, float b_last,
                    int rows, int e_row, int f_row, float* out, void* stream) {
    if (n_hidden < 1 || n_hidden > kMaxLayers || rows % kK != 0 ||
        layer_end[n_hidden - 1] > kMaxSlices)
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    Params p;
    p.pts = pts; p.feats = feats; p.occ = occ; p.w = w; p.bias = bias; p.w_last = w_last;
    p.out = out; p.n = n; p.b_last = b_last; p.scale = scale; p.F = F;
    p.multires = multires; p.rows = rows; p.e_row = e_row; p.f_row = f_row;
    p.n_hidden = n_hidden; p.skip = skip; p.E = 3 * (1 + 2 * multires);
    for (int l = 0; l < n_hidden; ++l) p.layer_end[l] = layer_end[l];
    for (int s = 0; s < layer_end[n_hidden - 1]; ++s) p.slice_row[s] = (short)slice_row[s];
    const size_t smem = ((size_t)rows * kPitch + (size_t)kStages * kSliceFloats) * 4;
    cudaError_t err = cudaFuncSetAttribute(lattice_mlp,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lattice_mlp, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long ntiles = (n + kP - 1) / kP;
    const long long cap = (long long)per_sm * sms;
    const int blocks = (int)(ntiles < cap ? ntiles : cap);
    lattice_mlp<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
