// Fused gate|up dequant-matmul kernel (GLU) for Hopper (sm_90a):
// y = act(x @ W[:, :F]) * (x @ W[:, F:]) with W quantized.
//
// Replaces the Pallas kernel of llama_gguf_tpu/ops/qmatmul.py
// _qmatmul_glu_call (pallas_call :500) with _glu_kernel/_glu_combine
// ("qmatmul_glu"). Kernels 1 and 2 (the plain q4 and q8 products,
// _qmatmul_call with _q4_kernel:138 / _q8_kernel:164) moved to
// csrc/qgemm.cu: a tensor-core path from ops/qmatmul.TC_MIN_ROWS rows on
// (bound: three bf16 passes at 989 TFLOP/s, or the bytes) and a split-K
// CUDA-core path below (bound: the weight bytes); the threshold and the
// measurement that set it are written there and in PERF.md.
//
// Layouts, tiling and the dequant-dot body: csrc/qdot.cuh, shared with the
// MoE kernels of csrc/moe_qmatmul.cu.
//
// What bounds it on this card: at decode batch sizes (B <= 8) the weight
// bytes (4 or 8 bits per weight plus the f32 or bf16 scale/min panels) read
// once from HBM; at prefill sizes (hundreds of rows) the f32 multiply-adds on
// the CUDA cores (no tensor cores yet).
//
// Design: a block owns a tile of 32 output columns and RB <= 8 rows and loops
// over all of K (qdot::dot_tile), reading the gate columns and the up
// columns (offset F in the fused weight) in the same pass and writing
// act(gate) * up, so the [B, 2F] intermediate never reaches device memory.
// Ragged N and rows are masked. Accumulation is float32. Panels (SP) and the
// output (OT) are float or bf16, every combination instantiated: bf16 panels
// halve the panel bytes, and a bf16 output ("default" matmul precision, the
// TPU kernels' _out_dtype) is rounded once at the store.

#include "qdot.cuh"

namespace {

using namespace qdot;

// Two weight column sets: gate at column n, up at column n + ncols of the
// fused weight. VEC: see qdot::dot_tile.
template <int FMT, int RB, bool VEC, class SP, class OT>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const float* __restrict__ x,        // [B, K]
               const uint8_t* __restrict__ packed,  // q4 [K/2, ldw] / q8 [K, ldw]
               const SP* __restrict__ scales,       // [K/group, ldw]
               const SP* __restrict__ mins,         // [K/group, ldw] or null
               OT* __restrict__ y,                  // [B, ncols]
               int B, int K, int ncols, int ldw, int group, int act) {
    const int n0 = blockIdx.x * COLS + 4 * threadIdx.x;
    const int row0 = blockIdx.y * RB;

    const float* xr[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) xr[r] = x + size_t(min(row0 + r, B - 1)) * K;
    Panel<SP> w[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int off = n0 + s * ncols;
        w[s] = {packed + off, scales + off, mins != nullptr ? mins + off : nullptr};
    }
    float total[2];
    dot_tile<FMT, RB, 2, VEC>(xr, w, K, ldw, group, ncols - n0, total);

    const int tid = threadIdx.y * TX + threadIdx.x;
    if (tid < RB * COLS) {
        const int row = row0 + tid / COLS;
        const int col = blockIdx.x * COLS + tid % COLS;
        if (row < B && col < ncols)
            store_out(y + size_t(row) * ncols + col, glu_combine(total[0], total[1], act));
    }
}

int rows_per_block(int B) { return B >= 5 ? 8 : B >= 3 ? 4 : B == 2 ? 2 : 1; }

// One launch's arguments, typed: the entry points below pick SP and OT.
template <class SP, class OT>
struct Args {
    const float* x;
    const uint8_t* packed;
    const SP* scales;
    const SP* mins;
    OT* y;
    int B, K, ncols, ldw, group, act;
};

template <int FMT, int RB, class SP, class OT>
void launch_rb(dim3 grid, cudaStream_t stream, bool vec, const Args<SP, OT>& a) {
    const dim3 block(TX, TY);
    if (vec)
        qmatmul_kernel<FMT, RB, true, SP, OT><<<grid, block, 0, stream>>>(
            a.x, a.packed, a.scales, a.mins, a.y, a.B, a.K, a.ncols, a.ldw, a.group, a.act);
    else
        qmatmul_kernel<FMT, RB, false, SP, OT><<<grid, block, 0, stream>>>(
            a.x, a.packed, a.scales, a.mins, a.y, a.B, a.K, a.ncols, a.ldw, a.group, a.act);
}

template <int FMT, class SP, class OT>
int launch(const Args<SP, OT>& a, bool vec, cudaStream_t stream) {
    const int rb = rows_per_block(a.B);
    const dim3 grid((a.ncols + COLS - 1) / COLS, (a.B + rb - 1) / rb);
    switch (rb) {
    case 1: launch_rb<FMT, 1>(grid, stream, vec, a); break;
    case 2: launch_rb<FMT, 2>(grid, stream, vec, a); break;
    case 4: launch_rb<FMT, 4>(grid, stream, vec, a); break;
    default: launch_rb<FMT, 8>(grid, stream, vec, a); break;
    }
    return int(cudaGetLastError());
}

template <class SP, class OT>
int launch_typed(const float* x, const void* packed, const void* scales, const void* mins,
                 void* y, int B, int K, int ncols, int ldw, int group, int fmt, int act,
                 int vec, cudaStream_t stream) {
    const Args<SP, OT> a{x, static_cast<const uint8_t*>(packed), static_cast<const SP*>(scales),
                         static_cast<const SP*>(mins), static_cast<OT*>(y),
                         B, K, ncols, ldw, group, act};
    return fmt == FMT_Q4 ? launch<FMT_Q4>(a, vec != 0, stream)
                         : launch<FMT_Q8>(a, vec != 0, stream);
}

}  // namespace

// y[B, F] = act(x @ W[:, :F]) * (x @ W[:, F:]) over a fused [gate | up]
// weight W[K, 2F]. act: 0 silu, 1 gelu (tanh), 2 relu, 3 relu2, 4 swiglu_oai.
// fmt: 0 = q4, 1 = q8; mins may be null. panel_bf16: scales and mins are
// bfloat16 (else float32); out_bf16: y is bfloat16 (else float32). vec: 1
// when F % 4 == 0 and every panel is aligned to 4 of its elements. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int qmatmul_glu_launch(const float* x, const void* packed, const void* scales,
                                  const void* mins, void* y, int B, int K, int F, int group,
                                  int fmt, int act, int panel_bf16, int out_bf16, int vec,
                                  void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int ldw = 2 * F;
    if (panel_bf16)
        return out_bf16 ? launch_typed<bf16, bf16>(x, packed, scales, mins, y, B, K, F, ldw, group, fmt, act, vec, s)
                        : launch_typed<bf16, float>(x, packed, scales, mins, y, B, K, F, ldw, group, fmt, act, vec, s);
    return out_bf16 ? launch_typed<float, bf16>(x, packed, scales, mins, y, B, K, F, ldw, group, fmt, act, vec, s)
                    : launch_typed<float, float>(x, packed, scales, mins, y, B, K, F, ldw, group, fmt, act, vec, s);
}
