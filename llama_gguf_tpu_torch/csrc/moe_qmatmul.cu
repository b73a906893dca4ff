// Sparse-MoE grouped dequant-matmul kernels for Hopper (sm_90a) on the CUDA
// cores, for the layouts the tensor-core path of csrc/qgemm.cu does not
// take (ragged N, q4 groups other than 16 and 32, unaligned stacks;
// ops/qmatmul.moe_grouped_plan and moe_glu_grouped_plan choose). Each routed
// slot's input row times the quantized weight of the expert it was routed
// to, read straight from the full expert stack by index (no gathered
// weight copy).
//
// Replaces the Pallas kernels of llama_gguf_tpu/ops/qmatmul.py, for those
// layouts:
//   * grouped     — _moe_qmatmul_grouped_call (plan _moe_group_plan)
//   * grouped GLU — _moe_glu_grouped_call (entry moe_qmatmul_glu)
// (kernel 4, the per-slot product, runs on qgemm.cu's split-K path for
// every layout.)
//
// Stacks (ops/linear.QuantExpertStack): packed uint8 [E, K/2, N] (q4) or
// int8 [E, K, N] (q8), scales and mins float32 [E, K/group, N]; expert e's
// slice is the q4/q8 layout of csrc/qdot.cuh. The output (OT) is float32, or
// bfloat16 in "default" matmul precision (rounded once at the store, as the
// TPU kernels' _out_dtype); the panels stay float32, as the loader keeps
// expert stacks.
//
// What bounds them on this card (hundreds of slots sorted by expert into G
// blocks of C rows, each block single-expert): the f32 multiply-adds on the
// CUDA cores. Design: one block per (group, 8-row block, 32-column tile);
// the block reads eg[g] and its rows' slot ids, gathers its input rows from
// x through those ids (no sorted copy of x), and skips a row block that
// holds padding only (the sentinel id S). Each row block re-reads its
// expert's column panel (from L2 when it is warm). The output is the [G*C,
// N] blocked layout; padding rows are not written, and the caller reads back
// through the plan's inverse map. The GLU variant reads the gate and the up
// stack (two separate stacks) in the same pass and writes act(gate) * up, so
// the [G*C, 2F] intermediate never reaches device memory. An expert id
// outside [0, E) reads nothing and writes NaN.

#include "qdot.cuh"

namespace {

using namespace qdot;

constexpr int RB_GROUPED = 8;  // rows per block of the grouped kernels; divides C

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fffffff); }

__device__ __forceinline__ size_t packed_stride(int fmt, int K, int N) {
    return (fmt == FMT_Q4 ? size_t(K / 2) : size_t(K)) * N;
}

__device__ __forceinline__ Panel<float> expert_panel(const uint8_t* packed, const float* scales,
                                                     const float* mins, size_t pstride,
                                                     size_t sstride, int e, int n0) {
    const size_t eo = size_t(e);
    return {packed + eo * pstride + n0, scales + eo * sstride + n0,
            mins != nullptr ? mins + eo * sstride + n0 : nullptr};
}

// NW = 1: the grouped product over (p0, s0, m0). NW = 2: gate (p0, s0, m0)
// and up (p1, s1, m1), combined by the GLU epilogue. VEC: see qdot::dot_tile.
template <int FMT, int NW, bool VEC, class OT>
__global__ void __launch_bounds__(THREADS)
moe_grouped_kernel(const float* __restrict__ x,       // [S, K]
                   const int* __restrict__ rows,      // [G*C] slot ids, S = padding
                   const int* __restrict__ eg,        // [G] expert of each group
                   const uint8_t* __restrict__ p0, const float* __restrict__ s0,
                   const float* __restrict__ m0,
                   const uint8_t* __restrict__ p1, const float* __restrict__ s1,
                   const float* __restrict__ m1,
                   OT* __restrict__ y,                // [G*C, N]
                   int S, int E, int K, int N, int C, int group, int act) {
    const int row0 = blockIdx.y * RB_GROUPED;  // in the [G*C] blocked layout
    // a group's valid rows come first, so a row block that starts with
    // padding holds nothing else: it exits before any synchronisation
    const int first = __ldg(rows + row0);
    if (first >= S) return;
    const int e = __ldg(eg + row0 / C);
    const bool ok = e >= 0 && e < E;
    const int n0 = blockIdx.x * COLS + 4 * threadIdx.x;

    const float* xr[RB_GROUPED];
#pragma unroll
    for (int r = 0; r < RB_GROUPED; ++r) {
        const int sid = __ldg(rows + row0 + r);
        xr[r] = x + size_t(sid < S ? sid : first) * K;
    }
    const size_t pstride = packed_stride(FMT, K, N), sstride = size_t(K / group) * N;
    Panel<float> w[NW];
    w[0] = expert_panel(p0, s0, m0, pstride, sstride, ok ? e : 0, n0);
    if constexpr (NW == 2) w[1] = expert_panel(p1, s1, m1, pstride, sstride, ok ? e : 0, n0);
    float total[NW];
    dot_tile<FMT, RB_GROUPED, NW, VEC>(xr, w, K, N, group, ok ? N - n0 : 0, total);

    const int tid = threadIdx.y * TX + threadIdx.x;
    if (tid < RB_GROUPED * COLS) {
        const int row = row0 + tid / COLS;
        const int col = blockIdx.x * COLS + tid % COLS;
        if (__ldg(rows + row) < S && col < N) {
            const float v = NW == 2 ? glu_combine(total[0], total[NW - 1], act) : total[0];
            store_out(y + size_t(row) * N + col, ok ? v : nan_f32());
        }
    }
}

dim3 tiles(int N, int nrows) { return dim3((N + COLS - 1) / COLS, nrows); }

template <int FMT, int NW, class OT>
void launch_grouped(dim3 grid, cudaStream_t st, bool vec, const float* x, const int* rows,
                    const int* eg, const uint8_t* p0, const float* s0, const float* m0,
                    const uint8_t* p1, const float* s1, const float* m1, OT* y, int S,
                    int E, int K, int N, int C, int group, int act) {
    const dim3 block(TX, TY);
    if (vec)
        moe_grouped_kernel<FMT, NW, true, OT><<<grid, block, 0, st>>>(
            x, rows, eg, p0, s0, m0, p1, s1, m1, y, S, E, K, N, C, group, act);
    else
        moe_grouped_kernel<FMT, NW, false, OT><<<grid, block, 0, st>>>(
            x, rows, eg, p0, s0, m0, p1, s1, m1, y, S, E, K, N, C, group, act);
}

template <int NW, class OT>
void grouped_typed(dim3 grid, cudaStream_t st, bool vec, const float* x, const int* rows,
                   const int* eg, const uint8_t* p0, const float* s0, const float* m0,
                   const uint8_t* p1, const float* s1, const float* m1, void* y, int S, int E,
                   int K, int N, int C, int group, int fmt, int act) {
    OT* out = static_cast<OT*>(y);
    if (fmt == FMT_Q4)
        launch_grouped<FMT_Q4, NW>(grid, st, vec, x, rows, eg, p0, s0, m0, p1, s1, m1, out, S,
                                   E, K, N, C, group, act);
    else
        launch_grouped<FMT_Q8, NW>(grid, st, vec, x, rows, eg, p0, s0, m0, p1, s1, m1, out, S,
                                   E, K, N, C, group, act);
}

}  // namespace

// y[G*C, N]: row r of group g = x[rows[g*C + r]] @ W[eg[g]], for the rows
// whose slot id is below S (others are left unwritten). C % 8 == 0.
extern "C" int moe_grouped_launch(const float* x, const int* rows, const int* eg,
                                  const void* packed, const float* scales,
                                  const float* mins, void* y, int S, int E, int K, int N,
                                  int C, int G, int group, int fmt, int out_bf16, int vec,
                                  void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* p = static_cast<const uint8_t*>(packed);
    const dim3 grid = tiles(N, G * C / RB_GROUPED);
    if (out_bf16)
        grouped_typed<1, bf16>(grid, st, vec != 0, x, rows, eg, p, scales, mins, nullptr,
                               nullptr, nullptr, y, S, E, K, N, C, group, fmt, 0);
    else
        grouped_typed<1, float>(grid, st, vec != 0, x, rows, eg, p, scales, mins, nullptr,
                                nullptr, nullptr, y, S, E, K, N, C, group, fmt, 0);
    return int(cudaGetLastError());
}

// y[G*C, F] = act(x_r @ Wg[e]) * (x_r @ Wu[e]) over two separate stacks of
// the same layout, with rows, eg and C as in moe_grouped_launch.
// act: 0 silu, 1 gelu (tanh), 2 relu, 3 relu2, 4 swiglu_oai.
extern "C" int moe_glu_grouped_launch(const float* x, const int* rows, const int* eg,
                                      const void* pg, const float* sg, const float* mg,
                                      const void* pu, const float* su, const float* mu,
                                      void* y, int S, int E, int K, int F, int C, int G,
                                      int group, int fmt, int act, int out_bf16, int vec,
                                      void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* g8 = static_cast<const uint8_t*>(pg);
    const uint8_t* u8 = static_cast<const uint8_t*>(pu);
    const dim3 grid = tiles(F, G * C / RB_GROUPED);
    if (out_bf16)
        grouped_typed<2, bf16>(grid, st, vec != 0, x, rows, eg, g8, sg, mg, u8, su, mu, y, S,
                               E, K, F, C, group, fmt, act);
    else
        grouped_typed<2, float>(grid, st, vec != 0, x, rows, eg, g8, sg, mg, u8, su, mu, y, S,
                                E, K, F, C, group, fmt, act);
    return int(cudaGetLastError());
}
