// Dequant-matmul kernels 1-6 for Hopper (sm_90a): products of x float32
// [B, K] with a quantized weight W (q4 or q8) or a stack of E experts of
// one, y float32 or bfloat16.
//
// Replaces the Pallas kernels of llama_gguf_tpu/ops/qmatmul.py (the kind
// is a template argument, see KIND_*):
//   * kernels 1-2, kind 0: _qmatmul_call (pallas_call :309) with
//     _q4_kernel (:138, "qmatmul_q4") and _q8_kernel (:164, "qmatmul_q8"):
//     y[B, N] = x @ W[K, N];
//   * kernel 3, KIND_GLU: _qmatmul_glu_call (pallas_call :500) with
//     _glu_kernel (:198, "qmatmul_glu"): y[B, F] = act(x @ W[:, :F]) *
//     (x @ W[:, F:]) over the fused gate|up weight W[K, 2F] (here N = F);
//   * kernel 4, KIND_SLOT: _moe_qmatmul_call (pallas_call :642,
//     "moe_slot"): y[s] = x[s] @ W[idx[s]] over an expert stack, one slot
//     per row (decode: fewer than 32 slots);
//   * kernel 5, KIND_GATHERED: _moe_qmatmul_grouped_call (pallas_call
//     :736, "moe_grouped"): the C-row single-expert blocks of the plan of
//     _moe_group_plan (ops/qmatmul.moe_group_plan): row r of the blocked
//     [G*C, N] output is x[rows[r]] @ W[eg[r / C]] over an expert stack;
//   * kernel 6, KIND_GLU | KIND_GATHERED: _moe_glu_grouped_call
//     (pallas_call :861, "moe_glu_grouped"): kernel 5's rows with kernel
//     3's epilogue over two stacks, act(x[rows[r]] @ Wg[e]) *
//     (x[rows[r]] @ Wu[e]).
// All compute
//     y = sum_g s[g] * (x_g @ q_g) - xs[g]^T m[g]    (f32 sums)
// with xs[g] the group sums of x (the min term factored as in _min_dot),
// rounded once to the output type at the store (_out_dtype). Layouts: see
// csrc/qdot.cuh (q4 group-split nibbles [K/2, N], q8 [K, N], panels
// [K/group, N] float32 or bfloat16; an expert stack is E of them, float32
// panels). ops/qmatmul.qmatmul_plan, moe_slot_plan, moe_grouped_plan and
// moe_glu_grouped_plan pick the path, the tile and the split of K; one
// launch per call either way.
//
// Every kind runs on one of the same two paths. A block owns 128 columns
// of the weight: kernels 1, 2, 4 and 5 128 output columns, the GLUs 64
// gate columns and the 64 up columns that pair with them (F further on in
// kernel 3's fused weight, row stride 2F; the same columns of the up stack
// in kernel 6, row stride F), so the tile, its loads, its fragments and
// its workspace are the same for all. A GLU's partial tile is summed over
// the K slices first and act(gate) * up taken after, never on partials.
//
// Tensor-core path ("tc", from ops/qmatmul.TC_MIN_ROWS = 5 rows on). Bound:
// the operations, max(bytes / 3.35 TB/s, P * 2*B*K*N / 989 TFLOP/s), since
// P = 3 bf16 products are the least an f32-accurate product costs on the
// tensor cores (P = 2 for a bf16 output, see below). Design: a block of 4
// warps owns BM = 16, 32 or 64 rows x 128
// columns and walks its K slice 32 elements (one or two scale groups) per
// stage through a ring of cp.async stages (x rows in f32, the packed bytes,
// the scale and min rows), with one barrier per stage: while the warps run
// stage i's products they already split stage i + 1's x. The block splits x
// once into three bf16 parts hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
// hi - mid), which add back to x exactly (one paired conversion rounds two
// values); q (0..15, or int8) is exact in bf16, so the products hi*q + mid*q
// + lo*q (mma.sync m16n8k16, f32 accumulate) are x*q as f32 computes it.
// "default" (bf16 outputs) drops lo: two passes, x kept to 16 bits, far
// inside one bf16 ulp. Each warp converts its 32 columns' bytes straight
// from shared memory into B fragments (nibbles or int8 -> bf16 in
// registers; the columns of a warp are permuted so that one 32-bit word
// gives a thread its column in each of the four n8 tiles) and folds each
// group's product into f32: acc += s * C_g - m * xs_g. For Q4_K the low
// nibbles of a group's 16 packed rows are one k16 step against x[k0 ..
// k0+15], the high nibbles the next against x[k0+16 .. k0+31]. Within a k16
// step the fragment's k order is permuted (physical k = t + 4i for fragment
// rows 2t, 2t+1, 2t+8, 2t+9), the same for x and W, so every shared-memory
// read is conflict-free. Other layouts (Q2_K's q4 group 16, Q8_K's q8 group
// 256): at q4 group 16 a stage holds two groups of 8 packed rows, and a k16
// step is exactly one group, its low nibbles against x[k0 .. k0+7] and its
// high nibbles against x[k0+8 .. k0+15] (a B fragment built from 8 rows,
// folded every step, as q8 group 16 is). At group 256 a group spans 8
// stages: C_g carries across them, each stage adds its x sums to the
// thread's running ones, and the fold comes at the group's last stage; a K
// slice holds whole groups.
//
// The grouped products (kernels 5 and 6) are this path with gathered rows:
// a BM-row tile of the blocked layout lies inside one C-row group (BM
// divides C), so it reads its expert e = eg[row0 / C] once and offsets the
// packed bytes and panels by e times the expert's stride; its x rows arrive
// by cp.async from x[rows[row0 + r]] (the padding id S zero-fills, no
// sorted copy of x is made). A group's valid rows come first, so a tile
// whose first id is S is padding only: every K slice of it exits before its
// first barrier. Padding rows are not written. Kernel 6's threads that
// stage the up half of the tile (columns 64-127: the packed chunks q >= 4
// and the panel chunks past 64) read the up stack, the others the gate
// stack, so one pass over x meets both weights and the [G*C, 2F]
// intermediate never reaches device memory. Bound: the routed experts'
// bytes, read once (each expert's rows share a tile or two), against P bf16
// passes.
//
// Split-K path ("splitk", 1 to 4 rows: decode). Bound: the weight bytes,
// read once from HBM. A grid over columns alone leaves most of the 132 SMs
// idle at one row (16 blocks of 128 columns for a 2048-column weight), so K
// is cut into `splits` slices of whole scale groups (of 32 packed rows in
// longer groups, two groups of 8 at q4 group 16) and each block of 64
// threads owns 128 columns x one row x one slice. Eight threads side by
// side read 128 contiguous bytes of a packed row, each 16 columns; each
// keeps 16 rows' 16-byte loads in flight before it uses the first, turns
// bytes into floats with a byte permute and a subtraction (no integer
// conversion), and folds s and m per chunk of 16 packed rows (linear, so
// any cut of a group is exact; at q4 group 16 a chunk is two groups of 8
// rows, each with its own x offsets and its own fold). What bounds it at TinyLlama's 2048-wide q4
// weights is latency, not bytes: by profiler device time
// (scripts/bench_qmatmul.py attribute, H100 80GB HBM3, 700 W) an empty
// kernel takes 2.0 us, a launch whose threads each load one chunk 7.0 us,
// and the split sum adds 1.9 us, against 9.5 us for the whole qkv product
// (3.9 MB with its panels; bytes bound 1.2 us), so no split of K brings it
// much below the 9.0 us of the earlier unsplit 32-column kernel. The split
// pays off with depth: ffn_down (K = 5632) takes 13.8 us, against 109 us
// unsplit and 49.5 us for the earlier kernel. Kernel 4 is this path with an
// expert per row: block row s reads e = eg[s] from device memory (the host
// never reads it) and offsets the packed bytes and panels by e times the
// expert's stride; an invalid e makes every slice of the row leave before
// the workspace and the counter, and slice 0 writes the row's NaN. Its
// bound: the routed experts' bytes (Mixtral's 14336-wide gate and up: the
// regime of the wide LM heads, where split-K reaches 66-79% of it).
//
// Threshold and splits: scripts/bench_qmatmul.py `paths` on an H100 80GB
// HBM3 (700 W) timed both paths at 1-16, 32, 64, 128 and 512 rows at
// TinyLlama-1.1B's, Mixtral-8x7B's and the probe's shapes: from 5 rows the
// tensor cores were at least as fast as split-K at 7 of the 9 shapes (the
// two 2048-column q4 weights cross at 7-9 rows, where both take under 25
// us), and its sweeps of the split count set the slice rules of
// qmatmul_plan.
//
// Both paths sum the partials of the K slices in a fixed order inside the
// launch (qgemm::split_sum): each block of an output tile writes its partial
// tile to a workspace the wrapper keeps per device, and the last of the
// tile's blocks to arrive (a per-tile counter, reset by that block) adds
// the partials in slice order, so two calls give the same bits. A thread
// block cluster summing through distributed shared memory would need no
// workspace, but on the H100 its launches ran slower back to back than the
// kernels themselves.

#include "glu.cuh"
#include "qgemm.cuh"

#include <type_traits>

namespace {

using namespace qgemm;

// The kind of product: bit flags, the last template argument of both
// kernels (the decode profiles key on it). 0: kernels 1-2; KIND_GLU: kernel
// 3 (act(gate) * up); KIND_GATHERED: kernel 5 (rows gathered through the
// plan's slot ids, the expert of each C-row group from eg; tensor cores);
// KIND_GLU | KIND_GATHERED: kernel 6, whose gate and up are two stacks of
// the same layout; KIND_SLOT: kernel 4 (the expert of each row from eg;
// split-K).
enum { KIND_PLAIN = 0, KIND_GLU = 1, KIND_GATHERED = 2, KIND_SLOT = 4 };

// The weight's layout class, the second template argument of both kernels:
// the layouts of Q4_K, Q6_K, Q8_0, ... (q4 group 32, q8 group 16 or 32);
// Q2_K's q4 group 16; and q8 groups longer than a stage (Q8_K's 256). Each
// class is its own instantiation, so the new layouts cost the others
// nothing.
enum { LAY_STD = 0, LAY_G16 = 1, LAY_LONG = 2 };

__host__ __device__ constexpr bool is_glu(int kind) { return (kind & KIND_GLU) != 0; }
__host__ __device__ constexpr bool is_gathered(int kind) { return (kind & KIND_GATHERED) != 0; }
__host__ __device__ constexpr bool two_stacks(int kind) {
    return is_glu(kind) && is_gathered(kind);
}

constexpr int TILE = 128;  // weight columns per block, both paths

// Tile column c (0..TILE-1) of column tile t: the output column it feeds
// and the weight column it reads. GLU: c < H = TILE/2 are the gate columns
// t*H + c, c >= H the matching up columns t*H + c - H, both feeding output
// column t*H + c % H; in the fused [K, 2N] weight of kernel 3 the up
// columns lie N further on, in kernel 6 they are those of the up stack
// (in_up). Otherwise both t*TILE + c.
template <int KIND>
__device__ __forceinline__ int out_col(int t, int c) {
    return is_glu(KIND) ? t * (TILE / 2) + c % (TILE / 2) : t * TILE + c;
}

template <int KIND>
__device__ __forceinline__ int weight_col(int t, int c, int N) {
    return is_glu(KIND) && !two_stacks(KIND) && c >= TILE / 2 ? N + out_col<KIND>(t, c)
                                                               : out_col<KIND>(t, c);
}

template <int KIND>
__device__ __forceinline__ bool in_up(int c) {
    return two_stacks(KIND) && c >= TILE / 2;
}

// The weight's row stride: the fused gate|up weight's 2N, else N.
template <int KIND>
__device__ __forceinline__ int row_stride(int N) {
    return is_glu(KIND) && !two_stacks(KIND) ? 2 * N : N;
}

// The block's partial tile part[rows][TILE] (shared memory) through the
// fixed-order split sum into y[., N], tile rows from row0 on: kernels 1, 2
// and 5 store each sum; the GLU puts the sums back into part and then
// writes act(part[r][c]) * part[r][c + TILE/2]. keep(r): tile row r is
// written.
template <int KIND, class OT, class Keep>
__device__ __forceinline__ void finish(float* part, int rows, float* ws, int* counters,
                                       int splits, OT* y, int row0, int N, int act, Keep keep) {
    const int t = blockIdx.z;
    const bool done = split_sum(part, rows * TILE, ws, counters, splits, [&](int e, float v) {
        if (is_glu(KIND)) {
            part[e] = v;
            return;
        }
        const int r = e / TILE, col = out_col<KIND>(t, e % TILE);
        if (col < N && keep(r)) store_out(y + size_t(row0 + r) * N + col, v);
    });
    if (!is_glu(KIND) || !done) return;
    constexpr int H = TILE / 2;
    __syncthreads();
    for (int e = threadIdx.x; e < rows * H; e += blockDim.x) {
        const int r = e / H, c = e % H, col = t * H + c;
        if (col < N && keep(r))
            store_out(y + size_t(row0 + r) * N + col,
                      glu::glu_combine(part[r * TILE + c], part[r * TILE + H + c], act));
    }
}

// ---- split-K CUDA-core path ------------------------------------------------

constexpr int SK_TX = 8;    // threads along N (16 columns each: 128 bytes of a row)
constexpr int SK_TY = 8;    // threads along K
constexpr int SK_THREADS = SK_TX * SK_TY;
static_assert(16 * SK_TX == TILE, "a split-K block reads one tile's columns");

// Packed rows per unit of a split-K slice: a whole group (16 or 32 packed
// rows), two groups of 8 (q4 group 16), or 32 rows of a longer group (q8
// group 256); the chunks of 16 rows a block loads never straddle a unit.
__host__ __device__ constexpr int sk_unit_rows(int rows_g) {
    return rows_g < 16 ? 16 : rows_g > 32 ? 32 : rows_g;
}

template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* p, int nvalid) {
    if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < 16; ++c)
        if (c < nvalid) w[c / 4] |= uint32_t(__ldg(p + c)) << (8 * (c % 4));
    return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool VEC>
__device__ __forceinline__ void load_panel16(const float* p, int nvalid, float (&out)[16]) {
    if (VEC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
            out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
        }
        return;
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) out[c] = c < nvalid ? __ldg(p + c) : 0.0f;
}

template <bool VEC>
__device__ __forceinline__ void load_panel16(const bf16* p, int nvalid, float (&out)[16]) {
    if (VEC) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
                const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[h]);
                out[8 * i + 2 * h] = __low2float(b);
                out[8 * i + 2 * h + 1] = __high2float(b);
            }
        }
        return;
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) out[c] = c < nvalid ? __bfloat162float(__ldg(p + c)) : 0.0f;
}

// Byte c of w as a float, exactly: the byte becomes the low byte of the
// float 2^23 + byte (one byte permute), from which `bias` (2^23, or 2^23 +
// 128 for a signed byte whose sign bit the caller flipped) is subtracted.
// Two full-rate instructions where an integer-to-float conversion runs at a
// quarter of the rate.
__device__ __forceinline__ float byte_f32(uint32_t w, int c, float bias) {
    return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | uint32_t(c))) - bias;
}

// Grid: (splits, B, column tiles: ceil(N/128), the GLU ceil(N/64)): one row
// per block; ws/counters: see split_sum. KIND_PLAIN, KIND_GLU (act) or
// KIND_SLOT: W is a stack of E experts ([E, K/2 | K, N], panels [E,
// K/group, N]) and row r reads expert eg[r]; an id outside [0, E) reads
// nothing, and slice 0 writes the row's NaN.
template <int FMT, int LAY, bool VEC, class SP, class OT, int KIND>
__global__ void __launch_bounds__(SK_THREADS, 8)
qgemm_splitk(const float* __restrict__ x, const uint8_t* __restrict__ packed,
             const SP* __restrict__ scales, const SP* __restrict__ mins, OT* __restrict__ y,
             float* __restrict__ ws, int* __restrict__ counters, const int* __restrict__ eg,
             int B, int K, int N, int group, int splits, int act, int E) {
    static_assert(!is_gathered(KIND), "the grouped products run on the tensor cores");
    const int tid = threadIdx.x, tx = tid % SK_TX, ty = tid / SK_TX;
    const int ldw = row_stride<KIND>(N);
    const int col = weight_col<KIND>(blockIdx.z, tx * 16, N);
    const int nvalid = N - out_col<KIND>(blockIdx.z, tx * 16);
    const int row = blockIdx.y;
    const float* xr = x + size_t(row) * K;
    if constexpr ((KIND & KIND_SLOT) != 0) {
        // the whole block (every slice of the row) leaves before the
        // workspace and the tile's counter are touched
        const int e = __ldg(eg + row);
        if (e < 0 || e >= E) {
            if (blockIdx.x == 0)
                for (int c = tid; c < TILE; c += SK_THREADS) {
                    const int oc = out_col<KIND>(blockIdx.z, c);
                    if (oc < N) store_out(y + size_t(row) * N + oc, __int_as_float(0x7fffffff));
                }
            return;
        }
        const size_t sstride = size_t(K / group) * N;
        packed += size_t(e) * (FMT == FMT_Q4 ? K / 2 : K) * N;
        scales += size_t(e) * sstride;
        if (mins != nullptr) mins += size_t(e) * sstride;
    }

    constexpr int SK_JC = 16;  // packed rows per chunk: 16-byte loads in flight
    const int rows_g = FMT == FMT_Q4 ? group / 2 : group;  // packed rows per group
    // a chunk holds two groups of 8 packed rows (q4 group 16), or lies
    // inside one group; a slice holds whole units of sk_unit_rows
    constexpr bool two = LAY == LAY_G16;
    const int cpu = sk_unit_rows(rows_g) / SK_JC;  // chunks per unit
    const int units = (FMT == FMT_Q4 ? K / 2 : K) / sk_unit_rows(rows_g);
    const int cb = int((long long)blockIdx.x * units / splits) * cpu;
    const int ce = int((long long)(blockIdx.x + 1) * units / splits) * cpu;
    const bool has_mins = mins != nullptr;

    float acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = 0.0f;
    // acc += s[g] * qd - m[g] * xs: one group's part of a chunk
    auto fold = [&](int g, const float (&qd)[16], float xs) {
        float sc[16];
        load_panel16<VEC>(scales + size_t(g) * ldw + col, nvalid, sc);
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[c] = fmaf(sc[c], qd[c], acc[c]);
        if (has_mins) {
            float mn[16];
            load_panel16<VEC>(mins + size_t(g) * ldw + col, nvalid, mn);
#pragma unroll
            for (int c = 0; c < 16; ++c) acc[c] = fmaf(-mn[c], xs, acc[c]);
        }
    };

    if (nvalid > 0) {
        for (int ch = cb + ty; ch < ce; ch += SK_TY) {
            const int pr0 = ch * SK_JC;  // the chunk's first packed row
            const int g = pr0 / rows_g;
            const uint8_t* prow = packed + size_t(pr0) * ldw + col;
            uint4 wv[SK_JC];
#pragma unroll
            for (int j = 0; j < SK_JC; ++j) wv[j] = load16<VEC>(prow + size_t(j) * ldw, nvalid);
            float qd[16], xs = 0.0f;
#pragma unroll
            for (int c = 0; c < 16; ++c) qd[c] = 0.0f;
            const int k0 = g * group + pr0 % rows_g;
#pragma unroll
            for (int j = 0; j < SK_JC; ++j) {
                const uint32_t wd[4] = {wv[j].x, wv[j].y, wv[j].z, wv[j].w};
                // q4 group 16: rows 8-15 are the next group's, 16 elements on
                const int kj = k0 + j + (two && j >= SK_JC / 2 ? SK_JC / 2 : 0);
                const float xlo = __ldg(xr + kj);
                const float xhi = FMT == FMT_Q4 ? __ldg(xr + kj + group / 2) : 0.0f;
                xs += xlo + xhi;
#pragma unroll
                for (int w4 = 0; w4 < 4; ++w4) {
                    if (FMT == FMT_Q4) {
                        const uint32_t lo = wd[w4] & 0x0F0F0F0Fu, hi = (wd[w4] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            const float ql = byte_f32(lo, c, 8388608.0f);
                            const float qh = byte_f32(hi, c, 8388608.0f);
                            qd[4 * w4 + c] = fmaf(xhi, qh, fmaf(xlo, ql, qd[4 * w4 + c]));
                        }
                    } else {
                        const uint32_t u = wd[w4] ^ 0x80808080u;  // int8 -> q + 128
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            qd[4 * w4 + c] = fmaf(xlo, byte_f32(u, c, 8388736.0f), qd[4 * w4 + c]);
                    }
                }
                if (two && j == SK_JC / 2 - 1) {  // the first group of the chunk ends
                    fold(g, qd, xs);
                    xs = 0.0f;
#pragma unroll
                    for (int c = 0; c < 16; ++c) qd[c] = 0.0f;
                }
            }
            fold(two ? g + 1 : g, qd, xs);
        }
    }

    // the SK_TY partials of each column, summed in a fixed order
    __shared__ float red[SK_TY][TILE];
    __shared__ __align__(16) float part[TILE];
#pragma unroll
    for (int c = 0; c < 16; ++c) red[ty][tx * 16 + c] = acc[c];
    __syncthreads();
    for (int e = tid; e < TILE; e += SK_THREADS) {
        float t = 0.0f;
#pragma unroll
        for (int k = 0; k < SK_TY; ++k) t += red[k][e];
        part[e] = t;
    }
    __syncthreads();
    finish<KIND>(part, 1, ws, counters, splits, y, row, N, act, [](int) { return true; });
}

// ---- tensor-core path ------------------------------------------------------

constexpr int TC_THREADS = 128;         // 4 warps side by side along N, 32 columns each
constexpr int TC_KS = 32;               // K elements per stage: 2, 1 or 1/8 scale group
constexpr int TC_XSTRIDE = TC_KS + 8;   // floats per staged x row (conflict-free reads)
constexpr int TC_WSTRIDE = TILE + 32;   // bytes per staged packed row (conflict-free reads)
static_assert(TC_THREADS == TILE, "the 4 warps cover one tile's columns");

template <int FMT, int MT, class SP, class OT>
struct Tc {
    static constexpr int BM = 16 * MT;
    static constexpr int WROWS = FMT == FMT_Q4 ? TC_KS / 2 : TC_KS;  // packed rows per stage
    static constexpr int X_BYTES = BM * TC_XSTRIDE * 4;
    static constexpr int W_BYTES = WROWS * TC_WSTRIDE;
    static constexpr int P_BYTES = TILE * int(sizeof(SP));  // one panel row
    static constexpr int STAGE = X_BYTES + W_BYTES + 4 * P_BYTES;  // scales, mins: <= 2 rows each
    static constexpr int NSTAGE = MT == 1 ? 6 : MT == 2 ? 5 : 4;
    static constexpr int RING = NSTAGE * STAGE > BM * TILE * 4 ? NSTAGE * STAGE : BM * TILE * 4;
    static constexpr int PASSES = std::is_same<OT, bf16>::value ? 2 : 3;
    static constexpr int PARTS = PASSES * 2 * BM * 16;  // bf16 [pass][kstep][BM][16], per buffer
    static constexpr int SMEM = RING + 2 * PARTS * 2 + 2 * 2 * BM * 4;
};

// Grid: (splits, ceil(B/BM), column tiles: ceil(N/128), the GLU
// ceil(N/64)); ws/counters: see split_sum; dynamic shared memory Tc::SMEM.
// q4: group 16 or 32; q8: group 16, 32, or 256 without min panels (Q8_K); K % 32 == 0, N % 16 == 0 and 16-byte
// aligned tensors (the plan sees to them). GLU: act. KIND_GATHERED: B = G *
// crows rows of the blocked layout, rows [B] slot ids (S: padding), eg [G]
// expert ids, E experts in the stacks, BM dividing crows; with KIND_GLU the
// up columns come from the second stack (packed2, scales2, mins2), which
// has the first's layout.
template <int FMT, int LAY, int MT, class SP, class OT, int KIND>
__global__ void __launch_bounds__(TC_THREADS)
qgemm_tc(const float* __restrict__ x, const uint8_t* __restrict__ packed,
         const SP* __restrict__ scales, const SP* __restrict__ mins,
         const uint8_t* __restrict__ packed2, const SP* __restrict__ scales2,
         const SP* __restrict__ mins2, OT* __restrict__ y,
         float* __restrict__ ws, int* __restrict__ counters,
         const int* __restrict__ rows, const int* __restrict__ eg,
         int B, int K, int N, int group, int splits, int act, int crows, int S, int E) {
    static_assert((KIND & KIND_SLOT) == 0, "the per-slot product runs on split-K");
    using C = Tc<FMT, MT, SP, OT>;
    constexpr int BM = C::BM;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* parts_buf = reinterpret_cast<bf16*>(smem + C::RING);            // [2][PARTS]
    float* xsum_buf = reinterpret_cast<float*>(smem + C::RING + 4 * C::PARTS);  // [2][2][BM]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int row0 = blockIdx.y * BM, t = blockIdx.z;
    const int ldw = row_stride<KIND>(N);
    if constexpr (is_gathered(KIND)) {
        // padding only: every slice exits before any barrier, and the
        // tile's counter is never touched
        if (__ldg(rows + row0) >= S) return;
        const int e = __ldg(eg + row0 / crows);
        if (e < 0 || e >= E) {  // reads nothing; slice 0 writes NaN
            constexpr int OC = is_glu(KIND) ? TILE / 2 : TILE;  // output columns
            if (blockIdx.x == 0)
                for (int i = tid; i < BM * OC; i += TC_THREADS) {
                    const int r = i / OC, col = t * OC + i % OC;
                    if (col < N && __ldg(rows + row0 + r) < S)
                        store_out(y + size_t(row0 + r) * N + col, __int_as_float(0x7fffffff));
                }
            return;
        }
        const size_t pstride = size_t(FMT == FMT_Q4 ? K / 2 : K) * N;
        const size_t sstride = size_t(K / group) * N;
        packed += size_t(e) * pstride;
        scales += size_t(e) * sstride;
        if (mins != nullptr) mins += size_t(e) * sstride;
        if constexpr (two_stacks(KIND)) {
            packed2 += size_t(e) * pstride;
            scales2 += size_t(e) * sstride;
            if (mins2 != nullptr) mins2 += size_t(e) * sstride;
        }
    }
    constexpr bool g16 = LAY == LAY_G16;  // a k16 step is one group
    constexpr bool longg = LAY == LAY_LONG;
    const int nst = K / TC_KS;
    int sb = int((long long)blockIdx.x * nst / splits);
    int n_it = int((long long)(blockIdx.x + 1) * nst / splits) - sb;
    const int gps = longg ? 1 : TC_KS / group;  // scale groups per stage: 1 or 2
    // LAY_LONG: a group spans spg stages (a power of two: 8 at group 256),
    // and a slice holds whole groups
    const int spg = longg ? group / TC_KS : 1;
    const int spg_shift = longg ? __ffs(spg) - 1 : 0;
    if constexpr (longg) {
        sb = int((long long)blockIdx.x * (nst / spg) / splits) * spg;
        n_it = int((long long)(blockIdx.x + 1) * (nst / spg) / splits) * spg - sb;
    }
    const bool has_mins = mins != nullptr;

    // This thread's cp.async chunks, fixed for the whole loop: MT chunks of
    // x (16 bytes each), WROWS / 16 of the packed bytes, <= 1 of the panels.
    // Global offsets are those of stage 0 of the slice; stage s adds s times
    // the stage stride.
    size_t x_src[MT];
    int x_dst[MT];
    bool x_ok[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const int c = tid + TC_THREADS * i, r = c / 8, q = c % 8;
        int row = row0 + r;
        if constexpr (is_gathered(KIND)) {  // row r is slot rows[row0 + r]
            row = __ldg(rows + row0 + r);
            x_ok[i] = row < S;
        } else {
            x_ok[i] = row < B;
        }
        x_src[i] = size_t(x_ok[i] ? row : 0) * K + size_t(sb) * TC_KS + 4 * q;
        x_dst[i] = r * TC_XSTRIDE * 4 + 16 * q;
    }
    constexpr int WCH = C::WROWS / 16;
    size_t w_src[WCH];
    int w_dst[WCH];
    bool w_ok;
    const uint8_t* w_base;  // the stack this thread's 16 columns lie in
    {
        const int q = tid % 8;
        w_ok = out_col<KIND>(t, 16 * q) < N;
        w_base = in_up<KIND>(16 * q) ? packed2 : packed;
        const int col = weight_col<KIND>(t, 16 * q, N);
#pragma unroll
        for (int i = 0; i < WCH; ++i) {
            const int r = tid / 8 + 16 * i;
            w_src[i] = (size_t(sb) * C::WROWS + r) * ldw + (w_ok ? col : 0);
            w_dst[i] = C::X_BYTES + r * TC_WSTRIDE + 16 * q;
        }
    }
    constexpr int PE = 16 / int(sizeof(SP));  // panel values per chunk
    constexpr int PC = TILE / PE;             // chunks per panel row
    const int p_which = tid / PC;             // 0, 1: scale rows; 2, 3: min rows
    const bool p_col_ok = out_col<KIND>(t, PE * (tid % PC)) < N;
    const int p_col = weight_col<KIND>(t, PE * (tid % PC), N);
    const bool p_ok = p_which < 2 * (has_mins ? 2 : 1) && (p_which & 1) < gps && tid < 4 * PC;
    const SP* p_base = in_up<KIND>(PE * (tid % PC)) ? (p_which < 2 ? scales2 : mins2)
                                                     : (p_which < 2 ? scales : mins);
    // the slice's first panel row: its first stage's group (and at group 16
    // the next); LAY_LONG: the group of sb
    const size_t p_src = (longg ? size_t(sb >> spg_shift) : size_t(sb) * gps + (p_which & 1)) * ldw +
                         (p_col_ok ? p_col : 0);
    const int p_dst = C::X_BYTES + C::W_BYTES + p_which * C::P_BYTES + 16 * (tid % PC);

    auto load_stage = [&](int it) {
        unsigned char* st = smem + (it % C::NSTAGE) * C::STAGE;
#pragma unroll
        for (int i = 0; i < MT; ++i)
            cp_async16(st + x_dst[i], x + x_src[i] + size_t(it) * TC_KS, x_ok[i]);
#pragma unroll
        for (int i = 0; i < WCH; ++i)
            cp_async16(st + w_dst[i], w_base + w_src[i] + size_t(it) * C::WROWS * ldw, w_ok);
        if (p_ok)
            cp_async16(st + p_dst,
                       p_base + p_src + (longg ? size_t(it >> spg_shift) : size_t(it) * gps) * ldw,
                       p_col_ok);
    };

    // x of one stage -> parts[pass][kstep][row][pos] and the group sums
    // xsum[group][row]. pos permutes a k16 step's 16 offsets p so that a
    // thread's fragment values (p = t, t+4, t+8, t+12) lie side by side:
    // pos = 4 (p % 4) + p / 4; so p and p + 4 (p % 8 < 4) share one 32-bit
    // word, and each conversion rounds such a pair at once.
    auto split_x = [&](int it) {
        const float* xs = reinterpret_cast<const float*>(smem + (it % C::NSTAGE) * C::STAGE);
        uint32_t* parts = reinterpret_cast<uint32_t*>(parts_buf + (it & 1) * C::PARTS);
        float* xsum = xsum_buf + (it & 1) * 2 * BM;
        constexpr int TPR = TC_THREADS / BM;  // threads per row
        const int r = tid / TPR, sub = tid % TPR;
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int pi = sub; pi < TC_KS / 8; pi += TPR) {  // p = 8 pi + i and 8 pi + i + 4
            const float4 va = *reinterpret_cast<const float4*>(xs + r * TC_XSTRIDE + 8 * pi);
            const float4 vb = *reinterpret_cast<const float4*>(xs + r * TC_XSTRIDE + 8 * pi + 4);
            const float ea[4] = {va.x, va.y, va.z, va.w}, eb[4] = {vb.x, vb.y, vb.z, vb.w};
            const int ks = pi >> 1;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int at = ((ks * BM + r) * 16 + 4 * i + 2 * (pi & 1)) / 2;  // in words
                const __nv_bfloat162 hi = __floats2bfloat162_rn(ea[i], eb[i]);
                const float ra = ea[i] - __low2float(hi), rb = eb[i] - __high2float(hi);
                const __nv_bfloat162 mid = __floats2bfloat162_rn(ra, rb);
                parts[at] = *reinterpret_cast<const uint32_t*>(&hi);
                parts[BM * 16 + at] = *reinterpret_cast<const uint32_t*>(&mid);
                if (C::PASSES == 3) {
                    const __nv_bfloat162 lo = __floats2bfloat162_rn(ra - __low2float(mid),
                                                                    rb - __high2float(mid));
                    parts[2 * BM * 16 + at] = *reinterpret_cast<const uint32_t*>(&lo);
                }
                sum[ks] += ea[i] + eb[i];
            }
        }
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) {
            sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], o);
            sum[1] += __shfl_xor_sync(0xffffffffu, sum[1], o);
        }
        if (sub == 0) {
            if (gps == 2) {
                xsum[r] = sum[0];
                xsum[BM + r] = sum[1];
            } else {
                xsum[r] = sum[0] + sum[1];
            }
        }
    };

    float acc[MT][4][4], cg_[MT][4][4];  // the sum; one group's product
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
    // LAY_LONG: C_g carries across a group's stages (no min panels: the
    // launcher refuses them)

#pragma unroll
    for (int s = 0; s < C::NSTAGE - 1; ++s) {
        if (s < n_it) load_stage(s);
        cp_async_commit();
    }
    cp_async_wait<C::NSTAGE - 2>();
    __syncthreads();
    if (n_it > 0) split_x(0);

    const int wc = warp * 32;  // the warp's first column in the tile
    for (int it = 0; it < n_it; ++it) {
        // stage it + 1 landed; parts[it & 1] complete; every warp is done
        // with it - 1, so its ring slot and parts buffer are free
        cp_async_wait<C::NSTAGE - 3>();
        __syncthreads();
        if (it + C::NSTAGE - 1 < n_it) load_stage(it + C::NSTAGE - 1);
        cp_async_commit();
        if (it + 1 < n_it) split_x(it + 1);

        const unsigned char* ws_ = smem + (it % C::NSTAGE) * C::STAGE + C::X_BYTES;
        const SP* ss = reinterpret_cast<const SP*>(ws_ + C::W_BYTES);
        const SP* ms = ss + 2 * TILE;
        const bf16* parts = parts_buf + (it & 1) * C::PARTS;
        const float* xsum = xsum_buf + (it & 1) * 2 * BM;
        // LAY_LONG: the stage's place in its group (sb % spg == 0)
        const int gstage = longg ? it & (spg - 1) : 0;

#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            // B fragments of the four n8 tiles: tile j, fragment column g8
            // is the warp's column 4 g8 + j; rows t4 + 4i of the step (q4:
            // low nibbles for step 0, high nibbles for step 1). At q4 group
            // 16 step ks is group ks: rows 8 ks + t4 and 8 ks + t4 + 4 give
            // the step's offsets t4, t4 + 4 (low nibbles) and t4 + 8, t4 +
            // 12 (high nibbles).
            const int wrow = FMT == FMT_Q4 ? (g16 ? 8 * ks : 0) : 16 * ks;
            uint32_t w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (!g16 || i < 2)
                    w[i] = *reinterpret_cast<const uint32_t*>(ws_ + (wrow + t4 + 4 * i) * TC_WSTRIDE + wc + 4 * g8);
            uint32_t b[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (FMT == FMT_Q4) {
                    const uint32_t sel = uint32_t(j) | uint32_t(j) << 4 | uint32_t(4 + j) << 8 | uint32_t(4 + j) << 12;
                    if constexpr (g16) {
                        const uint32_t v = __byte_perm(w[0], w[1], sel);
                        b[j][0] = nibbles_bf16x2(v);
                        b[j][1] = nibbles_bf16x2(v >> 4);
                    } else {
                        b[j][0] = nibbles_bf16x2(__byte_perm(w[0], w[1], sel) >> (4 * ks));
                        b[j][1] = nibbles_bf16x2(__byte_perm(w[2], w[3], sel) >> (4 * ks));
                    }
                } else {
                    b[j][0] = int8_pair_bf16x2(w[0], w[1], j);
                    b[j][1] = int8_pair_bf16x2(w[2], w[3], j);
                }
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
#pragma unroll
                for (int pass = C::PASSES - 1; pass >= 0; --pass) {  // smallest part first
                    const bf16* pa = parts + ((pass * 2 + ks) * BM + 16 * m + g8) * 16 + 4 * t4;
                    const uint2 r0 = *reinterpret_cast<const uint2*>(pa);           // row g8
                    const uint2 r8 = *reinterpret_cast<const uint2*>(pa + 8 * 16);  // row g8 + 8
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        if (pass == C::PASSES - 1 && (gps == 2 || ks == 0) && gstage == 0)  // a group's first product
                            mma_bf16_first(cg_[m][j], r0.x, r8.x, r0.y, r8.y, b[j][0], b[j][1]);
                        else
                            mma_bf16(cg_[m][j], r0.x, r8.x, r0.y, r8.y, b[j][0], b[j][1]);
                    }
                }
            }
            // a group ends: acc += s * C_g - m * xs_g; this thread's
            // columns are wc + 8 t4 + q
            if ((gps == 2 || ks == 1) && gstage == spg - 1) {
                const int gi = gps == 2 ? ks : 0;
                float sc[8];
                load8(ss + gi * TILE + wc + 8 * t4, sc);
#pragma unroll
                for (int m = 0; m < MT; ++m)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            acc[m][j][e] = fmaf(sc[j + 4 * (e & 1)], cg_[m][j][e], acc[m][j][e]);
                if (!longg && has_mins) {
                    float mn[8];
                    load8(ms + gi * TILE + wc + 8 * t4, mn);
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                        const float x0 = xsum[gi * BM + 16 * m + g8];
                        const float x1 = xsum[gi * BM + 16 * m + g8 + 8];
#pragma unroll
                        for (int j = 0; j < 4; ++j)
#pragma unroll
                            for (int e = 0; e < 4; ++e)
                                acc[m][j][e] = fmaf(-mn[j + 4 * (e & 1)], e < 2 ? x0 : x1, acc[m][j][e]);
                    }
                }
            }
        }
    }

    // the block's partial tile -> shared memory -> the fixed-order sum
    cp_async_wait<0>();
    __syncthreads();
    float* part = reinterpret_cast<float*>(smem);  // [BM][TILE], over the ring
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                part[(16 * m + g8 + 8 * (e >> 1)) * TILE + wc + 8 * t4 + j + 4 * (e & 1)] = acc[m][j][e];
    __syncthreads();
    finish<KIND>(part, BM, ws, counters, splits, y, row0, N, act, [&](int r) {
        if constexpr (is_gathered(KIND))
            return __ldg(rows + row0 + r) < S;
        else
            return row0 + r < B;
    });
}

// ---- launches --------------------------------------------------------------

// Raise a kernel's dynamic shared memory limit once per device (the call
// costs host time on every launch otherwise). Devices 0..63.
template <auto Kern>
cudaError_t allow_smem(int smem) {
    static unsigned long long done = 0;  // one bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || smem <= 48 * 1024 || (done >> dev & 1ull)) return e;
    e = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) done |= 1ull << dev;
    return e;
}

template <class... KArgs, class... Args>
int launch(void (*kern)(KArgs...), dim3 grid, int threads, int smem, cudaStream_t stream,
           Args... args) {
    kern<<<grid, threads, smem, stream>>>(args...);
    return int(cudaGetLastError());
}

struct Call {
    const float* x;
    const uint8_t* packed;
    const void* scales;
    const void* mins;
    const uint8_t* packed2;  // kernel 6's up stack
    const void* scales2;
    const void* mins2;
    void* y;
    float* ws;
    int* counters;
    const int* rows;
    const int* eg;
    int B, K, N, group, tile, splits, vec, act, crows, S, E;
    cudaStream_t stream;
};

// Column tiles of the grid: TILE output columns, the GLU's TILE / 2.
template <int KIND>
int col_tiles(int N) {
    constexpr int OC = is_glu(KIND) ? TILE / 2 : TILE;
    return (N + OC - 1) / OC;
}

template <int FMT, int LAY, bool VEC, class SP, class OT, int KIND>
int splitk(const Call& c) {
    const dim3 grid(c.splits, c.B, col_tiles<KIND>(c.N));
    return launch(qgemm_splitk<FMT, LAY, VEC, SP, OT, KIND>, grid, SK_THREADS, 0, c.stream,
                  c.x, c.packed, static_cast<const SP*>(c.scales), static_cast<const SP*>(c.mins),
                  static_cast<OT*>(c.y), c.ws, c.counters, c.eg, c.B, c.K, c.N, c.group,
                  c.splits, c.act, c.E);
}

template <int FMT, int LAY, int MT, class SP, class OT, int KIND>
int tc_mt(const Call& c) {
    using T = Tc<FMT, MT, SP, OT>;
    const cudaError_t e = allow_smem<qgemm_tc<FMT, LAY, MT, SP, OT, KIND>>(T::SMEM);
    if (e != cudaSuccess) return int(e);
    const dim3 grid(c.splits, (c.B + T::BM - 1) / T::BM, col_tiles<KIND>(c.N));
    return launch(qgemm_tc<FMT, LAY, MT, SP, OT, KIND>, grid, TC_THREADS, T::SMEM, c.stream,
                  c.x, c.packed, static_cast<const SP*>(c.scales), static_cast<const SP*>(c.mins),
                  c.packed2, static_cast<const SP*>(c.scales2),
                  static_cast<const SP*>(c.mins2), static_cast<OT*>(c.y), c.ws, c.counters,
                  c.rows, c.eg, c.B, c.K, c.N, c.group, c.splits, c.act, c.crows, c.S, c.E);
}

template <int FMT, int LAY, class SP, class OT, int KIND>
int dispatch(const Call& c, int path) {
    if (path == 1) {
        if constexpr ((KIND & KIND_SLOT) != 0) {
            return int(cudaErrorInvalidValue);
        } else {
            switch (c.tile) {
            case 1: return tc_mt<FMT, LAY, 1, SP, OT, KIND>(c);
            case 2: return tc_mt<FMT, LAY, 2, SP, OT, KIND>(c);
            case 4: return tc_mt<FMT, LAY, 4, SP, OT, KIND>(c);
            default: return int(cudaErrorInvalidValue);
            }
        }
    }
    if constexpr (is_gathered(KIND) || LAY == LAY_LONG) {  // split-K: LAY_STD serves both
        return int(cudaErrorInvalidValue);
    } else {
        if (c.tile != 1) return int(cudaErrorInvalidValue);
        return c.vec ? splitk<FMT, LAY, true, SP, OT, KIND>(c)
                     : splitk<FMT, LAY, false, SP, OT, KIND>(c);
    }
}

// The layout class of the call: q4 group 16 (both paths), q8 groups longer
// than a stage (tensor cores; split-K folds them per chunk as any other).
template <class SP, class OT, int KIND>
int dispatch_fmt(const Call& c, int fmt, int path) {
    if (fmt == FMT_Q4)
        return c.group == 16 ? dispatch<FMT_Q4, LAY_G16, SP, OT, KIND>(c, path)
                             : dispatch<FMT_Q4, LAY_STD, SP, OT, KIND>(c, path);
    return c.group > TC_KS && path == 1 ? dispatch<FMT_Q8, LAY_LONG, SP, OT, KIND>(c, path)
                                        : dispatch<FMT_Q8, LAY_STD, SP, OT, KIND>(c, path);
}

template <class SP, class OT>
int dispatch_kind(const Call& c, int fmt, int path) {
    if (c.eg != nullptr) {  // an expert stack: f32 panels only, as the loader keeps them
        if constexpr (std::is_same<SP, float>::value) {
            if (c.rows == nullptr) return dispatch_fmt<SP, OT, KIND_SLOT>(c, fmt, path);
            return c.act >= 0 ? dispatch_fmt<SP, OT, KIND_GATHERED | KIND_GLU>(c, fmt, path)
                              : dispatch_fmt<SP, OT, KIND_GATHERED>(c, fmt, path);
        }
        return int(cudaErrorInvalidValue);
    }
    return c.act >= 0 ? dispatch_fmt<SP, OT, KIND_GLU>(c, fmt, path)
                      : dispatch_fmt<SP, OT, KIND_PLAIN>(c, fmt, path);
}

}  // namespace

// y = x @ W, one launch. fmt: 0 = q4, 1 = q8; mins may be null.
// panel_bf16 / out_bf16: scales and mins / y are bfloat16 (else float32).
// What is computed:
//   * act = -1, rows = eg = null (kernels 1-2): y[B, N] = x[B, K] @ W[K, N];
//   * act = 0..4 (the GLU, kernel 3; 0 silu, 1 gelu (tanh), 2 relu,
//     3 relu2, 4 swiglu_oai): W is the fused [K, 2N] gate|up weight and
//     y[B, N] = act(x @ W[:, :N]) * (x @ W[:, N:]);
//   * eg non-null: W is a stack of E experts ([E, K/2 | K, N], panels
//     [E, K/group, N], f32 panels); an expert id outside [0, E) writes NaN:
//     - rows null (the per-slot MoE product, kernel 4; act = -1, split-K):
//       y[s] = x[s] @ W[eg[s]] for the B slots;
//     - rows non-null (the grouped MoE products, tensor cores): B = G *
//       crows rows of the blocked layout, row r reads x[rows[r]] and
//       expert eg[r / crows] and is written where rows[r] < S. Kernel 5
//       (act = -1): y[B, N] = x[rows] @ W[eg]; kernel 6 (act = 0..4, the
//       up stack in packed2, scales2, mins2, of W's layout): y[B, N] =
//       act(x[rows] @ W[eg]) * (x[rows] @ W2[eg]).
// A block reads 128 weight columns. path 0 = split-K (tile = rows per
// block: 1; vec = 1 when N % 16 == 0 and every tensor is 16-byte aligned),
// path 1 = tensor cores (tile = MT, 16-row tiles per block: 1, 2 or 4;
// needs vec, q4 group 16 or 32, q8 group 16, 32, or 256 without min
// panels).
// splits:
// 1..32 K slices of whole groups (split-K: of sk_unit_rows packed rows).
// With splits > 1, ws holds tiles x splits x (rows x 128) floats and
// counters one int per output tile, all 0 (the kernel leaves them 0
// again); tiles = ceil(B / rows) x column tiles (ceil(N / 128), the
// GLU ceil(N / 64)), as ops/qmatmul.py's plans give them.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int qgemm_launch(const float* x, const void* packed, const void* scales,
                            const void* mins, const void* packed2, const void* scales2,
                            const void* mins2, void* y, float* ws, int* counters,
                            const int* rows, const int* eg,
                            int B, int K, int N, int group, int fmt,
                            int panel_bf16, int out_bf16, int path, int tile, int splits, int vec, int act, int crows, int S, int E,
                            void* stream) {
    const int rows_g = fmt == FMT_Q4 ? group / 2 : group;
    const int prows = fmt == FMT_Q4 ? K / 2 : K;
    if (splits < 1 || splits > 32 || group % 16 != 0 || K % group != 0 ||
        (rows_g % 16 != 0 && rows_g != 8) || prows % sk_unit_rows(rows_g) != 0 || act < -1 ||
        act > 4)
        return int(cudaErrorInvalidValue);
    if (path == 0 && splits > prows / sk_unit_rows(rows_g)) return int(cudaErrorInvalidValue);
    if (path == 1 && (!vec || K % TC_KS != 0 || splits > K / (group > TC_KS ? group : TC_KS) ||
                      (fmt == FMT_Q4 ? group != 16 && group != 32
                                     : group != 16 && group != 32 && (group != 256 || mins != nullptr))))
        return int(cudaErrorInvalidValue);
    if ((rows != nullptr && eg == nullptr) || (eg != nullptr && (panel_bf16 || E < 1)) ||
        (rows != nullptr && (path != 1 || S < 0 || crows < 16 * tile ||
                             crows % (16 * tile) != 0 || B % crows != 0)) ||
        (eg != nullptr && rows == nullptr && (path != 0 || act != -1)))
        return int(cudaErrorInvalidValue);
    // the up stack: kernel 6's alone, with the gate stack's min panels or none
    const bool up = rows != nullptr && act >= 0;
    if (up != (packed2 != nullptr) || up != (scales2 != nullptr) ||
        (mins2 != nullptr) != (up && mins != nullptr))
        return int(cudaErrorInvalidValue);
    if (splits > 1 && (ws == nullptr || counters == nullptr)) return int(cudaErrorInvalidValue);
    const Call c{x, static_cast<const uint8_t*>(packed), scales, mins,
                 static_cast<const uint8_t*>(packed2), scales2, mins2, y, ws, counters,
                 rows, eg, B, K, N, group, tile, splits, vec, act, crows, S, E,
                 static_cast<cudaStream_t>(stream)};
    if (panel_bf16)
        return out_bf16 ? dispatch_kind<bf16, bf16>(c, fmt, path) : dispatch_kind<bf16, float>(c, fmt, path);
    return out_bf16 ? dispatch_kind<float, bf16>(c, fmt, path) : dispatch_kind<float, float>(c, fmt, path);
}
