// Dequant-matmul variants for Hopper (sm_90a): the decode-shape probe of the
// q4/q8 kernels, each variant changing one piece of the dequant chain, so that
// their times on this card say where a decode GEMV's time goes.
//
// Replaces the Pallas kernels built by the pallas() helper of
// scripts/bench_kernel_variants.py:124-131, with the bodies
//   v2_noscale  :282-289  y = x @ q                      (variant_f32)
//   v5_minfold  :159-188  y = x @ (s*q) - xg^T @ m       (variant_f32)
//   v6_bf16     :190-218  v5 with w = bf16(q*s), x and xg rounded to bf16
//                                                        (variant_bf16)
//   v7_int8     :220-247  y = xi @ q, int8 x             (variant_int8)
//   v9_mulcost  :397-410  y = xi @ wrap8(q*u)            (variant_int8, q4)
//   v10_4dot    :412-427  y = sum (x_lo+x_hi)(lo+hi)     (variant_int8, q4)
//   v8_w4a8     :311-387  y = S * [sum_g u * (xi @ q)_g - xg2^T @ m2]
//                                                        (variant_w4a8, q4)
// v0_full and v1_nomin of the probe are the production kernels 1-2 of
// csrc/qgemm.cu with bf16 panels in "default" precision, not kernels here.
//
// Layouts as csrc/qdot.cuh: q4 packed uint8 [K/2, N] group-split (packed row
// r of group g holds element j = r % (group/2) in its low nibble and element
// j + group/2 in its high nibble), q8 int8 [K, N]; panels bfloat16
// [K/group, N]; u int8 [K/group, N]; xg, xg2 float32 [K/group, B] (per-group
// sums of x, computed outside the kernel as in the probe); S float32 [N].
// Each nibble meets its own element of x. Taken: groups of 16 to 1024 that
// are powers of two, K a multiple of max(group, 64);
// ops/qmatmul_variants.check_layout raises on any other layout (the old
// CUDA-core kernel took any group that is a multiple of 16). Why: a stage
// is 64 K elements and must hold whole groups or lie inside one, so that
// its panel rows are whole and no k16 step straddles two groups; a q4
// stage's x is then two runs of 32 elements (the halves of a group its low
// and high nibbles meet), which needs group / 2 to be a multiple of 32 or
// the stage to hold whole groups. Of the multiples of 16 only 16, 32 and
// the multiples of 64 meet that, and the kernel finds a row's group and its
// place in it by shift and mask (lg = log2(group)), which powers of two
// give for free. K is cut into slices of whole stages of whole groups,
// hence a multiple of max(group, 64); a slice's group sums are staged
// whole, so a group is at most a slice, 1024 elements. Every layout of the
// port's formats is among these (power-of-two groups of 16 to 256).
//
// What bounds them on this card: these are decode GEMVs (B = 8 rows), so the
// bytes read once from HBM: at K x N = 4096 x 14336 the q4 packed data plus
// its bf16 scale and min panels are 36.70 MB (11.0 us at 3.35 TB/s), q8
// 66.06 MB (19.7 us); each variant reads a subset or a substitute of these.
// The products are far below them: v5's three bf16 passes at 8 rows are 2.8
// GFLOP, a few us of mma.sync, so mma.sync is enough and wgmma (whose 64-row
// tiles would be 7/8 padding at 8 rows) is not used.
//
// Design. Every variant runs on the tensor cores with W on the 16-row side
// of mma.sync and x's 8 rows on its n8 side (y^T = W^T x^T): eight rows fill
// the n8 tile exactly; more rows take more row tiles (grid y). A block of 4
// warps owns 128 weight columns (32 a warp, two m16 tiles) x 8 rows x one K
// slice of whole scale groups (grid x: ops/qmatmul_variants.variant_plan
// cuts K until the grid holds 3 blocks per SM and no slice is longer than
// 1024 elements). Its packed rows, the panels of their groups and the
// stage's x (two runs of 32 elements for each of the 8 rows: the elements
// its low and its high nibbles meet) stream through a ring of cp.async
// 16-byte stages of 64 K elements (q4: 32 packed rows, 4 KB of weight
// bytes; q8: 64 rows, 8 KB), one barrier a stage: the integer variants
// keep 5 (q4) or 3 (q8) stages in flight a block, the float ones 3 or 2,
// whose smaller rings leave room for more blocks an SM (they are held back
// by the latency of their fragment arithmetic more than by bytes in
// flight; at least 40 KB in flight an SM either way). Each stage's x
// arrives one stage ahead of its weights and is converted once, while the
// stage before it computes, into one of two buffers: int8 as it is, bf16
// for v6, three bf16 parts hi + mid + lo (which add back to x exactly) for
// v2 and v5; each kept in k16 blocks whose 16 elements are
// permuted (pos = 4 (p % 4) + p / 4) so that a thread's B fragment is one
// 32- or 64-bit read, conflict-free. Within a k16 step k is permuted the
// same way on both sides (physical k = t + 4i for a thread's i-th value), so
// each thread reads its weight bytes as whole 32-bit words of 4 packed rows
// 4 apart (row stride 160 bytes: conflict-free), and its 4 columns are
// adjacent (byte j of the word: m16 tile j / 2, fragment row g + 8 (j % 2)).
//   * v2, v5: m16n8k16 bf16, f32 accumulate; q (0..15 or int8) is exact in
//     bf16 (qgemm.cuh's conversions), so the three passes give x * q as f32
//     does; the fold acc += s * C_g - m * xs_g once a group (v2: none). This
//     is qgemm's tensor-core scheme with the operands swapped.
//   * v6: one bf16 pass; the weight fragment is bf16(q * s), made in
//     registers from the packed bytes and the staged scale row by one bf16
//     fma (q4: (128 + q) * s - 128 * s, exact before its one rounding; q8:
//     q * s), so rounded once as the plain version rounds it; the min term
//     -bf16(xg)^T m is added once a group in f32.
//   * v7, v9, v10, v8: m16n8k32 s8 * s8 -> s32. The byte-permute transpose
//     of four packed rows' words gives each A word 4 K-ordered bytes of one
//     column; q4 masks its nibbles (the low nibbles fill one k16 half of the
//     k32 step, the high nibbles the other), q8 takes its bytes as they are.
//     v9 multiplies each nibble by its group's u, wrapped to int8 (mul_wrap8);
//     v10 makes two k32 steps a chunk, the nibbles swapped in the second (its
//     four products a byte: x_lo + x_hi leaves int8, so it is not pre-added);
//     v8 keeps each group's C_g in int32 (at group 16 a k32 step holds two
//     groups: two products, each with the other group's x bytes masked) and
//     folds acc += u * C_g - xs2 * m2 in f32 (an int32 sum over K = 14336
//     could overflow), times S at the store.
// Split-K: each block writes its partial tile to a workspace the wrapper
// keeps per device, and the last block of the tile adds the partials in
// slice order (qgemm::split_sum, for float or int32 partials), so two
// calls give the same bits. v7, v9
// and v10 sum int32 partials (int32 throughout, exact) and convert once at
// the store, so they equal their plain versions bit for bit (v7 q4 at K =
// 14336 reaches 127 * 15 * 14336 > 2^24: two float roundings could differ
// from one). Ragged or unaligned layouts (N % 16 != 0) stage their chunks
// with byte loads and zero fill instead of cp.async; the arithmetic is the
// same.

#include "qgemm.cuh"

#include <type_traits>

namespace {

using namespace qgemm;

constexpr int TILE = 128;          // weight columns per block: 4 warps x 32
constexpr int THREADS = 128;
constexpr int RB = 8;              // x rows per block: the n8 side of mma.sync
constexpr int KS = 64;             // K elements per stage
constexpr int WSTRIDE = TILE + 32; // bytes per staged packed row (conflict-free reads)
constexpr int GPS_MAX = KS / 16;   // panel rows per stage: groups of 16
constexpr int SLICE_MAX = 1024;    // K elements per slice at most: its group sums are staged whole
constexpr int XSUM_BYTES = SLICE_MAX / 16 * RB * 4;  // a slice's group sums
constexpr int XRUN = 32;           // x elements a run: a stage's x is two runs

enum { V_NOSCALE = 0, V_MINFOLD, V_BF16, V_INT8, V_MULCOST, V_4DOT, V_W4A8 };

__host__ __device__ constexpr bool is_int(int mode) { return mode >= V_INT8; }

template <int FMT, int MODE>
struct Cfg {
    static constexpr int WROWS = FMT == FMT_Q4 ? KS / 2 : KS;  // packed rows a stage
    static constexpr int W_BYTES = WROWS * WSTRIDE;
    // panel row bytes: p0 = scales (bf16) or u (int8); p1 = mins or m2 (bf16)
    static constexpr int P0 = MODE == V_MINFOLD || MODE == V_BF16   ? 2 * TILE
                              : MODE == V_MULCOST || MODE == V_W4A8 ? TILE
                                                                    : 0;
    static constexpr int P1 = MODE == V_MINFOLD || MODE == V_BF16 || MODE == V_W4A8 ? 2 * TILE : 0;
    // the stage's x as loaded: [run][row][XRUN], f32 rows padded to 144
    // bytes (conflict-free conversion reads), int8 rows of 32 bytes
    static constexpr int XROW = is_int(MODE) ? XRUN : XRUN * 4 + 16;
    static constexpr int X_RAW = 2 * RB * XROW;
    static constexpr int STAGE = W_BYTES + GPS_MAX * (P0 + P1) + X_RAW;
    // stages in the ring: the float variants are held back by their
    // fragment arithmetic's latency more than by bytes in flight, and take
    // fewer stages for more blocks an SM
    static constexpr int NSTAGE = is_int(MODE) ? (FMT == FMT_Q4 ? 6 : 4) : (FMT == FMT_Q4 ? 4 : 3);
    static constexpr int RING = NSTAGE * STAGE;
    static constexpr int PASSES = MODE == V_BF16 ? 1 : 3;  // bf16 parts of x
    // a stage's x converted: [part][k16 block 0..3][row][16], bf16 or int8
    static constexpr int X_CONV = is_int(MODE) ? 4 * RB * 16 : PASSES * 4 * RB * 32;
    static constexpr int SMEM = RING + XSUM_BYTES + 2 * X_CONV;  // dynamic shared memory
    static_assert(RING >= RB * TILE * 4, "the partial tile lies over the ring");
    static_assert(WROWS * (TILE / 16) % THREADS == 0, "whole weight chunks per thread");
    static_assert(2 * RB * XRUN * (is_int(MODE) ? 1 : 4) / 16 <= THREADS, "one x copy a thread");
};

// 4 bytes global -> shared, asynchronously; !valid fills them with zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0));
}

struct Args {
    const float* x;         // [B, K] (v2, v5, v6)
    const int8_t* xi;       // [B, K] (v7-v10)
    const float* xg;        // [K/group, B]: xg (v5, v6) or xg2 (v8); null without mins
    const uint8_t* packed;
    const void* p0;         // scales (v5, v6) or u (v8, v9)
    const void* p1;         // mins (v5, v6; may be null) or m2 (v8)
    const float* S;         // [N] (v8)
    float* y;               // [B, N]
    float* ws;              // split-K workspace (float or int partials)
    int* counters;
    int B, K, N, lg, splits, vec;  // lg = log2(group)
};

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// Four packed rows' words (4 columns each) -> four words of 4 K-ordered
// bytes, one per column: t[c] byte i = byte c of w[i].
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
    const uint32_t a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t c = __byte_perm(w[0], w[1], 0x7362), d = __byte_perm(w[2], w[3], 0x7362);
    t[0] = __byte_perm(a, b, 0x5410);
    t[1] = __byte_perm(a, b, 0x7632);
    t[2] = __byte_perm(c, d, 0x5410);
    t[3] = __byte_perm(c, d, 0x7632);
}

// Each byte of v (a nibble, 0..15) times uu (the int8 code read as 0..255),
// kept modulo 256: the int8 wrap of the product (v9). Two 16-bit lanes per
// multiply, so no carry crosses a byte.
__device__ __forceinline__ uint32_t mul_wrap8(uint32_t v, uint32_t uu) {
    const uint32_t even = ((v & 0x00FF00FFu) * uu) & 0x00FF00FFu;
    const uint32_t odd = (((v >> 8) & 0x00FF00FFu) * uu) & 0x00FF00FFu;
    return even | (odd << 8);
}

// 16 bytes global -> shared: cp.async where the layout is aligned (every
// chunk then lies wholly inside or wholly outside the N columns), else byte
// loads with zero fill. `valid`: the bytes of the chunk inside the columns;
// `base`: a mapped address for a chunk outside them.
__device__ __forceinline__ void copy16(unsigned char* dst, const unsigned char* src,
                                       const void* base, int valid, bool vec) {
    if (vec) {
        cp_async16(dst, valid > 0 ? static_cast<const void*>(src) : base, valid > 0);
        return;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = i < valid ? __ldg(src + i) : 0;
}

// Grid: (splits, ceil(B/8), ceil(N/128)); dynamic shared memory C::SMEM.
template <int FMT, int MODE>
__global__ void __launch_bounds__(THREADS) variant_tc(const Args a) {
    using C = Cfg<FMT, MODE>;
    using T = typename std::conditional<is_int(MODE) && MODE != V_W4A8, int, float>::type;
    extern __shared__ __align__(16) unsigned char smem[];
    float* xsum = reinterpret_cast<float*>(smem + C::RING);  // [group in slice][RB]
    unsigned char* xconv = smem + C::RING + XSUM_BYTES;       // [2][X_CONV]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int row0 = blockIdx.y * RB, col0 = blockIdx.z * TILE;
    const int lg = a.lg, G = 1 << lg;
    const int lh = FMT == FMT_Q4 ? lg - 1 : lg;  // log2 of the packed rows a group
    const int h = 1 << lh;
    const bool g16 = FMT == FMT_Q4 && G == 16;  // a q4 chunk of 16 packed rows is 2 groups
    const int UK = G > KS ? G : KS;             // K elements per slice unit
    const int units = a.K / UK;
    const int u0 = int((long long)blockIdx.x * units / a.splits);
    const int u1 = int((long long)(blockIdx.x + 1) * units / a.splits);
    const int e0 = u0 * UK;            // the slice's first K element
    const int L = (u1 - u0) * UK;      // its length
    const int n_it = L / KS;
    const int r0 = FMT == FMT_Q4 ? e0 / 2 : e0;  // its first packed row
    const bool has_p1 = a.p1 != nullptr;
    const bool has_xs = (MODE == V_MINFOLD || MODE == V_BF16) ? has_p1 : MODE == V_W4A8;

    // This thread's cp.async chunks: WCH of the packed rows (column chunk
    // wq, rows tid / CPR + THREADS / CPR * i), at most one of the panels.
    constexpr int CPR = TILE / 16;  // 16-byte chunks a packed row
    constexpr int WCH = C::WROWS * CPR / THREADS;
    const int wq = tid % CPR;
    const int w_valid = a.N - (col0 + 16 * wq);
    const uint8_t* w_src = a.packed + size_t(r0) * a.N + col0 + 16 * wq;
    constexpr int PC0 = C::P0 / 16, PC1 = C::P1 / 16, PCR = PC0 + PC1;  // chunks a group row
    const int gps = G < KS ? KS / G : 1;  // panel rows a stage
    const int pr = PCR ? tid / PCR : 0, pc = PCR ? tid % PCR : 0;
    const bool p_is1 = pc >= PC0;
    const int pcc = p_is1 ? pc - PC0 : pc;
    const int p_esz = p_is1 || C::P0 == 2 * TILE ? 2 : 1;  // bytes per panel value
    const bool p_on = PCR > 0 && pr < gps && (!p_is1 || has_p1);
    const int p_valid = (a.N - (col0 + pcc * 16 / p_esz)) * p_esz;
    const unsigned char* p_base = static_cast<const unsigned char*>(p_is1 ? a.p1 : a.p0);
    const int p_dst = C::W_BYTES + (p_is1 ? GPS_MAX * C::P0 + pr * C::P1 : pr * C::P0) + 16 * pcc;

    // This thread's x copy: 16 bytes of run xc_run, row xc_row (f32: 8
    // copies a row, 128 threads; int8: 2 a row, threads 0-31).
    constexpr int XCPR = XRUN * (is_int(MODE) ? 1 : 4) / 16;  // copies a run's row
    const int xc_run = tid / (RB * XCPR), xc_row = tid / XCPR % RB, xc_q = tid % XCPR;
    const bool xc_on = tid < 2 * RB * XCPR;
    const bool xc_ok = row0 + xc_row < a.B;
    const unsigned char* x_base = is_int(MODE) ? reinterpret_cast<const unsigned char*>(a.xi)
                                               : reinterpret_cast<const unsigned char*>(a.x);
    constexpr int XESZ = is_int(MODE) ? 1 : 4;
    const unsigned char* xc_src = x_base + (size_t(xc_ok ? row0 + xc_row : 0) * a.K) * XESZ + 16 * xc_q;
    const int xc_dst = C::W_BYTES + GPS_MAX * (C::P0 + C::P1) + xc_run * RB * C::XROW + xc_row * C::XROW + 16 * xc_q;
    // The stage's two x runs of XRUN elements: q4 the elements its low and
    // its high nibbles meet (one run after the other where a stage holds
    // whole groups of 64 or fewer), q8 its 64 rows.
    auto x_run = [&](int it, int run) {
        const int rs = r0 + it * C::WROWS;
        const int base = FMT == FMT_Q4 ? ((rs >> lh) << lg) + (rs & (h - 1)) : rs;
        return base + run * (FMT == FMT_Q4 && h > XRUN ? h : XRUN);
    };

    // Stage it's copies: its weights and panels, and the x of stage it + 1
    // (converted one stage ahead, so it lands a stage early: into the slot
    // of stage it + 1 - NSTAGE, whose x was converted an iteration before);
    // stage 0's also the x of stage 0 and the slice's group sums.
    auto load_x = [&](int it) {
        if (xc_on && it < n_it)
            cp_async16(smem + (it % C::NSTAGE) * C::STAGE + xc_dst,
                       xc_src + size_t(x_run(it, xc_run)) * XESZ, xc_ok);
    };
    auto load_stage = [&](int it) {
        unsigned char* st = smem + (it % C::NSTAGE) * C::STAGE;
        if (it == 0) load_x(0);
        load_x(it + 1);
        if (it == 0 && has_xs)  // the slice's group sums, [group][row]
            for (int i = tid; i < (L >> lg) * RB; i += THREADS) {
                const int r = i & (RB - 1);
                const bool ok = row0 + r < a.B;
                cp_async4(xsum + i, ok ? a.xg + size_t((e0 >> lg) + i / RB) * a.B + row0 + r : a.xg, ok);
            }
#pragma unroll
        for (int i = 0; i < WCH; ++i) {
            const int r = tid / CPR + THREADS / CPR * i;
            copy16(st + r * WSTRIDE + 16 * wq, w_src + size_t(it * C::WROWS + r) * a.N, a.packed,
                   w_valid, a.vec);
        }
        if (p_on) {
            const int grow = ((e0 + it * KS) >> lg) + pr;  // the panel row: a group
            copy16(st + p_dst,
                   p_base + (size_t(grow) * a.N + col0 + pcc * 16 / p_esz) * p_esz, p_base,
                   p_valid, a.vec);
        }
    };

#pragma unroll
    for (int s = 0; s < C::NSTAGE - 1; ++s) {
        if (s < n_it) load_stage(s);
        cp_async_commit();
    }

    // A stage's x runs -> xconv[it & 1]: k16 block kb (0, 1: run 0; 2, 3:
    // run 1), row r at (kb * RB + r) * 16 (int8) or, for each bf16 part,
    // part * 4 * RB * 32 + (kb * RB + r) * 32; position 4t + i holds element
    // t + 4i of the block, so that a thread's B fragment is one read.
    auto convert = [&](int it) {
        const unsigned char* xr = smem + (it % C::NSTAGE) * C::STAGE + C::W_BYTES + GPS_MAX * (C::P0 + C::P1);
        unsigned char* xo = xconv + (it & 1) * C::X_CONV;
        if constexpr (is_int(MODE)) {  // warp 0, a thread an item (kb, r)
            if (tid < 4 * RB) {
                const int kb = tid / RB, r = tid % RB;
                const uint4 v = *reinterpret_cast<const uint4*>(xr + (kb / 2) * RB * C::XROW + r * C::XROW + (kb % 2) * 16);
                const uint32_t w[4] = {v.x, v.y, v.z, v.w};
                uint32_t t[4];
                transpose4(w, t);
                *reinterpret_cast<uint4*>(xo + tid * 16) = make_uint4(t[0], t[1], t[2], t[3]);
            }
        } else {  // 4 threads an item (kb, r), thread t its words 2t, 2t + 1
            const int item = tid / 4, t = tid % 4, kb = item / RB, r = item % RB;
            const float* f = reinterpret_cast<const float*>(xr + (kb / 2) * RB * C::XROW + r * C::XROW + (kb % 2) * 64);
            const float fa[2] = {f[t], f[t + 8]}, fb[2] = {f[t + 4], f[t + 12]};
            uint32_t parts[C::PASSES][2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const __nv_bfloat162 hi = __floats2bfloat162_rn(fa[j], fb[j]);
                parts[0][j] = *reinterpret_cast<const uint32_t*>(&hi);
                if constexpr (C::PASSES == 3) {
                    const float ra = fa[j] - __low2float(hi), rb = fb[j] - __high2float(hi);
                    const __nv_bfloat162 mid = __floats2bfloat162_rn(ra, rb);
                    const __nv_bfloat162 lo = __floats2bfloat162_rn(ra - __low2float(mid),
                                                                    rb - __high2float(mid));
                    parts[1][j] = *reinterpret_cast<const uint32_t*>(&mid);
                    parts[2][j] = *reinterpret_cast<const uint32_t*>(&lo);
                }
            }
#pragma unroll
            for (int p = 0; p < C::PASSES; ++p)
                *reinterpret_cast<uint2*>(xo + p * 4 * RB * 32 + item * 32 + 8 * t) = make_uint2(parts[p][0], parts[p][1]);
        }
    };
    cp_async_wait<C::NSTAGE - 2>();  // stage 0 and the group sums
    __syncthreads();
    convert(0);

    const int wc = warp * 32;  // the warp's first column in the tile
    const unsigned char* xs = xconv;  // the stage's converted x
    // accumulators: fragment (m16 tile mt, value e) is column wc + 4 g8 +
    // 2 mt + e / 2, row 2 t4 + e % 2
    float acc[2][4] = {}, cg[2][4] = {}, mn_acc[2][4] = {};
    int ci[2][4] = {};

    // the group-end folds: panel values of this thread's 4 columns
    auto panel4 = [&](const unsigned char* row, bool bf, float (&v)[4]) {
        if (bf) {
            const uint2 w = *reinterpret_cast<const uint2*>(row + 2 * (wc + 4 * g8));
            const __nv_bfloat162 a0 = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
            const __nv_bfloat162 a1 = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
            v[0] = __low2float(a0); v[1] = __high2float(a0);
            v[2] = __low2float(a1); v[3] = __high2float(a1);
        } else {  // int8: each byte, its sign flipped, is the low byte of 2^23 + q + 128
            const uint32_t w = lds32(row + wc + 4 * g8) ^ 0x80808080u;
#pragma unroll
            for (int c = 0; c < 4; ++c)
                v[c] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | uint32_t(c))) - 8388736.0f;
        }
    };
    auto xsum2 = [&](int sg, float (&v)[2]) {  // slice group sg, rows 2 t4, 2 t4 + 1
        const float2 w = *reinterpret_cast<const float2*>(xsum + sg * RB + 2 * t4);
        v[0] = w.x; v[1] = w.y;
    };

    // One k16 step of the float variants: A the weight fragments of both
    // m16 tiles, the step's 16 elements from `base` on (k16 block kb of the
    // stage's converted x), gl its group's panel row in the stage,
    // first/last: the step opens / closes its group.
    auto float_step = [&](const unsigned char* st, uint32_t (&A)[2][4], int gl, int base, int kb,
                          bool first, bool last) {
        const unsigned char* pan0 = st + C::W_BYTES + gl * C::P0;
        const unsigned char* pan1 = st + C::W_BYTES + GPS_MAX * C::P0 + gl * C::P1;
        if constexpr (MODE == V_BF16) {  // the weight bf16(q * s)
            const uint2 sw = *reinterpret_cast<const uint2*>(pan0 + 2 * (wc + 4 * g8));
            const uint32_t s2[4] = {__byte_perm(sw.x, 0, 0x1010), __byte_perm(sw.x, 0, 0x3232),
                                    __byte_perm(sw.y, 0, 0x1010), __byte_perm(sw.y, 0, 0x3232)};
            const uint32_t m128 = 0xC300C300u;  // bf16 pair (-128, -128)
            const __nv_bfloat162 neg = *reinterpret_cast<const __nv_bfloat162*>(&m128);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const __nv_bfloat162 sj = *reinterpret_cast<const __nv_bfloat162*>(&s2[j]);
                // q4: A holds 128 + q, and (128 + q) s - 128 s (exact: a power
                // of two times s) rounds once to bf16(q s); q8: A holds q
                const __nv_bfloat162 c = __hmul2(sj, neg);
#pragma unroll
                for (int k = j % 2; k < 4; k += 2) {
                    const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(&A[j / 2][k]);
                    const __nv_bfloat162 w = FMT == FMT_Q4 ? __hfma2(q, sj, c) : __hmul2(q, sj);
                    A[j / 2][k] = *reinterpret_cast<const uint32_t*>(&w);
                }
            }
        }
        if (MODE == V_MINFOLD && first)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) cg[mt][e] = 0.0f;
#pragma unroll
        for (int pass = C::PASSES - 1; pass >= 0; --pass) {  // smallest part first
            const uint2 b = *reinterpret_cast<const uint2*>(xs + pass * 4 * RB * 32 + (kb * RB + g8) * 32 + 8 * t4);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_bf16(cg[mt], A[mt][0], A[mt][1], A[mt][2], A[mt][3], b.x, b.y);
        }
        if (!last || MODE == V_NOSCALE) return;
        const int sg = (base - e0) >> lg;
        float xv[2] = {0.0f, 0.0f}, mn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (has_p1) {
            xsum2(sg, xv);
            panel4(pan1, true, mn);
            if (MODE == V_BF16) {  // v6 rounds the sums to bf16
                xv[0] = round_bf16(xv[0]);
                xv[1] = round_bf16(xv[1]);
            }
        }
        if constexpr (MODE == V_MINFOLD) {
            float sc[4];
            panel4(pan0, true, sc);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = 2 * mt + e / 2;
                    acc[mt][e] = fmaf(sc[c], cg[mt][e], acc[mt][e]) - mn[c] * xv[e & 1];
                }
        } else {  // v6: the min term once a group
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) mn_acc[mt][e] = fmaf(mn[2 * mt + e / 2], xv[e & 1], mn_acc[mt][e]);
        }
    };

    // v8's fold of one group's int32 product: acc += u * C_g - xs2 * m2.
    auto w4a8_fold = [&](const unsigned char* st, int gl, int sg, const int (&cgi)[2][4]) {
        float u[4], m2[4], xv[2];
        panel4(st + C::W_BYTES + gl * C::P0, false, u);
        panel4(st + C::W_BYTES + GPS_MAX * C::P0 + gl * C::P1, true, m2);
        xsum2(sg, xv);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                // C_g as float, exactly (|C_g| <= 15 * 128 * 1024 < 2^22): the
                // low bits of 1.5 * 2^23 + C_g
                const float cf = __int_as_float(0x4B400000 + cgi[mt][e]) - 12582912.0f;
                const int c = 2 * mt + e / 2;
                acc[mt][e] = fmaf(cf, u[c], acc[mt][e]) - xv[e & 1] * m2[c];
            }
    };

    // This thread's int8 x word of k16 block kb: elements t4 + 4i of row g8.
    auto xword = [&](int kb) { return lds32(xs + (kb * RB + g8) * 16 + 4 * t4); };

    for (int it = 0; it < n_it; ++it) {
        // stage it (and the x of it + 1) landed and stage it's x is
        // converted; every warp is done with it - 1, whose ring slot and x
        // buffer are refilled
        cp_async_wait<C::NSTAGE - 2>();
        __syncthreads();
        if (it + C::NSTAGE - 1 < n_it) load_stage(it + C::NSTAGE - 1);
        cp_async_commit();
        if (it + 1 < n_it) convert(it + 1);
        xs = xconv + (it & 1) * C::X_CONV;

        const unsigned char* st = smem + (it % C::NSTAGE) * C::STAGE;
        const int rs = r0 + it * C::WROWS;  // the stage's first packed row
        if constexpr (FMT == FMT_Q4) {
#pragma unroll
            for (int ch = 0; ch < KS / 32; ++ch) {  // chunks of 16 packed rows: 32 elements
                const unsigned char* wp = st + (16 * ch + t4) * WSTRIDE + wc + 4 * g8;
                const uint32_t w[4] = {lds32(wp), lds32(wp + 4 * WSTRIDE), lds32(wp + 8 * WSTRIDE),
                                       lds32(wp + 12 * WSTRIDE)};  // rows t4 + 4i
                const int R = rs + 16 * ch;
                const int j0 = R & (h - 1);  // the chunk's place in its group (group >= 32)
                if constexpr (!is_int(MODE)) {
                    uint32_t v01[4], v23[4];  // byte j of rows (t4, t4 + 4) / (t4 + 8, t4 + 12)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const uint32_t sel = uint32_t(j) | uint32_t(j) << 4 | uint32_t(4 + j) << 8 | uint32_t(4 + j) << 12;
                        v01[j] = __byte_perm(w[0], w[1], sel);
                        v23[j] = __byte_perm(w[2], w[3], sel);
                    }
#pragma unroll
                    for (int ks = 0; ks < 2; ++ks) {
                        // group 16: step ks is group 2 ch + ks, rows 8 ks + (t4, t4 + 4),
                        // low nibbles then high; else the low (ks 0) or high (ks 1)
                        // nibbles of all 16 rows
                        uint32_t A[2][4];
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const uint32_t src = ks ? v23[j] : v01[j];
                            const uint32_t lo = g16 ? src : v01[j] >> (4 * ks);
                            const uint32_t hi = g16 ? src >> 4 : v23[j] >> (4 * ks);
                            // v6 keeps the bf16 pair of 128 + q (float_step's fma
                            // removes the 128); the others take q
                            A[j / 2][j % 2] = MODE == V_BF16 ? (lo & 0x000F000Fu) | 0x43004300u
                                                             : nibbles_bf16x2(lo);
                            A[j / 2][2 + j % 2] = MODE == V_BF16 ? (hi & 0x000F000Fu) | 0x43004300u
                                                                 : nibbles_bf16x2(hi);
                        }
                        if (g16)
                            float_step(st, A, 2 * ch + ks, 2 * R + 16 * ks, 2 * ch + ks, true, true);
                        else
                            float_step(st, A, (16 * ch) >> lh, ((R >> lh) << lg) + j0 + ks * h,
                                       h == 16 ? 2 * ch + ks : ch + 2 * ks, ks == 0 && j0 == 0,
                                       ks == 1 && j0 + 16 == h);
                    }
                } else {
                    uint32_t t[4], lo[4], hi[4];
                    transpose4(w, t);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        lo[j] = t[j] & 0x0F0F0F0Fu;
                        hi[j] = (t[j] >> 4) & 0x0F0F0F0Fu;
                    }
                    if constexpr (MODE == V_MULCOST) {  // wrap8(q * u), u of each byte's group
                        const unsigned char* pan = st + C::W_BYTES + wc + 4 * g8;
                        const uint32_t ua = lds32(pan + (g16 ? 2 * ch : (16 * ch) >> lh) * C::P0);
                        if (g16) {  // bytes 0, 1: rows t4, t4 + 4 (group 2 ch); 2, 3: the next group
                            const uint32_t ub = lds32(pan + (2 * ch + 1) * C::P0);
#pragma unroll
                            for (int j = 0; j < 4; ++j) {
                                const uint32_t uj = (ua >> (8 * j)) & 0xFFu, vj = (ub >> (8 * j)) & 0xFFu;
                                lo[j] = __byte_perm(mul_wrap8(lo[j], uj), mul_wrap8(lo[j], vj), 0x7610);
                                hi[j] = __byte_perm(mul_wrap8(hi[j], uj), mul_wrap8(hi[j], vj), 0x7610);
                            }
                        } else {
#pragma unroll
                            for (int j = 0; j < 4; ++j) {
                                const uint32_t uj = (ua >> (8 * j)) & 0xFFu;
                                lo[j] = mul_wrap8(lo[j], uj);
                                hi[j] = mul_wrap8(hi[j], uj);
                            }
                        }
                    }
                    uint32_t b0, b1;
                    if (g16) {  // elements 2R + (t4, t4 + 4, 16 + t4, 20 + t4), high nibbles + 8
                        const uint32_t wa = xword(2 * ch), wb = xword(2 * ch + 1);
                        b0 = __byte_perm(wa, wb, 0x5410);
                        b1 = __byte_perm(wa, wb, 0x7632);
                    } else {  // the elements of the low nibbles, then of the high
                        b0 = xword(h == 16 ? 2 * ch : ch);
                        b1 = xword(h == 16 ? 2 * ch + 1 : 2 + ch);
                    }
                    if constexpr (MODE == V_W4A8) {
                        if (g16) {
#pragma unroll
                            for (int q = 0; q < 2; ++q) {  // the chunk's two groups
                                const uint32_t mask = q ? 0xFFFF0000u : 0x0000FFFFu;
                                int cgi[2][4] = {};
#pragma unroll
                                for (int mt = 0; mt < 2; ++mt)
                                    mma_s8(cgi[mt], lo[2 * mt], lo[2 * mt + 1], hi[2 * mt], hi[2 * mt + 1],
                                           b0 & mask, b1 & mask);
                                w4a8_fold(st, 2 * ch + q, ((2 * R - e0) >> 4) + q, cgi);
                            }
                        } else {
                            if (j0 == 0)
#pragma unroll
                                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                                    for (int e = 0; e < 4; ++e) ci[mt][e] = 0;
#pragma unroll
                            for (int mt = 0; mt < 2; ++mt)
                                mma_s8(ci[mt], lo[2 * mt], lo[2 * mt + 1], hi[2 * mt], hi[2 * mt + 1], b0, b1);
                            if (j0 + 16 == h) w4a8_fold(st, (16 * ch) >> lh, ((R >> lh) - (e0 >> lg)), ci);
                        }
                    } else {
#pragma unroll
                        for (int mt = 0; mt < 2; ++mt) {
                            mma_s8(ci[mt], lo[2 * mt], lo[2 * mt + 1], hi[2 * mt], hi[2 * mt + 1], b0, b1);
                            if (MODE == V_4DOT)  // the nibbles swapped: x_lo * hi + x_hi * lo
                                mma_s8(ci[mt], hi[2 * mt], hi[2 * mt + 1], lo[2 * mt], lo[2 * mt + 1], b0, b1);
                        }
                    }
                }
            }
        } else if constexpr (!is_int(MODE)) {
#pragma unroll
            for (int s = 0; s < KS / 16; ++s) {  // k16 steps: 16 rows each
                const unsigned char* wp = st + (16 * s + t4) * WSTRIDE + wc + 4 * g8;
                const uint32_t w0 = lds32(wp), w1 = lds32(wp + 4 * WSTRIDE);
                const uint32_t w2 = lds32(wp + 8 * WSTRIDE), w3 = lds32(wp + 12 * WSTRIDE);
                uint32_t A[2][4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    A[j / 2][j % 2] = int8_pair_bf16x2(w0, w1, j);
                    A[j / 2][2 + j % 2] = int8_pair_bf16x2(w2, w3, j);
                }
                const int el = rs + 16 * s;
                float_step(st, A, (16 * s) >> lg, el, s, (el & (G - 1)) == 0, ((el + 16) & (G - 1)) == 0);
            }
        } else {  // q8, v7
#pragma unroll
            for (int s = 0; s < KS / 32; ++s) {  // k32 steps: 32 rows each
                const unsigned char* wp = st + (32 * s + t4) * WSTRIDE + wc + 4 * g8;
                const uint32_t wl[4] = {lds32(wp), lds32(wp + 4 * WSTRIDE), lds32(wp + 8 * WSTRIDE),
                                        lds32(wp + 12 * WSTRIDE)};
                const uint32_t wh[4] = {lds32(wp + 16 * WSTRIDE), lds32(wp + 20 * WSTRIDE),
                                        lds32(wp + 24 * WSTRIDE), lds32(wp + 28 * WSTRIDE)};
                uint32_t tl[4], th[4];
                transpose4(wl, tl);
                transpose4(wh, th);
                const uint32_t b0 = xword(2 * s), b1 = xword(2 * s + 1);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    mma_s8(ci[mt], tl[2 * mt], tl[2 * mt + 1], th[2 * mt], th[2 * mt + 1], b0, b1);
            }
        }
    }

    // the block's partial tile -> shared memory (over the ring) -> the
    // fixed-order sum
    cp_async_wait<0>();
    __syncthreads();
    T* part = reinterpret_cast<T*>(smem);  // [RB][TILE]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            T v;
            if constexpr (MODE == V_MINFOLD || MODE == V_W4A8) v = acc[mt][e];
            else if constexpr (MODE == V_NOSCALE) v = cg[mt][e];
            else if constexpr (MODE == V_BF16) v = cg[mt][e] - mn_acc[mt][e];
            else v = ci[mt][e];
            part[(2 * t4 + (e & 1)) * TILE + wc + 4 * g8 + 2 * mt + e / 2] = v;
        }
    __syncthreads();
    split_sum(part, RB * TILE, reinterpret_cast<T*>(a.ws), a.counters, a.splits, [&](int e, T v) {
        const int row = row0 + e / TILE, col = col0 + e % TILE;
        if (row >= a.B || col >= a.N) return;
        float out = float(v);
        if (MODE == V_W4A8) out *= __ldg(a.S + col);
        a.y[size_t(row) * a.N + col] = out;
    });
}

// ---- launches --------------------------------------------------------------

// The shared memory limit of each kernel is raised once per device.
template <int FMT, int MODE>
int launch(const Args& a, cudaStream_t st) {
    constexpr int smem = Cfg<FMT, MODE>::SMEM;
    static unsigned long long done = 0;  // one bit per device (0..63)
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return int(e);
    if (!(done >> dev & 1ull)) {
        e = cudaFuncSetAttribute(variant_tc<FMT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return int(e);
        done |= 1ull << dev;
    }
    const dim3 grid(a.splits, (a.B + RB - 1) / RB, (a.N + TILE - 1) / TILE);
    variant_tc<FMT, MODE><<<grid, THREADS, smem, st>>>(a);
    return int(cudaGetLastError());
}

// The checks every entry makes: a layout variant_tc takes, and a split of K
// into slices of whole units of at most SLICE_MAX elements.
bool valid(const Args& a, int group) {
    const int UK = group > KS ? group : KS;
    if (group < 16 || group > SLICE_MAX || (group & (group - 1)) != 0 || a.K <= 0 || a.K % UK != 0 ||
        a.N <= 0 || a.B <= 0 || a.splits < 1 || a.splits > a.K / UK)
        return false;
    const int units = a.K / UK;
    if ((units + a.splits - 1) / a.splits * UK > SLICE_MAX) return false;
    return a.splits == 1 || (a.ws != nullptr && a.counters != nullptr);
}

Args make_args(const void* packed, float* y, float* ws, int* counters, int B, int K, int N,
               int group, int splits, int vec) {
    Args a{};
    a.packed = static_cast<const uint8_t*>(packed);
    a.y = y;
    a.ws = ws;
    a.counters = counters;
    a.B = B; a.K = K; a.N = N; a.splits = splits; a.vec = vec;
    a.lg = group > 0 ? __builtin_ctz(unsigned(group)) : 0;
    return a;
}

}  // namespace

// Common arguments: B, K, N the product's shape; group the scale group (a
// power of two from 16 to 1024, K a multiple of max(group, 64)); fmt 0 = q4
// (packed uint8 [K/2, N]), 1 = q8 (int8 [K, N]); splits: K slices of whole
// max(group, 64)-element units, none longer than 1024 elements; ws, counters:
// with splits > 1 a workspace of ceil(B/8) * ceil(N/128) * splits * 1024
// 4-byte values and one int counter per tile, all 0 (the kernel leaves them
// 0); vec: 1 when N % 16 == 0 and the packed data and every panel are 16-byte
// aligned. x (f32) and xi (int8) rows must be 16-byte aligned. Each returns
// the cudaError_t of its launch (0 = success).

// v2 (mode 0: y = x @ q, no panels) and v5 (mode 1: y = x @ (s*q) - xg^T @ m)
// in f32. scales, mins: bfloat16 [K/group, N] (mins may be null, and v2
// reads neither); xg: float32 [K/group, B] (v5 with mins).
extern "C" int variant_f32_launch(const float* x, const float* xg, const void* packed,
                                  const void* scales, const void* mins, float* y, float* ws,
                                  int* counters, int B, int K, int N, int group, int fmt,
                                  int mode, int splits, int vec, void* stream) {
    Args a = make_args(packed, y, ws, counters, B, K, N, group, splits, vec);
    a.x = x;
    a.xg = xg;
    if (mode != 0) {
        a.p0 = scales;
        a.p1 = mins;
    }
    if (!valid(a, group) || (mode != 0 && (scales == nullptr || (mins != nullptr && xg == nullptr))))
        return int(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (fmt == FMT_Q4)
        return mode == 0 ? launch<FMT_Q4, V_NOSCALE>(a, st) : launch<FMT_Q4, V_MINFOLD>(a, st);
    return mode == 0 ? launch<FMT_Q8, V_NOSCALE>(a, st) : launch<FMT_Q8, V_MINFOLD>(a, st);
}

// v6: y = bf16(x) @ bf16(q * s) - bf16(xg)^T @ m, products summed in f32.
// Arguments as variant_f32_launch.
extern "C" int variant_bf16_launch(const float* x, const float* xg, const void* packed,
                                   const void* scales, const void* mins, float* y, float* ws,
                                   int* counters, int B, int K, int N, int group, int fmt,
                                   int splits, int vec, void* stream) {
    Args a = make_args(packed, y, ws, counters, B, K, N, group, splits, vec);
    a.x = x;
    a.xg = xg;
    a.p0 = scales;
    a.p1 = mins;
    if (!valid(a, group) || scales == nullptr || (mins != nullptr && xg == nullptr))
        return int(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return fmt == FMT_Q4 ? launch<FMT_Q4, V_BF16>(a, st) : launch<FMT_Q8, V_BF16>(a, st);
}

// v7 (mode 0: y = xi @ q), v9 (mode 1: y = xi @ wrap8(q * u), q4 only) and
// v10 (mode 2: y = sum (x_j + x_{j+h}) (lo_j + hi_j), q4 only), int32 sums
// written as float32. xi: int8 [B, K]; u: int8 [K/group, N] (v9) or null.
extern "C" int variant_int8_launch(const void* xi, const void* packed, const void* u, float* y,
                                   float* ws, int* counters, int B, int K, int N, int group,
                                   int fmt, int mode, int splits, int vec, void* stream) {
    Args a = make_args(packed, y, ws, counters, B, K, N, group, splits, vec);
    a.xi = static_cast<const int8_t*>(xi);
    if (mode == 1) a.p0 = u;
    if (!valid(a, group) || mode < 0 || mode > 2 || (fmt != FMT_Q4 && mode != 0) ||
        (mode == 1 && u == nullptr))
        return int(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (fmt != FMT_Q4) return launch<FMT_Q8, V_INT8>(a, st);
    return mode == 1 ? launch<FMT_Q4, V_MULCOST>(a, st)
                     : mode == 2 ? launch<FMT_Q4, V_4DOT>(a, st) : launch<FMT_Q4, V_INT8>(a, st);
}

// v8 (q4): y = S * [sum_g u_g * (xi @ q)_g - xg2^T @ m2], before the caller's
// per-row factor t. xg2: float32 [K/group, B]; u: int8 [K/group, N]; m2:
// bfloat16 [K/group, N]; S: float32 [N].
extern "C" int variant_w4a8_launch(const void* xi, const float* xg2, const void* packed,
                                   const void* u, const void* m2, const float* S, float* y,
                                   float* ws, int* counters, int B, int K, int N, int group,
                                   int splits, int vec, void* stream) {
    Args a = make_args(packed, y, ws, counters, B, K, N, group, splits, vec);
    a.xi = static_cast<const int8_t*>(xi);
    a.xg = xg2;
    a.p0 = u;
    a.p1 = m2;
    a.S = S;
    if (!valid(a, group) || xg2 == nullptr || u == nullptr || m2 == nullptr || S == nullptr)
        return int(cudaErrorInvalidValue);
    return launch<FMT_Q4, V_W4A8>(a, static_cast<cudaStream_t>(stream));
}
