// Device helpers of csrc/qgemm.cu and csrc/qmatmul_variants.cu: cp.async,
// the bf16 and s8 tensor-core products, the integer-to-bf16 conversions of
// the weight fragments, and the fixed-order sum of split-K partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qgemm {

using bf16 = __nv_bfloat16;

enum { FMT_Q4 = 0, FMT_Q8 = 1 };

// 16 bytes global -> shared, asynchronously; !valid fills the 16 bytes with
// zeros and reads nothing (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// d += a @ b for one m16n8k16 tile: a row-major 16x16 bf16 (4 registers),
// b column-major 16x8 bf16 (2 registers), d 16x8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = a @ b (no addend): the first product of a scale group.
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0, uint32_t b1) {
    const float z = 0.0f;
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(z));
}

// d += a @ b for one m16n8k32 tile of int8: a row-major 16x32 (4 registers
// of 4 bytes: rows g, g + 8 at k 4t..4t+3, then at k 16+4t..16+4t+3), b
// column-major 32x8 (2 registers), d 16x8 int32 (exact).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two nibbles (bits 0-3 and 16-19 of v) as a bf16 pair, exactly: 0x4300 | q
// is the bf16 of 128 + q, and 128 is then subtracted in bf16 (exact).
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
    const uint32_t biased = (v & 0x000F000Fu) | 0x43004300u;
    const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                     __floats2bfloat162_rn(128.0f, 128.0f));
    return *reinterpret_cast<const uint32_t*>(&r);
}

// Byte j of word a and byte j of word b (signed int8) as a bf16 pair,
// exactly: each byte, its sign bit flipped, becomes the low byte of the
// float 2^23 + (q + 128); subtracting 2^23 + 128 leaves q, which bf16 holds.
__device__ __forceinline__ uint32_t int8_pair_bf16x2(uint32_t a, uint32_t b, int j) {
    const uint32_t sel = uint32_t(j) | 0x7540u;
    const float fa = __uint_as_float(__byte_perm(a ^ 0x80808080u, 0x4B000000u, sel)) - 8388736.0f;
    const float fb = __uint_as_float(__byte_perm(b ^ 0x80808080u, 0x4B000000u, sel)) - 8388736.0f;
    const __nv_bfloat162 r = __floats2bfloat162_rn(fa, fb);
    return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Eight consecutive panel values (16-byte aligned) as float.
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
        out[2 * i] = __low2float(h);
        out[2 * i + 1] = __high2float(h);
    }
}

// Four partials in one 16-byte access: float4, or int4 for the exact int32
// partials of kernel 7's integer variants.
template <class T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// The split-K sum. The `splits` blocks of one output tile (grid x = the K
// slice) each hold a partial tile part[0, count) in shared memory (count a
// multiple of 4, part 16-byte aligned). Each writes it to its own slot of
// the workspace ws[tile][slice][count] and counts itself in
// counters[tile]; the block that arrives last adds the slots in the order
// 0, 1, ..., splits - 1 (so the result does not depend on which block is
// last), hands each sum to emit(e, sum), and sets the counter back to 0 for
// the next launch. With one slice, emit takes part directly. All threads of
// the block call this; it returns true (to all of them) in the block that
// emitted the sums. T: float, or int (summed exactly).
template <class T, class Emit>
__device__ __forceinline__ bool split_sum(const T* part, int count, T* ws, int* counters,
                                          int splits, Emit emit) {
    using V4 = typename Vec4<T>::type;
    const V4* p4 = reinterpret_cast<const V4*>(part);
    auto emit4 = [&](int e4, V4 v) {
        emit(4 * e4, v.x); emit(4 * e4 + 1, v.y); emit(4 * e4 + 2, v.z); emit(4 * e4 + 3, v.w);
    };
    const int n4 = count / 4;
    if (splits == 1) {
        for (int e = threadIdx.x; e < n4; e += blockDim.x) emit4(e, p4[e]);
        return true;
    }
    __shared__ int last;
    const int tile = blockIdx.y * gridDim.z + blockIdx.z;
    V4* slots = reinterpret_cast<V4*>(ws) + size_t(tile) * splits * n4;
    for (int e = threadIdx.x; e < n4; e += blockDim.x)
        __stcg(slots + size_t(blockIdx.x) * n4 + e, p4[e]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return false;
    __threadfence();
    for (int e = threadIdx.x; e < n4; e += blockDim.x) {
        V4 v = __ldcg(slots + e);
        for (int q = 1; q < splits; ++q) {
            const V4 w = __ldcg(slots + size_t(q) * n4 + e);
            v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
        }
        emit4(e, v);
    }
    if (threadIdx.x == 0) counters[tile] = 0;
    return true;
}

}  // namespace qgemm
