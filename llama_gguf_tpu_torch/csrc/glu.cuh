// The gated-activation epilogue of the GLU kernels (csrc/qgemm.cu's GLU
// path and csrc/moe_qmatmul.cu's grouped GLU): act(gate) * up, float32 in
// and out, a mirror of _glu_combine (llama_gguf_tpu/ops/qmatmul.py).

#pragma once

#include <cuda_runtime.h>

namespace glu {

enum { ACT_SILU = 0, ACT_GELU = 1, ACT_RELU = 2, ACT_RELU2 = 3, ACT_SWIGLU_OAI = 4 };

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float glu_combine(float g, float u, int act) {
    switch (act) {
    case ACT_SWIGLU_OAI: {
        g = fminf(g, 7.0f);
        u = fminf(fmaxf(u, -7.0f), 7.0f);
        return (g * sigmoid(1.702f * g)) * (u + 1.0f);
    }
    case ACT_GELU: {
        const float c = 0.7978845608028654f;
        return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
    }
    case ACT_RELU: return fmaxf(g, 0.0f) * u;
    case ACT_RELU2: { const float m = fmaxf(g, 0.0f); return m * m * u; }
    default: return g * sigmoid(g) * u;
    }
}

}  // namespace glu
