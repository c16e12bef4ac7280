// Host-side fused Adam/AdamW, Adagrad and Lion for offloaded optimizer
// states (ZeRO-Offload), the PyTorch port's copy of the JAX package's
// csrc/cpu_adam/cpu_adam.cpp with the same math, line for line.
//
// The optimizer step runs on the card's host over fp32 master params and
// moments held in CPU memory while the card holds the compute-dtype copy.
// The inner loops are written so the compiler's autovectorizer emits the
// SIMD code (-O3 -march=native, contiguous, no aliasing); the Python
// wrapper splits a step across a thread pool.  Built with the JAX
// package's flags, the results are bit-equal to its library on one host.
//
// Exposed as a plain C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// One Adam step over a contiguous fp32 span.
// mode: 0 = Adam (L2 as grad decay), 1 = AdamW (decoupled decay).
void ds_adam_step(int64_t n,
                  float* __restrict__ param,
                  const float* __restrict__ grad,
                  float* __restrict__ exp_avg,
                  float* __restrict__ exp_avg_sq,
                  int64_t step,
                  float lr, float beta1, float beta2, float eps,
                  float weight_decay, int adamw_mode) {
    const float bc1 = 1.0f - std::pow(beta1, (float)step);
    const float bc2 = 1.0f - std::pow(beta2, (float)step);
    const float step_size = lr / bc1;
    const float bc2_sqrt = std::sqrt(bc2);
    const float decay = weight_decay;
    if (adamw_mode) {
        const float w_scale = 1.0f - lr * decay;
        for (int64_t i = 0; i < n; ++i) {
            const float g = grad[i];
            const float m = beta1 * exp_avg[i] + (1.0f - beta1) * g;
            const float v = beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
            exp_avg[i] = m;
            exp_avg_sq[i] = v;
            const float denom = std::sqrt(v) / bc2_sqrt + eps;
            param[i] = param[i] * w_scale - step_size * (m / denom);
        }
    } else {
        for (int64_t i = 0; i < n; ++i) {
            float g = grad[i];
            if (decay != 0.0f) g += decay * param[i];
            const float m = beta1 * exp_avg[i] + (1.0f - beta1) * g;
            const float v = beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
            exp_avg[i] = m;
            exp_avg_sq[i] = v;
            const float denom = std::sqrt(v) / bc2_sqrt + eps;
            param[i] -= step_size * (m / denom);
        }
    }
}

// Same step, but gradients arrive in bf16 (as uint16 view) and a bf16 working
// copy of the params is produced alongside the fp32 master update — the
// layout the offload engine uses (bf16 on-chip copy, fp32 master on host).
void ds_adam_step_bf16g(int64_t n,
                        float* __restrict__ param,
                        const uint16_t* __restrict__ grad_bf16,
                        uint16_t* __restrict__ param_bf16_out,
                        float* __restrict__ exp_avg,
                        float* __restrict__ exp_avg_sq,
                        int64_t step,
                        float lr, float beta1, float beta2, float eps,
                        float weight_decay, int adamw_mode) {
    const float bc1 = 1.0f - std::pow(beta1, (float)step);
    const float bc2 = 1.0f - std::pow(beta2, (float)step);
    const float step_size = lr / bc1;
    const float bc2_sqrt = std::sqrt(bc2);
    for (int64_t i = 0; i < n; ++i) {
        uint32_t gbits = ((uint32_t)grad_bf16[i]) << 16;
        float g;
        std::memcpy(&g, &gbits, 4);
        float p = param[i];
        if (adamw_mode) {
            p *= (1.0f - lr * weight_decay);
        } else if (weight_decay != 0.0f) {
            g += weight_decay * p;
        }
        const float m = beta1 * exp_avg[i] + (1.0f - beta1) * g;
        const float v = beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
        exp_avg[i] = m;
        exp_avg_sq[i] = v;
        const float denom = std::sqrt(v) / bc2_sqrt + eps;
        p -= step_size * (m / denom);
        param[i] = p;
        // round-to-nearest-even bf16
        uint32_t pbits;
        std::memcpy(&pbits, &p, 4);
        uint32_t rounding = 0x7FFF + ((pbits >> 16) & 1);
        param_bf16_out[i] = (uint16_t)((pbits + rounding) >> 16);
    }
}

// Adagrad (reference csrc/adagrad/cpu_adagrad.cpp).
void ds_adagrad_step(int64_t n, float* __restrict__ param,
                     const float* __restrict__ grad,
                     float* __restrict__ exp_avg_sq,
                     float lr, float eps, float weight_decay) {
    for (int64_t i = 0; i < n; ++i) {
        float g = grad[i];
        if (weight_decay != 0.0f) g += weight_decay * param[i];
        const float v = exp_avg_sq[i] + g * g;
        exp_avg_sq[i] = v;
        param[i] -= lr * g / (std::sqrt(v) + eps);
    }
}

// Lion (reference csrc/lion/cpu_lion.cpp).
void ds_lion_step(int64_t n, float* __restrict__ param,
                  const float* __restrict__ grad,
                  float* __restrict__ exp_avg,
                  float lr, float beta1, float beta2, float weight_decay) {
    for (int64_t i = 0; i < n; ++i) {
        const float g = grad[i];
        const float m = exp_avg[i];
        const float c = beta1 * m + (1.0f - beta1) * g;
        const float sign = (c > 0.0f) ? 1.0f : ((c < 0.0f) ? -1.0f : 0.0f);
        param[i] = param[i] * (1.0f - lr * weight_decay) - lr * sign;
        exp_avg[i] = beta2 * m + (1.0f - beta2) * g;
    }
}

}  // extern "C"
