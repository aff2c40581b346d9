// Tantan repeat-probability scan (native twin of
// diamond_tpu/masking/tantan.py Tantan.repeat_prob).
//
// The float32 arithmetic order matches the Python/numpy implementation
// exactly so mask decisions are bit-identical:
//   - elementwise ops in the same sequence,
//   - vector sums use numpy's pairwise summation (8-accumulator blocks,
//     recursive halving above 128 elements),
//   - compiled with -ffp-contract=off (no FMA contraction).
//
// Semantics follow the reference tantan scan (reference
// src/masking/tantan.cpp:115-215): 50 repeat-offset states, likelihood
// ratios exp(lambda*score), scaling by 1/b every 16 positions, forward +
// backward pass producing P(repeat) per position.

#include <cstdint>
#include <cstring>

namespace {

constexpr int WINDOW = 50;

// numpy pairwise_sum_FLOAT (numpy/core/src/umath/loops_utils.h.src)
float pairwise_sum(const float* a, int64_t n) {
    if (n < 8) {
        float res = 0.0f;
        for (int64_t i = 0; i < n; ++i)
            res += a[i];
        return res;
    }
    if (n <= 128) {
        float r[8];
        for (int j = 0; j < 8; ++j)
            r[j] = a[j];
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j)
                r[j] += a[i + j];
        float res = ((r[0] + r[1]) + (r[2] + r[3]))
                  + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i)
            res += a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

}  // namespace

extern "C" void tantan_repeat_prob(const int8_t* letters, int64_t L,
                                   const float* ratios /* 32x32 */,
                                   float p_repeat, float p_repeat_end,
                                   float repeat_growth, float* out) {
    if (L == 0)
        return;

    const float b2b = 1.0f - p_repeat;
    const float f2f = 1.0f - p_repeat_end;
    const float g = repeat_growth;
    float gw = 1.0f;  // g ** WINDOW, float32 like numpy's g ** np.float32(50)
    {
        // numpy float32 ** uses powf
        gw = __builtin_powf(g, (float)WINDOW);
    }
    const float b2f0 = p_repeat * (1.0f - g) / (1.0f - gw);
    float d[WINDOW];
    d[WINDOW - 1] = b2f0;
    for (int i = WINDOW - 2; i >= 0; --i)
        d[i] = d[i + 1] * g;

    int8_t* seq = new int8_t[L];
    for (int64_t i = 0; i < L; ++i)
        seq[i] = letters[i] & 31;

    float* e = new float[(size_t)L * WINDOW];
    for (int64_t i = 0; i < L; ++i) {
        const int row = seq[i] * 32;
        float* ei = e + (size_t)i * WINDOW;
        for (int off = 0; off < WINDOW; ++off) {
            const int64_t j = i - off - 1;
            ei[off] = j >= 0 ? ratios[row + seq[j]] : 0.0f;
        }
    }
    delete[] seq;

    float f[WINDOW];
    std::memset(f, 0, sizeof(f));
    float b = 1.0f;
    float f_sum = 0.0f;
    float* pb = new float[L];
    const int64_t n_scale = (L + 15) / 16;
    float* scale = new float[n_scale];

    for (int64_t i = 0; i < L; ++i) {
        const float b_old = b;
        const float* ei = e + (size_t)i * WINDOW;
        for (int k = 0; k < WINDOW; ++k)
            f[k] = (f[k] * f2f + b_old * d[k]) * ei[k];
        const float f_sum_new = pairwise_sum(f, WINDOW);
        b = b_old * b2b + f_sum * p_repeat_end;
        f_sum = f_sum_new;
        if ((i & 15) == 15) {
            const float s = 1.0f / b;
            scale[i / 16] = s;
            b *= s;
            for (int k = 0; k < WINDOW; ++k)
                f[k] *= s;
            f_sum *= s;
        }
        pb[i] = b;
    }

    const float z = b * b2b + pairwise_sum(f, WINDOW) * p_repeat_end;
    const float zinv = 1.0f / z;

    b = b2b;
    for (int k = 0; k < WINDOW; ++k)
        f[k] = p_repeat_end;
    float fe[WINDOW], fd[WINDOW];
    for (int64_t i = L - 1; i >= 0; --i) {
        const float pf = 1.0f - pb[i] * b * zinv;
        if ((i & 15) == 15) {
            const float s = scale[i / 16];
            b *= s;
            for (int k = 0; k < WINDOW; ++k)
                f[k] *= s;
        }
        const float* ei = e + (size_t)i * WINDOW;
        for (int k = 0; k < WINDOW; ++k)
            fe[k] = f[k] * ei[k];
        for (int k = 0; k < WINDOW; ++k)
            fd[k] = fe[k] * d[k];
        const float tsum = pairwise_sum(fd, WINDOW);
        for (int k = 0; k < WINDOW; ++k)
            f[k] = fe[k] * f2f + p_repeat_end * b;
        b = b2b * b + tsum;
        out[i] = pf;
    }

    delete[] e;
    delete[] pb;
    delete[] scale;
}

// Batched scan over a concatenated block: one call for all sequences
// (removes the per-sequence Python/ctypes round trip).  out is aligned
// with the letters array; positions outside sequences are left untouched.
extern "C" void tantan_repeat_prob_many(
    const int8_t* letters, const int64_t* starts, const int64_t* lens,
    int64_t n, const float* ratios, float p_repeat, float p_repeat_end,
    float repeat_growth, float* out) {
    for (int64_t i = 0; i < n; ++i)
        tantan_repeat_prob(letters + starts[i], lens[i], ratios, p_repeat,
                           p_repeat_end, repeat_growth, out + starts[i]);
}
