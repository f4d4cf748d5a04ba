/* Native host helpers of the PyTorch port: a copy of the JAX package's
 * ``whisper_flamingo_tpu/native/wf_native.c`` (the port imports nothing of
 * that package, so it builds its own library from this file).
 *
 *   - wf_mix_noise:      RMS-matched SNR noise mixing with noise tiling
 *                        and the int16 clipping guard, in double
 *                        precision (the reference's utils.py:37-66)
 *   - wf_resample_linear: linear-interpolation resampling
 *   - wf_edit_distance:  Levenshtein distance over int64 token ids
 *
 * Plain C ABI, loaded via ctypes; no Python.h dependency so it builds
 * with any cc. All functions are single-threaded and reentrant; callers
 * parallelize across utterances.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define WF_API __attribute__((visibility("default")))

/* RMS-matched SNR mixing. clean: n samples (int16 scale, float); noise: m
 * samples; writes n mixed samples (int16-clipped values) to out.
 * Returns 0 on success. */
WF_API int wf_mix_noise(
    const float* clean, int64_t n,
    const float* noise, int64_t m,
    double snr_db,
    float* out)
{
    if (n <= 0 || m <= 0) return -1;

    double clean_sq = 0.0, noise_sq = 0.0;
    for (int64_t i = 0; i < n; i++) clean_sq += (double)clean[i] * clean[i];
    /* noise RMS over the tiled/cropped region actually used */
    for (int64_t i = 0; i < n; i++) {
        double v = noise[i % m];
        noise_sq += v * v;
    }
    double clean_rms = sqrt(clean_sq / (double)n);
    double noise_rms = sqrt(noise_sq / (double)n);
    if (noise_rms < 1e-12) noise_rms = 1e-12;

    double target_rms = clean_rms / pow(10.0, snr_db / 20.0);
    double gain = target_rms / noise_rms;

    double max_v = 0.0, min_v = 0.0;
    for (int64_t i = 0; i < n; i++) {
        double v = (double)clean[i] + gain * (double)noise[i % m];
        out[i] = (float)v;
        if (v > max_v) max_v = v;
        if (v < min_v) min_v = v;
    }

    /* int16 clipping guard (reference utils.py:56-64) */
    const double MAXI = 32767.0, MINI = -32768.0;
    if (max_v > MAXI || min_v < MINI) {
        double reduction = (max_v >= -min_v) ? (MAXI / max_v) : (MINI / min_v);
        for (int64_t i = 0; i < n; i++) out[i] = (float)(out[i] * reduction);
    }
    /* truncate toward zero like numpy's astype(int16). Clamp first:
     * after the reduction, fp rounding can leave a value a fraction
     * outside [-32768, 32767], and casting such a float to int16_t is
     * undefined behavior in C. */
    for (int64_t i = 0; i < n; i++) {
        double v = out[i];
        if (v > MAXI) v = MAXI;
        if (v < MINI) v = MINI;
        out[i] = (float)((int16_t)v);
    }
    return 0;
}

/* Linear-interpolation resample of n samples at orig_sr to n_out samples
 * at target_sr (np.interp semantics: clamped at the edges). */
WF_API int wf_resample_linear(
    const float* x, int64_t n, double orig_sr,
    float* out, int64_t n_out, double target_sr)
{
    if (n <= 0 || n_out <= 0) return -1;
    if (n == 1) {
        for (int64_t i = 0; i < n_out; i++) out[i] = x[0];
        return 0;
    }
    double step = orig_sr / target_sr;
    for (int64_t i = 0; i < n_out; i++) {
        double t = (double)i * step;
        int64_t lo = (int64_t)t;
        if (lo >= n - 1) { out[i] = x[n - 1]; continue; }
        double frac = t - (double)lo;
        out[i] = (float)((1.0 - frac) * x[lo] + frac * x[lo + 1]);
    }
    return 0;
}

/* Levenshtein distance over int64 token sequences (two-row DP). */
WF_API int64_t wf_edit_distance(
    const int64_t* a, int64_t n,
    const int64_t* b, int64_t m)
{
    if (n == 0) return m;
    if (m == 0) return n;

    int64_t* prev = (int64_t*)malloc((size_t)(m + 1) * sizeof(int64_t));
    int64_t* cur = (int64_t*)malloc((size_t)(m + 1) * sizeof(int64_t));
    if (!prev || !cur) { free(prev); free(cur); return -1; }

    for (int64_t j = 0; j <= m; j++) prev[j] = j;
    for (int64_t i = 1; i <= n; i++) {
        cur[0] = i;
        int64_t ai = a[i - 1];
        for (int64_t j = 1; j <= m; j++) {
            int64_t sub = prev[j - 1] + (ai != b[j - 1]);
            int64_t del = prev[j] + 1;
            int64_t ins = cur[j - 1] + 1;
            int64_t best = sub < del ? sub : del;
            cur[j] = best < ins ? best : ins;
        }
        int64_t* tmp = prev; prev = cur; cur = tmp;
    }
    int64_t result = prev[m];
    free(prev);
    free(cur);
    return result;
}
