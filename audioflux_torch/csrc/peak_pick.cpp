// Peak pick of a float32 onset envelope (reference onset_algorithm.c
// :__peakPick) in one sequential pass on the host, built with g++ by
// audioflux_torch/ops/_build.py and bound in audioflux_torch/mir/onset.py.
//
// Row i is a point when, in this order,
//   - it lies more than `wait` rows after the last point;
//   - env[i] equals the max of env over [i - pre_max, i + post_max), the
//     window clamped to the row (no point if a NaN lies in it);
//   - env[i] >= mean + delta, the mean over [i - pre_avg, i + post_avg),
//     clamped likewise.
// The points equal those of onset.py's peak_pick_ref bit for bit: the
// float32 arithmetic is numpy's, in numpy's order (window_sum).

#include <cmath>
#include <cstdint>

namespace {

// numpy's float32 pairwise sum of a contiguous run (pairwise_sum,
// numpy/_core/src/umath/loops_utils.h.src): sequential from -0.0 below 8
// elements, eight accumulators up to 128, two halves above, the first a
// multiple of 8 long.
float pairwise_sum(const float* a, int64_t n) {
  if (n < 8) {
    float res = -0.0f;
    for (int64_t i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    float r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int64_t i = 8;
    for (; i < n - n % 8; i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    float res = ((r[0] + r[1]) + (r[2] + r[3])) +
                ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// np.mean of env[s:e] in float32: add.reduce starts from its identity, +0,
// and adds the pairwise sum of the whole run; the count divides in float32
// (numpy divides in float64 and rounds, which gives the same float32).  An
// empty window gives 0 / 0, NaN, as numpy does.
float window_mean(const float* env, int64_t n, int64_t i, int64_t pre,
                  int64_t post) {
  const int64_t s = i - pre > 0 ? i - pre : 0;
  const int64_t e = i + post < n ? i + post : n;
  const float sum = 0.0f + pairwise_sum(env + s, e - s);
  return sum / static_cast<float>(e - s);
}

// np.max over the clamped window, NaN propagating; -inf where it is empty
// (the -inf padding of the numpy form).
bool is_local_max(const float* env, int64_t n, int64_t i, int64_t pre,
                  int64_t post) {
  const int64_t s = i - pre > 0 ? i - pre : 0;
  const int64_t e = i + post < n ? i + post : n;
  float m = -INFINITY;
  for (int64_t j = s; j < e; ++j) {
    const float v = env[j];
    if (std::isnan(v)) return false;
    if (v > m) m = v;
  }
  return env[i] == m;
}

}  // namespace

extern "C" {

// Writes the points of env[0:n] to out (room for n) and returns their
// count.  The windows are >= 0 and at most n.
int64_t afpp_peak_pick(const float* env, int64_t n, int64_t pre_max,
                       int64_t post_max, int64_t pre_avg, int64_t post_avg,
                       int64_t wait, float delta, int64_t* out) {
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (count > 0 && i - out[count - 1] <= wait) continue;
    if (!is_local_max(env, n, i, pre_max, post_max)) continue;
    if (!(env[i] >= window_mean(env, n, i, pre_avg, post_avg) + delta))
      continue;
    out[count++] = i;
  }
  return count;
}

// The mean gate's window mean of every row, for the tests.
void afpp_window_means(const float* env, int64_t n, int64_t pre_avg,
                       int64_t post_avg, float* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = window_mean(env, n, i, pre_avg, post_avg);
}

}  // extern "C"
