// K=7 rate-1/2 soft-decision Viterbi decoder for the Aero-L code, sm_90a.
//
// Replaces the TPU kernel aero_tpu/ops/pallas/viterbi_kernel.py
// (viterbi_acs_pallas, body _acs_kernel, plus the XLA branch metrics,
// argmin and lax.scan traceback of viterbi_decode_soft_pallas): one launch
// here computes the branch metrics from the soft bytes, the
// add-compare-select sweep, the survivors, the end-state argmin and the
// traceback.
//
// What bounds it on an H100: the latency of a dependent chain of T steps
// per stream (631 at 600/1200 bps frames, 2551 at 10500), not bytes or
// FLOPs — each step needs the previous step's 64 path metrics.  So the
// only parallelism is across streams: one warp per stream, B warps in
// all.  At the ~50 frames a 50-VFO drain decodes, 50 warps are fewer
// than two SMs' worth of resident warps out of 132 SMs; that is known and
// left for later work (several streams per warp, or splitting T).
//
// Design (simple and right first):
//   - lane l holds pm[l] and pm[l+32]: exactly the two predecessors
//     (ns>>1, (ns>>1)+32) of next states 2l and 2l+1, so the ACS needs no
//     gather (the TPU kernel's one-hot MXU matmuls existed only because
//     Mosaic could not lower a repeat; they are not carried over);
//   - two __shfl_sync per step put the new metrics back in place;
//   - a 5-step __shfl_xor_sync min reduction normalizes each step;
//   - two __ballot_sync give the 64 survivor bits, kept as one uint64
//     per step in global memory (8x smaller than the TPU's int8 x 64);
//   - soft pairs are loaded 32 steps at a time, one coalesced float2 per
//     lane, and broadcast by shuffle; survivors are stored the same way;
//   - the traceback runs in the same warp: 32 survivor words are loaded
//     per chunk and the pointer chase reads them by shuffle.
//
// Bit-exactness: the arithmetic order is JAX's (branch metric
// s0 + (255 - s1) etc., cand_j = pm[pred_j] + bm[pattern_j], select
// predecessor 1 only if cand1 < cand0, subtract the row minimum).  IEEE
// add, min and subtract are deterministic and there is no multiply to
// contract into an FMA, so the decisions match the JAX decoder for any
// float input.  The end state is the argmin with the lowest index on ties.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;
constexpr int POLY0 = 109;
constexpr int POLY1 = 79;

__device__ __forceinline__ int pattern_of(int ns, int j) {
  // expected output pair (o0*2 + o1) on the transition ps -> ns
  int ps = (ns >> 1) | (j << 5);
  int reg = ((ps << 1) | (ns & 1)) & 0x7F;
  return ((__popc(reg & POLY0) & 1) << 1) | (__popc(reg & POLY1) & 1);
}

__device__ __forceinline__ float pick(int p, float b0, float b1, float b2,
                                      float b3) {
  return p == 0 ? b0 : (p == 1 ? b1 : (p == 2 ? b2 : b3));
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
viterbi_k7_kernel(const float* __restrict__ soft, int B, int T,
                  unsigned long long* __restrict__ surv,
                  uint8_t* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp leaves together

  const float2* s2 = reinterpret_cast<const float2*>(soft) + (size_t)b * T;
  unsigned long long* sv = surv + (size_t)b * T;
  uint8_t* out = bits + (size_t)b * T;

  // next states handled by this lane: ne = 2*lane (even), no = 2*lane + 1
  const int pe0 = pattern_of(2 * lane, 0), pe1 = pattern_of(2 * lane, 1);
  const int po0 = pattern_of(2 * lane + 1, 0);
  const int po1 = pattern_of(2 * lane + 1, 1);
  const bool low_half = lane < 16;
  const int src_x = (lane >> 1) + ((lane & 1) << 4);
  const int src_y = (lane >> 1) + ((~lane & 1) << 4);

  float pm_lo = 0.0f, pm_hi = 0.0f;   // pm[lane], pm[lane + 32]

  for (int t0 = 0; t0 < T; t0 += 32) {
    const int tl = t0 + lane;
    const float2 mine = tl < T ? s2[tl] : make_float2(128.0f, 128.0f);
    const int n = min(32, T - t0);
    unsigned long long my_word = 0ull;
    for (int k = 0; k < n; ++k) {
      const float s0 = __shfl_sync(FULL, mine.x, k);
      const float s1 = __shfl_sync(FULL, mine.y, k);
      const float b0 = s0 + s1;
      const float b1 = s0 + (255.0f - s1);
      const float b2 = (255.0f - s0) + s1;
      const float b3 = (255.0f - s0) + (255.0f - s1);

      const float ce0 = pm_lo + pick(pe0, b0, b1, b2, b3);
      const float ce1 = pm_hi + pick(pe1, b0, b1, b2, b3);
      const float co0 = pm_lo + pick(po0, b0, b1, b2, b3);
      const float co1 = pm_hi + pick(po1, b0, b1, b2, b3);
      const bool te = ce1 < ce0;
      const bool to = co1 < co0;
      float ne = te ? ce1 : ce0;
      float no = to ? co1 : co0;

      float m = fminf(ne, no);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fminf(m, __shfl_xor_sync(FULL, m, o));
      ne = ne - m;
      no = no - m;

      const unsigned even = __ballot_sync(FULL, te);
      const unsigned odd = __ballot_sync(FULL, to);
      if (lane == k)
        my_word = ((unsigned long long)odd << 32) | (unsigned long long)even;

      // new pm[s] lives at lane s (lo) or lane s-32 (hi).  Lanes 0..15 are
      // the sources of every lane's lo metric and lanes 16..31 of every hi
      // metric; even readers want a source's even state, odd readers its
      // odd state.  Pre-select per source half, then two shuffles.
      const float r1 = low_half ? ne : no;
      const float r2 = low_half ? no : ne;
      const float x = __shfl_sync(FULL, r1, src_x);
      const float y = __shfl_sync(FULL, r2, src_y);
      pm_lo = (lane & 1) ? y : x;
      pm_hi = (lane & 1) ? x : y;
    }
    if (tl < T) sv[tl] = my_word;
  }

  // end state: argmin over the 64 final metrics, lowest index on ties
  float best = pm_lo;
  int best_s = lane;
  if (pm_hi < best) {
    best = pm_hi;
    best_s = lane + 32;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, best, o);
    const int os = __shfl_xor_sync(FULL, best_s, o);
    if (ov < best || (ov == best && os < best_s)) {
      best = ov;
      best_s = os;
    }
  }

  // the survivors written above by other lanes must be visible
  __syncwarp();
  __threadfence_block();

  // traceback: every lane follows the same (uniform) state; lane k keeps
  // the bit of step base - k and stores it
  int state = best_s;
  for (int base = T - 1; base >= 0; base -= 32) {
    const int tl = base - lane;
    const unsigned long long w = tl >= 0 ? sv[tl] : 0ull;
    const int n = min(32, base + 1);
    uint8_t my_bit = 0;
    for (int k = 0; k < n; ++k) {
      const unsigned long long wk = __shfl_sync(FULL, w, k);
      if (lane == k) my_bit = (uint8_t)(state & 1);
      const int s1 = state >> 1;
      const int take1 =
          (int)((wk >> ((state & 1) ? (32 + s1) : s1)) & 1ull);
      state = s1 | (take1 << 5);
    }
    if (tl >= 0) out[tl] = my_bit;
  }
}

}  // namespace

extern "C" int aero_viterbi_decode_soft_cuda(const float* soft, int B, int T,
                                             unsigned long long* surv,
                                             uint8_t* bits, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int grid = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  viterbi_k7_kernel<<<grid, 32 * WARPS_PER_BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(soft, B, T, surv,
                                                           bits);
  return (int)cudaGetLastError();
}
