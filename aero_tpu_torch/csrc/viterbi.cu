// K=7 rate-1/2 soft-decision Viterbi decoder for the Aero-L code, sm_90a.
//
// Replaces the TPU kernel aero_tpu/ops/pallas/viterbi_kernel.py
// (viterbi_acs_pallas, body _acs_kernel, plus the XLA branch metrics,
// argmin and lax.scan traceback of viterbi_decode_soft_pallas): one launch
// here computes the branch metrics from the soft bytes, the
// add-compare-select sweep, the decisions, the end-state argmin and the
// traceback.  Input: soft bytes uint8 [B, 2T]; output: bits uint8 [B, T].
//
// What bounds it on an H100.  The work is ~262 operations per trellis
// step and stream (6 for the branch metrics, 4 x 64 for the ACS): at
// B=64, T=631 that is 10.6 M operations, 0.16 us at the card's 67 T/s of
// fp32 (non-tensor) arithmetic, and 121 KB of traffic (81 KB of soft
// bytes in, 40 KB of bits out), 0.04 us at 3.35 TB/s.  So the bound is
// set by compute: 0.16 us.  No design gets near it.  Step t needs all 64
// metrics of step t-1, so a stream is a chain of T dependent steps, and
// the card can only run the B chains side by side (one warp each: 64
// warps on a card that holds 132 x 64).  A step of the chain costs the
// latencies of its instructions, tens of cycles, where the bound allows a
// fraction of a cycle per step.  What a design can do is make the chain
// short per step and keep memory and bookkeeping out of it.
//
// The chain.  A warp shuffle's round trip is by far its longest link
// (tens of cycles; an add or a min takes a few), so this kernel takes two
// trellis steps per exchange (radix 4).  The chain of a PAIR of steps is:
//   1. one 3-input add per candidate (metric + both steps' branch metrics),
//   2. two levels of min (4 candidates per state),
//   3. one exchange: four independent shuffles that put the new metrics
//      where the next pair needs them.
// Off the chain: the branch metrics (the soft bytes read from shared
// memory two pairs ahead and summed one pair ahead), the decisions and
// their four ballots, and lane 0's store of the raw ballots.  The earlier
// radix-2 float version of this kernel had a 5-round shuffle min (the
// per-step normalization), a subtract, two selects and two shuffles on
// the chain of every step, and its decisions in device memory.  What is
// left to pay is issue: a warp issues in order, and the compiler places
// most of a pair's other instructions after the first use of the
// shuffles' results.
//
// Memory.  Nothing in device memory inside the sweep: the warp first
// stages its stream's soft bytes in shared memory (one cp.async.bulk copy
// of the row's 16-byte-aligned body, completed on an mbarrier, the ragged
// head and tail by plain loads), keeps each pair's 128 decision bits in
// shared memory (16 bytes), runs the traceback from there and writes the
// bits out once per lane per 32 pairs.
//
// Layout.  Lane L = 2g + h (g = L >> 1, h = L & 1) holds the metrics of
// the four states g + 16j (j = 0..3), the predecessors of states 4g..4g+3
// two steps later; lanes 2g and 2g+1 hold the same four and compute two of
// those states each: 2L and 2L+1.  Candidate j reaches state x through the
// intermediate state 2g + h + 32(j & 1), so its step decisions are
// j2 = j & 1 (second step) and j1 = j >> 1 (first step).  Exchange: group
// g reads, in round r, state g + 16(r ^ (g & 1)) from lane
// 8(r ^ (g & 1)) + (g >> 1), which sends its state of parity g & 1: each
// lane is read by one group in two of the four rounds, for its two
// states, and sends the same register ("X") in rounds 0 and 2 and the
// other ("Y") in 1 and 3.  The register a value lands in, and the state a
// lane sends as X, depend on the lane; that permutation is folded into the
// lane's branch-metric masks (mA, mB), so the chain has no select.
//
// Decisions and traceback.  The decisions of a pair are two 64-bit words
// in state order, (j2, j1) of each state at the pair's end; the traceback
// takes a pair per link: s -> (s >> 2) | j2(s) << 4 | j1(s) << 5, and the
// two bits of the pair are s & 1 (second step) and (s >> 1) & 1 (first).
// An odd T gets a virtual first step whose branch metrics are all zero:
// the metrics stay equal after it, so nothing changes but its bit, which
// is dropped.
//
// Bit-exactness.  Soft bits are whole bytes, 0..255 (the wrapper takes
// uint8).  Every metric of JAX's float32 decoder is then an integer below
// 2^24, so its arithmetic is exact, and its per-step subtraction of the
// row minimum takes one constant off all 64 states: the decisions
// (predecessor 1 only if cand1 < cand0) and the end state (the argmin,
// lowest index on ties) equal those of exact unnormalized integer
// arithmetic.  Radix 4 keeps the radix-2 decisions: at the second step
// j2 = (min over j1 of group 1) < (min over j1 of group 0), and at the
// first step j1 compares the two candidates of the chosen group, whose
// second-step branch metrics are equal.  An int32 metric grows by at most
// 510 per step: no overflow below T ~ 4.2 M; shared memory caps T far
// lower (smem_bytes; aero_viterbi_max_t gives the cap, 23240 on an H100).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int POLY0 = 109;
constexpr int POLY1 = 79;
static_assert((POLY0 & 0x41) == 0x41 && (POLY1 & 0x41) == 0x41 &&
                  (POLY0 & 0x20) && !(POLY1 & 0x20),
              "the branch-metric masks below assume these taps");

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// dynamic shared memory: [mbarrier: 16][decisions: 16 per pair of steps]
// [soft bytes: 2T + 15]
__host__ __device__ constexpr int n_pairs(int T) { return (T + 1) / 2; }
__host__ __device__ constexpr size_t dec_offset() { return 16; }
__host__ __device__ constexpr size_t soft_offset(int T) {
  return 16 + (size_t)16 * n_pairs(T);
}
__host__ __device__ constexpr size_t smem_bytes(int T) {
  return soft_offset(T) + round16((size_t)2 * T + 15);
}

__device__ __forceinline__ int pattern_of(int ns, int j) {
  // expected output pair (o0*2 + o1) on the transition ps -> ns
  int ps = (ns >> 1) | (j << 5);
  int reg = ((ps << 1) | (ns & 1)) & 0x7F;
  return ((__popc(reg & POLY0) & 1) << 1) | (__popc(reg & POLY1) & 1);
}

__device__ __forceinline__ unsigned spread16(unsigned x) {
  // bit i of the low 16 bits -> bit 2i
  x &= 0xffffu;
  x = (x | (x << 8)) & 0x00ff00ffu;
  x = (x | (x << 4)) & 0x0f0f0f0fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

__device__ __forceinline__ uint2 state_order(unsigned bx, unsigned by) {
  // ballots of X and Y (bit L: lane L's state 2L + e) -> (states 0..31,
  // 32..63), bit s & 31 the decision of state s.  Lanes 8..15 and 24..31
  // send their odd state as X.
  constexpr unsigned XODD = 0xff00ff00u;
  const unsigned e0 = (bx & ~XODD) | (by & XODD);
  const unsigned e1 = (by & ~XODD) | (bx & XODD);
  return make_uint2(spread16(e0) | (spread16(e1) << 1),
                    spread16(e0 >> 16) | (spread16(e1 >> 16) << 1));
}

__device__ __forceinline__ void stage_soft(const uint8_t* row, int n,
                                           uint8_t* srow_base,
                                           uint64_t* bar, int lane,
                                           uint8_t** srow_out) {
  // the row lands at the same offset mod 16 as in device memory, so the
  // bulk copy's source and destination are both 16-byte aligned
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(row);
  uint8_t* srow = srow_base + (g0 & 15);
  const uintptr_t a0 = (g0 + 15) & ~(uintptr_t)15;
  const uintptr_t a1 = (g0 + n) & ~(uintptr_t)15;
  const int head = (int)min((uintptr_t)n, a0 - g0);
  const int body = a1 > a0 ? (int)(a1 - a0) : 0;
  const uint32_t bar_a = (uint32_t)__cvta_generic_to_shared(bar);
  if (body > 0 && lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_a), "r"(body)
                 : "memory");
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(srow + head);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"((uint64_t)a0), "r"(body), "r"(bar_a)
        : "memory");
  }
  for (int i = lane; i < head; i += 32) srow[i] = row[i];
  for (int i = head + body + lane; i < n; i += 32) srow[i] = row[i];
  __syncwarp();
  if (body > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar_a)
          : "memory");
    }
  }
  *srow_out = srow;
}

__global__ void __launch_bounds__(32)
viterbi_k7_kernel(const uint8_t* __restrict__ soft, int T,
                  uint8_t* __restrict__ bits) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x;
  const uint8_t* row = soft + (size_t)blockIdx.x * 2 * T;
  uint8_t* out = bits + (size_t)blockIdx.x * T;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint4* dec = reinterpret_cast<uint4*>(smem + dec_offset());
  uint8_t* srow;
  stage_soft(row, 2 * T, smem + soft_offset(T), bar, lane, &srow);

  const int o = T & 1;          // 1: a virtual first step
  const int NP = n_pairs(T);
  const int g = lane >> 1, h = lane & 1, g1 = g & 1;
  const int ex = (lane >> 3) & 1;   // the parity of the state sent as X
  // Register R_sigma holds state g + 16(sigma ^ g1).  With that, the
  // first-step dibit of candidate sigma is pa ^ (sigma&1 ? 2 : 0) ^
  // (sigma>>1 ? 3 : 0), the second-step dibit of X's candidate sigma is
  // pb ^ (sigma&1 ? 3 : 0), and Y's is its complement: 255 - s == s ^ 255
  // on a byte, so each is a mask pair.
  const int pa = pattern_of(2 * g + h, 0) ^ (g1 ? 2 : 0);
  const int pb = pattern_of(4 * g + 2 * h, 0) ^ ((g1 ^ ex) ? 3 : 0);
  const int mA0 = (pa & 2) ? 255 : 0, mA1 = (pa & 1) ? 255 : 0;
  const int mB0 = (pb & 2) ? 255 : 0, mB1 = (pb & 1) ? 255 : 0;
  const int src0 = 8 * g1 + (g >> 1), src1 = 8 * (1 ^ g1) + (g >> 1);
  const int src2 = 8 * (2 ^ g1) + (g >> 1), src3 = 8 * (3 ^ g1) + (g >> 1);

  int R0 = 0, R1 = 0, R2 = 0, R3 = 0;
  // The branch-metric sums of a pair's eight candidates (X's and Y's, by
  // register), from its four soft bytes (first step, then second): a, ap
  // (first step) and b (second step) and their complements; the first
  // step's are all zero on the virtual step.
  struct Sums {
    int x0, x1, x2, x3, y0, y1, y2, y3;
  };
  auto sums = [&](int s10, int s11, int s20, int s21, bool virt) {
    const int x0 = s10 ^ mA0, x1 = s11 ^ mA1;
    const int a = virt ? 0 : x0 + x1, na = virt ? 0 : 510 - x0 - x1;
    const int ap = virt ? 0 : x1 - x0 + 255, nap = virt ? 0 : x0 - x1 + 255;
    const int b = (s20 ^ mB0) + (s21 ^ mB1), nb = 510 - b;
    return Sums{a + b,  ap + nb, na + b,  nap + nb,
                a + nb, ap + b,  na + nb, nap + b};
  };
  // One pair of steps, its sums computed ahead; lane 0 stores the four
  // raw ballots of its decisions.
  auto pair_step = [&](int p, const Sums& S) {
    const int cx0 = R0 + S.x0, cx1 = R1 + S.x1;
    const int cx2 = R2 + S.x2, cx3 = R3 + S.x3;
    const int cy0 = R0 + S.y0, cy1 = R1 + S.y1;
    const int cy2 = R2 + S.y2, cy3 = R3 + S.y3;
    const int mx0 = min(cx0, cx2), mx1 = min(cx1, cx3);
    const int my0 = min(cy0, cy2), my1 = min(cy1, cy3);
    const int X = min(mx0, mx1), Y = min(my0, my1);
    // decisions: tg, the candidates sigma = 1, 3 won (a tie goes to group
    // j2 = 0: sigma = g1, g1 + 2); j1, within the winning group, sigma + 2
    // only if strictly smaller.  j2 = tg ^ g1 is applied to the ballot in
    // the fixup below.
    const bool tgx = mx1 < mx0 + g1, tgy = my1 < my0 + g1;
    const bool j1x = (tgx ? cx3 : cx2) < (tgx ? cx1 : cx0);
    const bool j1y = (tgy ? cy3 : cy2) < (tgy ? cy1 : cy0);
    const unsigned bx2 = __ballot_sync(FULL, tgx);
    const unsigned by2 = __ballot_sync(FULL, tgy);
    const unsigned bx1 = __ballot_sync(FULL, j1x);
    const unsigned by1 = __ballot_sync(FULL, j1y);
    R0 = __shfl_sync(FULL, X, src0);
    R1 = __shfl_sync(FULL, Y, src1);
    R2 = __shfl_sync(FULL, X, src2);
    R3 = __shfl_sync(FULL, Y, src3);
    if (lane == 0) dec[p] = make_uint4(bx2, by2, bx1, by1);
  };

  // pair p's soft bytes are steps 2p - o and 2p + 1 - o (the virtual step
  // of an odd T has none); they are read two pairs ahead and summed one
  // pair ahead, so neither the loads nor the sums sit on the chain
  int p = 0;
  if (o) {
    pair_step(0, sums(0, 0, srow[0], srow[1], true));
    p = 1;
  }
  auto bytes_of = [&](int pp) {
    return srow + 4 * min(pp, NP - 1) - 2 * o;
  };
  const uint8_t* q = bytes_of(p);
  Sums S = sums(q[0], q[1], q[2], q[3], false);
  q = bytes_of(p + 1);
  int n10 = q[0], n11 = q[1], n20 = q[2], n21 = q[3];
#pragma unroll 4
  for (; p < NP; ++p) {
    const Sums Sn = sums(n10, n11, n20, n21, false);
    q = bytes_of(p + 2);
    n10 = q[0];
    n11 = q[1];
    n20 = q[2];
    n21 = q[3];
    pair_step(p, S);
    S = Sn;
  }
  __syncwarp();
  // the raw ballots -> two words in state order per pair (lane by lane);
  // the j2 ballot flips where g1 = 1 (lanes 2, 3, 6, 7, ...)
  for (int i = lane; i < NP; i += 32) {
    const uint4 r = dec[i];
    const uint2 j2 = state_order(r.x ^ 0xccccccccu, r.y ^ 0xccccccccu);
    const uint2 j1 = state_order(r.z, r.w);
    dec[i] = make_uint4(j2.x, j2.y, j1.x, j1.y);
  }

  // end state: argmin over the 64 final metrics, lowest index on ties
  // (the lane's states g + 16j in increasing j; R_sigma holds j = sigma^g1)
  int best = 0x7fffffff, best_s = 0;
  {
    const int r[4] = {R0, R1, R2, R3};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = g1 ? r[j ^ 1] : r[j];
      if (v < best) {
        best = v;
        best_s = g + 16 * j;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, best, off);
    const int os = __shfl_xor_sync(FULL, best_s, off);
    if (ov < best || (ov == best && os < best_s)) {
      best = ov;
      best_s = os;
    }
  }

  // the decision words stored by the other lanes must be visible
  __syncwarp();

  // traceback from shared memory, a pair per link, 32 pairs a chunk, every
  // lane following the same (uniform) state; lane k keeps the two bits of
  // pair base - k and stores them at the chunk's end.  Each pair's words
  // are read a pair ahead (a broadcast load, independent of the state).
  int s = best_s;
  uint4 w = dec[NP - 1];
  for (int base = NP - 1; base >= 0; base -= 32) {
    const int n = min(32, base + 1);
    unsigned my_bits = 0;   // bit 0: the pair's first step, bit 1: second
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const unsigned long long j2 =
          ((unsigned long long)w.y << 32) | (unsigned long long)w.x;
      const unsigned long long j1 =
          ((unsigned long long)w.w << 32) | (unsigned long long)w.z;
      w = dec[max(base - k - 1, 0)];
      if (lane == k) my_bits = (((unsigned)s >> 1) & 1u) | (((unsigned)s & 1u) << 1);
      s = (s >> 2) | (int)(((j2 >> s) & 1ull) << 4) |
          (int)(((j1 >> s) & 1ull) << 5);
    }
    const int t = 2 * (base - lane) - o;   // the pair's first step
    if (base - lane >= 0) {
      if (t >= 0) out[t] = (uint8_t)(my_bits & 1u);
      out[t + 1] = (uint8_t)(my_bits >> 1);
    }
  }
}

}  // namespace

// The largest T whose block (one stream) fits the opt-in dynamic shared
// memory of one block on the given device; -cudaError on failure.
extern "C" int aero_viterbi_max_t(int device) {
  int optin = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int)e;
  // smem_bytes(T) > 10 T, so the search starts at optin / 10
  int T = optin / 10;
  while (T > 0 && smem_bytes(T) > (size_t)optin) --T;
  return T;
}

// soft: uint8 [B, 2T] contiguous on the device; bits: uint8 [B, T].
// One block of one warp per stream.  Returns cudaGetLastError().
extern "C" int aero_viterbi_decode_soft_cuda(const uint8_t* soft, int B,
                                             int T, uint8_t* bits,
                                             void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const size_t smem = smem_bytes(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_k7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  viterbi_k7_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      soft, T, bits);
  return (int)cudaGetLastError();
}
