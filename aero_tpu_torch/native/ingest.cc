// Native host ingest: DC correction + IQ quantization.
//
// The reference's SDR reader thread (ref: publish/publisher.cpp:234-306)
// pulls CF32 blocks, applies a one-pole DC tracker and hands samples to the
// channelizer.  In aero-tpu the channelizer lives on the device, so the
// host's ingest job is: correct DC, quantize to the wire dtype (int4 packed
// nibbles / int8 / int16) and ship bytes.  numpy does this in ~21 ms per
// 1M-sample block — comparable to the device step itself — so the hot
// conversions are native.  Semantics match the numpy reference paths
// bit-exactly (tests/test_native_ingest.py):
//   int4 : clip(round_half_even(x*scale), -8, 7); re<<4 | im  (one byte/sample)
//   int8 : trunc(clip(x*scale, -scale, scale))   planar [2][n]
//   int16: trunc(clip(x*scale, -scale, scale))   planar [2][n]
//
// Build: g++ -O3 -march=native -shared -fPIC (aero_tpu/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// One-pole DC tracker over interleaved complex float32 (re,im,re,im,...).
// dc[2] carries {re, im} state across blocks.  In-place.
// Equivalent per-sample form of the reference's correction
// (publisher.cpp:292-296): dc += alpha * (x - dc); x -= dc.
void aero_dc_correct(float *iq, long n, float alpha, float *dc) {
  float dre = dc[0], dim = dc[1];
  for (long i = 0; i < n; i++) {
    dre += alpha * (iq[2 * i] - dre);
    dim += alpha * (iq[2 * i + 1] - dim);
    iq[2 * i] -= dre;
    iq[2 * i + 1] -= dim;
  }
  dc[0] = dre;
  dc[1] = dim;
}

// Interleaved complex float32 -> packed two's-complement nibbles,
// re in the high nibble (the reference's IQ compress layout,
// ref: publish/vfo.cpp:262-275).  n samples -> n bytes.
void aero_quantize_int4(const float *iq, long n, float scale,
                        unsigned char *out) {
  for (long i = 0; i < n; i++) {
    float re = nearbyintf(iq[2 * i] * scale);       // round half to even,
    float im = nearbyintf(iq[2 * i + 1] * scale);   // matches numpy round
    int r = (int)re;
    int m = (int)im;
    r = r < -8 ? -8 : (r > 7 ? 7 : r);
    m = m < -8 ? -8 : (m > 7 ? 7 : m);
    out[i] = (unsigned char)(((r & 0xF) << 4) | (m & 0xF));
  }
}

// Interleaved complex float32 -> 2-bit sign-magnitude codes, two complex
// samples per byte: [s0.re s0.im s1.re s1.im] from the MSB.  Per arm:
// bit1 = sign (1 = non-negative), bit0 = |x| >= sigma (the classic 2-bit
// radio quantizer: levels {-3,-1,+1,+3} * 0.47 sigma, ~0.55 dB SNR cost
// for Gaussian input).  sigma is the per-arm RMS measured on the host and
// shipped alongside the block.  n samples (even) -> n/2 bytes.
void aero_quantize_int2(const float *iq, long n, float sigma,
                        unsigned char *out) {
  for (long i = 0; i < n / 2; i++) {
    unsigned b = 0;
    for (int k = 0; k < 4; k++) {
      float v = iq[4 * i + k];
      unsigned code = ((v >= 0.0f) ? 2u : 0u) | ((fabsf(v) >= sigma) ? 1u : 0u);
      b = (b << 2) | code;
    }
    out[i] = (unsigned char)b;
  }
}

// Interleaved complex float32 -> planar int8 [2][n] (re plane then im
// plane), truncation toward zero after clipping (numpy .astype semantics).
void aero_quantize_int8(const float *iq, long n, float scale,
                        signed char *out) {
  signed char *re = out, *im = out + n;
  for (long i = 0; i < n; i++) {
    float r = iq[2 * i] * scale;
    float m = iq[2 * i + 1] * scale;
    r = r < -scale ? -scale : (r > scale ? scale : r);
    m = m < -scale ? -scale : (m > scale ? scale : m);
    re[i] = (signed char)r;
    im[i] = (signed char)m;
  }
}

// Interleaved complex float32 -> planar int16 [2][n].
void aero_quantize_int16(const float *iq, long n, float scale,
                         int16_t *out) {
  int16_t *re = out, *im = out + n;
  for (long i = 0; i < n; i++) {
    float r = iq[2 * i] * scale;
    float m = iq[2 * i + 1] * scale;
    r = r < -scale ? -scale : (r > scale ? scale : r);
    m = m < -scale ? -scale : (m > scale ? scale : m);
    re[i] = (int16_t)r;
    im[i] = (int16_t)m;
  }
}

// int16 PCM -> float32 audio (ZMQ SUB payloads, decode hot path:
// every VFO's audio crosses this conversion once per block).
void aero_pcm16_to_f32(const int16_t *pcm, long n, float *out) {
  const float k = 1.0f / 32768.0f;
  for (long i = 0; i < n; i++) out[i] = pcm[i] * k;
}

}  // extern "C"
