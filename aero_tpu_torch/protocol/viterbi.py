"""Soft-decision Viterbi for the Aero-L convolutional code (torch).

Counterpart of ``aero_tpu/protocol/viterbi.py``: K=7, rate 1/2,
polynomials {109, 79}; the shift register takes the newest bit at the LSB,
output bit i = parity(r & poly[i]).  Soft bits are bytes: 0 = strong zero,
255 = strong one, 128 = erasure.

``viterbi_decode_soft`` here is the plain-torch twin of the CUDA kernel
(``ops/viterbi_kernel.py``): a Python loop over time doing [B, 64] tensor
ops, then a ``gather`` traceback.  It keeps JAX's arithmetic order exactly
(``cand_j = pm[pred_j] + bm[pattern_j]``, keep predecessor 1 only when
``cand1 < cand0``, subtract the row minimum), so it is bit-exact with the
JAX decoder for any float input.  It is the CPU path and the kernel's
oracle; on the card the main path runs the kernel.

``StreamingViterbi`` is the host decoder of the sequential framers: it
uses the port's native C++ decoder (``aero_tpu_torch.native``) and falls
back to the plain-torch decoder on the CPU where no C++ toolchain is
present.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLYS = (109, 79)
K = 7
NSTATES = 64


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return (x & 1).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _tables(polys=POLYS):
    """Static transition tables.

    PRED[ns, j]    : the two predecessor states of next-state ns
    PATTERN[ns, j] : expected output pair (o0*2+o1) on that transition
    """
    pred = np.empty((NSTATES, 2), dtype=np.int32)
    pattern = np.empty((NSTATES, 2), dtype=np.int32)
    for ns in range(NSTATES):
        b = ns & 1
        for j, ps in enumerate((ns >> 1, (ns >> 1) | 0x20)):
            reg = ((ps << 1) | b) & 0x7F
            o0 = int(_parity(np.uint32(reg & polys[0])))
            o1 = int(_parity(np.uint32(reg & polys[1])))
            pred[ns, j] = ps
            pattern[ns, j] = o0 * 2 + o1
    return pred, pattern


def conv_encode(bits, polys=POLYS, init_register: int = 0) -> np.ndarray:
    """Encode bits -> 2x coded bits (numpy, used by the modulator/tests)."""
    bits = np.asarray(bits, dtype=np.uint8)
    out = np.empty(2 * len(bits), dtype=np.uint8)
    r = init_register & 0x7F
    for i, b in enumerate(bits):
        r = ((r << 1) | int(b)) & 0x7F
        out[2 * i] = _parity(np.uint32(r & polys[0]))
        out[2 * i + 1] = _parity(np.uint32(r & polys[1]))
    return out


@functools.lru_cache(maxsize=None)
def _tables_on(device):
    pred, pattern = _tables()
    return (torch.from_numpy(pred.astype(np.int64)).to(device),
            torch.from_numpy(pattern.astype(np.int64)).to(device))


def branch_metrics(soft):
    """soft [B, 2T] -> [B, T, 4] L1 metrics |s - e*255| per expected dibit
    (00, 01, 10, 11), in the JAX order of operations."""
    s = soft.reshape(soft.shape[0], -1, 2)
    s0, s1 = s[..., 0], s[..., 1]
    return torch.stack([s0 + s1, s0 + (255.0 - s1),
                        (255.0 - s0) + s1, (255.0 - s0) + (255.0 - s1)],
                       dim=-1)


def viterbi_decode_soft(soft):
    """Decode B streams of soft bytes: soft [B, 2T] float32 -> bits [B, T]
    uint8 (plain torch; unknown start state, end state = argmin metric
    with the lowest index on ties, as ``jnp.argmin``)."""
    soft = torch.as_tensor(soft, dtype=torch.float32)
    B = soft.shape[0]
    T = soft.shape[1] // 2
    pred, pattern = _tables_on(soft.device)
    bm = branch_metrics(soft).transpose(0, 1).contiguous()    # [T, B, 4]
    pm = torch.zeros((B, NSTATES), dtype=torch.float32, device=soft.device)
    surv = torch.empty((T, B, NSTATES), dtype=torch.bool,
                       device=soft.device)
    for t in range(T):
        cand0 = pm[:, pred[:, 0]] + bm[t][:, pattern[:, 0]]
        cand1 = pm[:, pred[:, 1]] + bm[t][:, pattern[:, 1]]
        take1 = cand1 < cand0
        pm_new = torch.where(take1, cand1, cand0)
        pm = pm_new - torch.amin(pm_new, dim=1, keepdim=True)
        surv[t] = take1
    state = torch.argmin(pm, dim=1)                           # [B]
    bits = torch.empty((B, T), dtype=torch.uint8, device=soft.device)
    for t in range(T - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.uint8)
        j = torch.gather(surv[t], 1, state[:, None])[:, 0].long()
        state = pred[state, j]
    return bits


class StreamingViterbi:
    """Continuous decoding with history carry, aligned to chunk boundaries.

    Each call decodes one chunk of soft bytes (even length) and returns
    len(chunk)//2 bits corresponding exactly to that chunk.  62 soft bits of
    history warm the trellis; 48 neutral soft bits give the tail lookahead
    (matching the reference's overlap/padding economy,
    ref: jconvolutionalcodec.cpp:146-198).
    """

    HISTORY = 62
    LOOKAHEAD = 48

    def __init__(self):
        self._carry = np.full(self.HISTORY, 128, dtype=np.float32)

    def reset(self):
        self._carry[:] = 128

    def decode(self, soft_chunk) -> np.ndarray:
        soft_chunk = np.asarray(soft_chunk, dtype=np.float32)
        assert soft_chunk.size % 2 == 0
        buf = np.concatenate(
            [self._carry, soft_chunk,
             np.full(self.LOOKAHEAD, 128, dtype=np.float32)])
        # single-frame host decodes go through the native C++ decoder when
        # available (aero_tpu_torch/native); batched decodes use the CUDA
        # kernel
        from aero_tpu_torch import native
        if native.have_native():
            bits = native.viterbi_decode_soft_native(buf)
        else:
            bits = viterbi_decode_soft(torch.from_numpy(buf)[None])[0].numpy()
        self._carry = soft_chunk[-self.HISTORY:].copy() if soft_chunk.size >= self.HISTORY \
            else np.concatenate([self._carry, soft_chunk])[-self.HISTORY:]
        h = self.HISTORY // 2
        return bits[h: h + soft_chunk.size // 2]
