"""Aero-L 64-row block interleaver as precomputed gather permutations.

The reference deinterleaves with nested loops per block
(ref: decode/aerol.cpp:526-686).  Here each layout is a static permutation
index array computed once; applying it is a single gather, batchable over
frames/VFOs on host (numpy) or device (jnp.take).

Layouts:
- P/C-channel: 64 rows x N cols, row permutation row=(i*27) mod 64, read out
  column-major over depermuted rows (ref: aerol.cpp:533-537, 594-613).
- R/T burst MSK: first 5 columns as one block, then groups of 3 columns
  (ref: aerol.cpp:651-686).
- Depuncture pattern P: insert a neutral (128) soft bit after every P-1
  source bits, dropping the final source bit (ref: aerol.cpp:2432-2446).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

M = 64
_DEPERM = np.array([(i * 27) % M for i in range(M)], dtype=np.int64)
# interleaverowpermute[(i*27)%64] = i  (ref: aerol.cpp:533-537)
_PERM = np.empty(M, dtype=np.int64)
_PERM[_DEPERM] = np.arange(M)


@lru_cache(maxsize=None)
def deinterleave_indices(cols: int) -> np.ndarray:
    """out[k] = in[idx[k]] with idx from the reference's readout order:
    for col j, rows (i*27)%64; input laid out row-major [64, cols]."""
    idx = np.empty(M * cols, dtype=np.int64)
    k = 0
    for j in range(cols):
        for i in range(M):
            idx[k] = _DEPERM[i] * cols + j
            k += 1
    return idx


@lru_cache(maxsize=None)
def interleave_indices(cols: int) -> np.ndarray:
    """Inverse permutation of deinterleave_indices (transmit order)."""
    d = deinterleave_indices(cols)
    inv = np.empty_like(d)
    inv[d] = np.arange(len(d))
    return inv


@lru_cache(maxsize=None)
def deinterleave_msk_burst_indices(blocks: int) -> np.ndarray:
    """Burst-MSK layout: one 5-col block then (blocks-5)/3 3-col groups
    (ref: aerol.cpp:651-686).  ``blocks`` counts 64-bit rows received."""
    idx = np.empty(M * blocks, dtype=np.int64)
    k = 0
    for j in range(5):
        for i in range(M):
            idx[k] = _DEPERM[i] * 5 + j
            k += 1
    procblocks = 5
    while k < blocks * M:
        for j in range(3):
            for i in range(M):
                idx[k] = M * procblocks + _DEPERM[i] * 3 + j
                k += 1
        procblocks += 3
    return idx


def depuncture_soft(soft, pattern: int) -> np.ndarray:
    """Insert neutral-128 soft bits per the reference's depuncture loop
    (ref: aerol.cpp:2432-2446): iterates source[:-1], appends each bit, and a
    128 after every pattern-1 bits."""
    soft = np.asarray(soft)
    src = soft[:-1]
    n = len(src)
    p = pattern - 1
    n_groups = n // p
    out_len = n + n_groups
    out = np.full(out_len, 128, dtype=soft.dtype)
    keep = np.ones(out_len, dtype=bool)
    keep[(np.arange(n_groups) + 1) * pattern - 1] = False
    out[keep] = src
    return out


def puncture_soft(soft, pattern: int) -> np.ndarray:
    """Inverse of depuncture (drop every pattern-th bit) for the modulator."""
    soft = np.asarray(soft)
    keep = np.ones(len(soft), dtype=bool)
    keep[pattern - 1:: pattern] = False
    return soft[keep]
