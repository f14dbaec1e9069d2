"""Port parity: the Viterbi decoder, batched frame decoding and the bank.

All comparisons here are BIT-EXACT: the plain-torch decoder keeps JAX's
arithmetic order (branch metrics, cand = pm[pred] + bm[pattern], keep
predecessor 1 only if cand1 < cand0, subtract the row minimum, argmin end
state with the lowest index on ties), so its decisions equal JAX's for any
float input, ties included.  The JAX side runs as its own tests run it on
the CPU: ``viterbi_decode_soft`` under vmap, and the Pallas kernel in
interpret mode.

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py, which imports no JAX (the card's machine has
none).  It takes uint8 soft bytes; here the wrapper's CPU path (the twin)
is held against JAX on uint8 and float32 copies of the same bytes, and
the host checks and shared-memory limits around the kernel are tested.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from aero_tpu.ops.pallas.viterbi_kernel import viterbi_decode_soft_pallas
from aero_tpu.protocol import batch_framing as jbf
from aero_tpu.protocol.viterbi import viterbi_decode_soft as j_decode
from aero_tpu_torch.ops import viterbi_kernel as vk
from aero_tpu_torch.protocol import batch_framing as tbf
from aero_tpu_torch.protocol.crc import append_crc16_bytes
from aero_tpu_torch.protocol.framing import (FRAME_SPECS, PChannelFramer,
                                             build_p_frames)
from aero_tpu_torch.protocol.interleaver import deinterleave_indices
from aero_tpu_torch.protocol.viterbi import viterbi_decode_soft
from torch_soft import soft_bytes

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["integral", "float", "all128"])
def test_plain_decoder_bit_exact_vs_jax_and_pallas(kind):
    B, T = 5, 156                       # T a multiple of the Pallas chunk
    soft = soft_bytes(kind, B, T)
    got = viterbi_decode_soft(torch.from_numpy(soft)).numpy()
    want_scan = np.asarray(jax.vmap(j_decode)(jnp.asarray(soft)))
    want_pallas = np.asarray(viterbi_decode_soft_pallas(
        jnp.asarray(soft), chunk=52, interpret=True))
    assert got.dtype == np.uint8 and got.shape == (B, T)
    np.testing.assert_array_equal(got, want_scan)
    np.testing.assert_array_equal(got, want_pallas)


def test_wrapper_on_cpu_is_the_plain_decoder():
    soft = torch.from_numpy(soft_bytes("integral", 3, 100, seed=4))
    before = vk.LAUNCHES
    np.testing.assert_array_equal(vk.viterbi_decode_soft_cuda(soft).numpy(),
                                  viterbi_decode_soft(soft).numpy())
    assert vk.LAUNCHES == before        # the count is of kernel launches
    with pytest.raises(TypeError):
        vk.viterbi_decode_soft_cuda(soft.numpy())


@pytest.mark.parametrize("kind", ["integral", "random", "extreme"])
def test_wrapper_on_uint8_and_float32_matches_jax(kind):
    B, T = 4, 131
    soft = soft_bytes(kind, B, T, seed=11)
    want = np.asarray(jax.vmap(j_decode)(jnp.asarray(soft, jnp.float32)))
    for dt in (torch.uint8, torch.float32):
        got = vk.viterbi_decode_soft_cuda(torch.from_numpy(soft).to(dt))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(dt))


def test_host_soft_bytes_check():
    dec = vk.stream_decoder("cpu")
    soft = soft_bytes("random", 1, 40, seed=2)[0]
    want = viterbi_decode_soft(torch.from_numpy(soft)[None])[0].numpy()
    np.testing.assert_array_equal(dec(soft.astype(np.float32)), want)
    np.testing.assert_array_equal(dec(soft.astype(np.int16)), want)
    for bad in (0.5, -1.0, 256.0, np.nan):
        row = soft.astype(np.float32)
        row[7] = bad
        with pytest.raises(ValueError):
            dec(row)


def test_kernel_shared_memory_limit():
    """The shared-memory bound on T is the card's alone: a CPU tensor
    longer than any H100 block holds (T > 23240) goes to the twin, and
    neither the kernel's library nor its bound is asked for."""
    lib, cached = vk._lib, dict(vk._max_t)
    soft = torch.from_numpy(soft_bytes("random", 1, 24000, seed=5))
    np.testing.assert_array_equal(vk.viterbi_decode_soft_cuda(soft).numpy(),
                                  viterbi_decode_soft(soft).numpy())
    assert vk._lib is lib and vk._max_t == cached


def _frames(rate, n_fields, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    per = FRAME_SPECS[rate].payload_info_bits // 96
    fields = [b"".join(append_crc16_bytes(
        bytes([0x71] + list(rng.integers(0, 256, 9)))) for _ in range(per))
        for _ in range(n_fields)]
    bits = build_p_frames(fields, rate, lead_frames=1)
    soft = np.clip(bits.astype(np.float32) * 255
                   + rng.normal(0, noise, len(bits)), 0, 255)
    return fields, soft.astype(np.float32)


@pytest.mark.parametrize("rate,pre_deint", [(600, False), (1200, False),
                                            (1200, True)])
def test_batch_decode_p_frames_bit_exact(rate, pre_deint):
    spec = FRAME_SPECS[rate]
    fields, soft = _frames(rate, 4, seed=rate, noise=60.0)
    tb, hb = spec.total_bits, spec.header_bits
    didx = deinterleave_indices(spec.cols)
    payloads, prefixes = [], []
    prev_tail = np.full(62, 128.0, np.float32)
    for j in range(len(soft) // tb):
        pay = soft[j * tb + hb: j * tb + hb + spec.payload_soft_bits]
        de = np.concatenate(
            [pay[b * 64 * spec.cols:(b + 1) * 64 * spec.cols][didx]
             for b in range(spec.blocks_per_frame)])
        payloads.append(de if pre_deint else pay)
        prefixes.append(prev_tail.copy())
        prev_tail = de[-62:]
    payloads, prefixes = np.stack(payloads), np.stack(prefixes)
    want = jbf.batch_decode_p_frames(jnp.asarray(payloads),
                                     jnp.asarray(prefixes), rate=rate,
                                     pre_deinterleaved=pre_deint)
    got = tbf.batch_decode_p_frames(torch.from_numpy(payloads),
                                    torch.from_numpy(prefixes), rate=rate,
                                    pre_deinterleaved=pre_deint)
    np.testing.assert_array_equal(got["info_bits"].numpy(),
                                  np.asarray(want["info_bits"]))
    np.testing.assert_array_equal(got["su_ok"].numpy(),
                                  np.asarray(want["su_ok"]))
    assert got["su_ok"].numpy()[1:-1].any()


def test_batch_decode_p_frames_uint8_as_on_the_card():
    """The card's buffer is uint8 (prefixes | payload | 128s): whole-byte
    payloads decode the same in uint8 as in float32, and as in JAX."""
    rate = 1200
    spec = FRAME_SPECS[rate]
    rng = np.random.default_rng(3)
    payloads = rng.integers(0, 256, (5, spec.payload_soft_bits),
                            dtype=np.uint8)
    prefixes = rng.integers(0, 256, (5, 62), dtype=np.uint8)
    want = jbf.batch_decode_p_frames(jnp.asarray(payloads, jnp.float32),
                                     jnp.asarray(prefixes, jnp.float32),
                                     rate=rate)
    for dt in (torch.uint8, torch.float32):
        got = tbf.batch_decode_p_frames(torch.from_numpy(payloads).to(dt),
                                        torch.from_numpy(prefixes).to(dt),
                                        rate=rate)
        np.testing.assert_array_equal(got["info_bits"].numpy(),
                                      np.asarray(want["info_bits"]))
        np.testing.assert_array_equal(got["su_ok"].numpy(),
                                      np.asarray(want["su_ok"]))


def test_crc16_check_batch_matches_jax():
    rng = np.random.default_rng(6)
    su = rng.integers(0, 2, size=(64, 96)).astype(np.float32)
    su[:8] = np.stack([np.unpackbits(np.frombuffer(append_crc16_bytes(
        bytes(rng.integers(0, 256, 10, dtype=np.uint8).tolist())),
        np.uint8), bitorder="little") for _ in range(8)])
    got = tbf.crc16_check_batch(torch.from_numpy(su)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jbf.crc16_check_batch(jnp.asarray(su))))
    assert got[:8].all()


def test_bank_events_match_jax_bank():
    """The inputs of tests/test_batch_framing.py::test_bank_matches_
    sequential: 3 noisy VFO streams (one inverted), fed in 777-bit chunks
    to JAX's bank and the port's; every event field must agree."""
    rng = np.random.default_rng(7)
    rate = 1200
    streams = {}
    for v in range(3):
        fields = [b"".join(append_crc16_bytes(
            bytes([0x71] + list(rng.integers(0, 256, 9))))
            for _ in range(6)) for _ in range(3)]
        bits = build_p_frames(fields, rate, lead_frames=1 + v)
        soft = np.clip(bits.astype(np.float32) * 255
                       + rng.normal(0, 20, len(bits)), 0, 255)
        if v == 1:
            soft = 255.0 - soft
        streams[f"V{v}"] = np.concatenate(
            [rng.integers(0, 256, 333).astype(np.float32), soft])

    jbank = jbf.BatchPChannelFramerBank(rate, list(streams))
    tbank = tbf.BatchPChannelFramerBank(rate, list(streams), device="cpu")
    got_j = {t: [] for t in streams}
    got_t = {t: [] for t in streams}
    for i in range(0, max(len(s) for s in streams.values()), 777):
        chunk = {t: s[i:i + 777] for t, s in streams.items()}
        for t, evs in jbank.feed(chunk).items():
            got_j[t].extend(evs)
        for t, evs in tbank.feed(chunk).items():
            got_t[t].extend(evs)
    for t in streams:
        assert len(got_t[t]) == len(got_j[t]) > 0, t
        for a, b in zip(got_t[t], got_j[t]):
            assert a.infofield == b.infofield, t
            assert list(a.su_crc_ok) == list(b.su_crc_ok), t
            assert (a.frameinfo, a.uw_errors, a.frame_index) == \
                (b.frameinfo, b.uw_errors, b.frame_index), t
        assert tbank.framers[t].dcd_count == jbank.framers[t].dcd_count
    # and the port's bank agrees with the port's sequential framer
    seq = PChannelFramer(rate)
    evs = []
    for i in range(0, len(streams["V0"]), 777):
        evs += seq.feed(streams["V0"][i:i + 777])
    assert [e.infofield for e in evs] == [e.infofield for e in got_t["V0"]]
