"""The port on a CUDA card: the Viterbi kernel and the fused station.

These tests import no JAX (the card's machine has none) and skip where no
CUDA device is present.  On the card, from the repository root (the
``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

- the kernel is bit-exact against its plain-torch twin (integral, float
  and all-tie soft inputs; the frame shapes of 1200 and 10500 bps and a
  few ragged ones), counts one launch per call, and rejects what it does
  not take;
- the fused station with batch framing decodes the same ACARS on the card
  as on the CPU, through the kernel.
"""

import numpy as np
import pytest
import torch

from aero_tpu_torch.device import set_fp32_precision
from aero_tpu_torch.ops import viterbi_kernel as vk
from aero_tpu_torch.protocol.viterbi import viterbi_decode_soft
from torch_soft import soft_bytes

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    set_fp32_precision()
    return torch.device("cuda")


@pytest.mark.parametrize("B,T", [(64, 631), (256, 2551), (1, 1), (3, 33),
                                 (5, 64), (130, 95)])
def test_kernel_bit_exact_vs_plain(cuda, B, T):
    for kind in ("integral", "float", "all128"):
        soft = torch.from_numpy(soft_bytes(kind, B, T,
                                           seed=B * 7 + T)).to(cuda)
        before = vk.LAUNCHES
        got = vk.viterbi_decode_soft_cuda(soft)
        torch.cuda.synchronize()
        assert vk.LAUNCHES == before + 1
        assert got.dtype == torch.uint8 and got.shape == (B, T)
        assert torch.equal(got, viterbi_decode_soft(soft)), kind


def test_kernel_rejects_what_it_does_not_take(cuda):
    soft = torch.full((4, 20), 128.0, device=cuda)
    with pytest.raises(TypeError):
        vk.viterbi_decode_soft_cuda(soft.double())
    with pytest.raises(ValueError):
        vk.viterbi_decode_soft_cuda(soft[:, :19])
    with pytest.raises(ValueError):
        vk.viterbi_decode_soft_cuda(soft.t())


def test_station_on_card_matches_cpu(cuda):
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.fused_station import FusedStation
    from torch_station_bank import INI, make_wideband

    wb = make_wideband()
    results = {}
    for dev in ("cpu", "cuda"):
        got = []
        st = FusedStation(load_ini(INI, is_text=True), ingest_dtype="int4",
                          batch_host_framing=True, device=dev,
                          on_acars=lambda v, it: got.append((v, it.message)))
        w = np.concatenate([wb, np.zeros(2 * st.block_len, np.complex64)])
        vk.reset_launches()
        for i in range(0, len(w) - st.block_len + 1, st.block_len):
            st.process(w[i:i + st.block_len])
        st.flush()
        results[dev] = (sorted(set(got)), st.stats.frames, st.stats.su_ok,
                        st.stats.su_bad, vk.LAUNCHES > 0)
    assert ("X", "BATCH XX") in results["cuda"][0]
    assert results["cuda"][:4] == results["cpu"][:4]
    assert results["cuda"][4] and not results["cpu"][4]
