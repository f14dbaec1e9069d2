"""aero-tpu on PyTorch + CUDA: the port of ``aero_tpu`` to an NVIDIA H100.

The JAX package ``aero_tpu`` stays the reference; this package mirrors its
layout and names so each module's counterpart is found at the same path:

- ``aero_tpu_torch.device``      device selection (no silent CPU fallback)
                                 and full-fp32 math on the card.
- ``aero_tpu_torch.ops``         NCO, streaming FIR, block statistics, and
                                 the hand-written CUDA Viterbi kernel
                                 (``ops/viterbi_kernel.py`` +
                                 ``csrc/viterbi.cu``).
- ``aero_tpu_torch.models``      the continuous MSK and OQPSK
                                 demodulators, batched over a VFO axis,
                                 their coarse-frequency estimator, and the
                                 burst (R/T) window demodulators.
- ``aero_tpu_torch.channelizer`` the tree channelizer (NCO mix, halfband
                                 cascades, USB demod) and the WOLA
                                 polyphase filterbank.
- ``aero_tpu_torch.protocol``    Viterbi (plain torch twin + host streaming
                                 decoder), batched P-channel framing, the
                                 R/T framer with an injected decoder, and
                                 verbatim copies of the jax-free framers
                                 and ACARS application decoders.
- ``aero_tpu_torch.parallel``    batched demod banks on one device.
- ``aero_tpu_torch.runtime``     the fused and classic stations, their
                                 checkpoints (the JAX format), the
                                 single-VFO decoder, and the station,
                                 decode and publish CLIs.
- ``aero_tpu_torch.native``      the host C++ libraries (ingest quantizers,
                                 the streaming Viterbi), copies of
                                 ``aero_tpu/native``'s sources, built
                                 with g++ into ``build/aero_tpu_torch/``.
- ``aero_tpu_torch.utils``       the CLIs' signal notifier, logging, the
                                 CUDA-graph steps and the tracer.
- ``aero_tpu_torch.convert``     carries JAX state trees into the port and
                                 back (the parity tests' teacher forcing,
                                 the checkpoints' leaf order).

The package imports ``torch``, numpy and scipy, never ``jax``, and nothing
of ``aero_tpu``: where it needs a jax-free module of the reference it
keeps its own copy, held equal by tests/test_torch_imports.py.
"""

__version__ = "0.1.0"
