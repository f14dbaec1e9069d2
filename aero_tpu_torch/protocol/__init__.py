"""Aero-L protocol: the Viterbi decoder (plain torch + CUDA kernel),
batched P-channel framing, and verbatim copies of the jax-free framers,
CRC, scrambler, interleaver and ISU/ACARS reassembly of
``aero_tpu.protocol``."""
