"""Aero-L protocol: the Viterbi decoder (plain torch + CUDA kernel),
batched P-channel framing, the R/T burst framer (a copy whose checkpoint
decoder is injected), and verbatim copies of the jax-free framers (P and
C channel), CRC, scrambler, interleaver and ISU/ACARS reassembly of
``aero_tpu.protocol``."""
