"""Aero-L protocol: the Viterbi decoder (plain torch + CUDA kernel),
batched P-channel framing, the R/T burst framer (a copy whose checkpoint
decoder is injected), and verbatim copies of the jax-free framers (P and
C channel), CRC, scrambler, interleaver, ISU/ACARS reassembly and the
ACARS application decoders (ADS-C, CPDLC and FANS over ARINC 622) of
``aero_tpu.protocol``."""
