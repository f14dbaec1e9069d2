"""DSP primitives on torch tensors ([..., T] blocks, leading batch axes),
counterparts of ``aero_tpu.ops``, plus the CUDA Viterbi kernel wrapper."""
