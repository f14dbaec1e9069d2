"""Demodulators ("models") on torch: the continuous MSK and OQPSK
demodulators and their coarse-frequency estimator, batched over a VFO
axis, and the burst (R/T) window demodulators."""
