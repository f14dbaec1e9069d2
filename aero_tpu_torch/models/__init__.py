"""Demodulators ("models") on torch: the continuous MSK demodulator and
its coarse-frequency estimator, batched over a VFO axis."""
