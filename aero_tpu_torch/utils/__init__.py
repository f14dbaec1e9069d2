"""Host utilities of the port: the signal notifier and logging (copies of
jax-free ``aero_tpu.utils`` modules) and profiling helpers."""
