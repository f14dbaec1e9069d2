"""Host utilities of the port (copies of jax-free ``aero_tpu.utils``
modules)."""
