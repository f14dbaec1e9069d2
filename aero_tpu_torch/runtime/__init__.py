"""Process runtimes: the fused station and its CLI."""
