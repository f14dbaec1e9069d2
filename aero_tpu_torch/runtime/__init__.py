"""Process runtimes: the fused and classic stations, checkpoints, the
single-VFO decoder, and the station, decode and publish CLIs."""
