"""Host I/O: output formats and TCP/UDP forwarders (verbatim copies of
``aero_tpu.io.output`` and ``aero_tpu.io.forwarder``)."""
