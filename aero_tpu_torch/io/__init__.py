"""Host I/O: output formats, TCP/UDP forwarders, the ZMQ wire transport
and SoapySDR ingest (verbatim copies of the jax-free ``aero_tpu.io``
modules)."""
