"""The generated host bridge: C ABI <-> embedded Python <-> the port
(geosongpu_tpu/interop)."""
