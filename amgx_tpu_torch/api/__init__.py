"""The AMGX_* C API of the port: ``capi`` (handle layer) and the native
shim in ``amgx_tpu_torch/native`` that embeds it."""
