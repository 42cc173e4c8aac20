"""Command-line programs of the PyTorch port, each run as
``python -m amgx_tpu_torch.examples.<name>``: ``amgx_capi`` (solve
through the C API), ``spmv_test`` (one SpMV against the host product)
and ``convert`` (MatrixMarket <-> ``%%NVAMGBinary``)."""
