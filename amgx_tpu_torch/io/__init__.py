"""io layer of the PyTorch port."""
