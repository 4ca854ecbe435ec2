"""cfg of the PyTorch port."""
