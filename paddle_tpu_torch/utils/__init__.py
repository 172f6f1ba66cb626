"""Host utilities of the PyTorch port."""
