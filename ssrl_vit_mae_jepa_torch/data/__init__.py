"""The STL-10 data path of the PyTorch port."""
