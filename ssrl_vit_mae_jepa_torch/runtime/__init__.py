"""Native (C++) host-side data-path code of the PyTorch port."""
