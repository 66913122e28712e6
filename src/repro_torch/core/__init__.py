"""Host-side and batched device SPECTRA algorithms of the PyTorch port."""
