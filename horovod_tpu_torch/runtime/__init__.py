"""Runtime identity and configuration of the PyTorch port."""
