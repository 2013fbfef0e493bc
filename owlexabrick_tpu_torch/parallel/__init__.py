"""Multi-device modes over torch.distributed (PyTorch port)."""
