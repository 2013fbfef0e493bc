"""The scalar numpy oracle (PyTorch port)."""
