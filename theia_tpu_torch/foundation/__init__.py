"""Teacher registry of the PyTorch port (the towers themselves are not ported yet)."""
