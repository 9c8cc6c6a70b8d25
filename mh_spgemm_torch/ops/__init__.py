"""Device operators of the PyTorch port (bucketed engine, ESC tail)."""
