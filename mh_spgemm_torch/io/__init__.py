"""Matrix Market I/O and benchmark suite definitions."""
