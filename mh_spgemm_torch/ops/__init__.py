"""Device operators of the PyTorch port: the bucketed and block-dense
engines, the masked classes, the kernels' wrappers, and the DeviceCSR-level
stages (expand, symbolic, numeric, binning)."""
