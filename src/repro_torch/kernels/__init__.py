"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes wrappers,
their plain PyTorch versions (``ref``) and the device dispatch (``ops``)."""
