"""The port's kernels: hand-written CUDA for sm_90a (``csrc/``), their
ctypes wrappers, their plain PyTorch versions (``ref``) and the dispatching
entry points (``ops``)."""
