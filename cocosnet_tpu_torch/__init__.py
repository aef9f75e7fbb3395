"""PyTorch/CUDA port of cocosnet_tpu: the same modules, in ordinary PyTorch,
with the TPU Pallas kernels rewritten by hand in CUDA C++ for Hopper
(csrc/). It imports nothing of JAX or of cocosnet_tpu."""
