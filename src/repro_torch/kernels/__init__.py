# Hopper kernels (CUDA C++ in ../csrc, built with nvcc at first use) for the
# JAX package's Pallas kernels, each beside its plain PyTorch version.
