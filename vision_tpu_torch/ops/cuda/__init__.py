"""Hand-written Hopper kernels (sources in vision_tpu_torch/csrc/) and their
wrappers, one module each, each with a module-level ``launches`` count.
Importing builds nothing: the kernel library is compiled with nvcc at its
first launch (cuda/build.py)."""
