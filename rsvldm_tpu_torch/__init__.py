"""PyTorch/CUDA port of rsvldm_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths. Modules are NCHW inside; the public
functions that are held against the JAX package take its layout. Entry
points run on CUDA unless the caller passes device="cpu". The one
hand-written kernel of this slice, flash-attention forward (K1), lives in
csrc/flash_fwd.cu and is built with nvcc at first use.
"""
