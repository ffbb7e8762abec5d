"""The plain reference of the benchmark: the pipeline's models, samplers
and the caption's decoder in plain torch, computed in fp32 with TF32 off
on the same bf16 weights and the same JAX key chain as the port. A frozen
copy of the port's modules with every hand-written kernel (flash
attention, the int4 decode product, the threefry draws) written out in
plain torch and every CUDA graph replaced by direct calls; it imports
nothing of the program."""
