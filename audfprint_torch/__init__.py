"""audfprint_torch: the PyTorch/CUDA port of audfprint_tpu.

Mirrors the JAX package's module paths (ops/, models/, index/, match/,
cli.py) so each counterpart is found at the same place.  Host-only modules
that import no JAX (params, index.hash_table, utils.{audio, formats,
timing, prng}, oracle/) are reused from audfprint_tpu, not copied.

Every public entry point takes an explicit `device`; `None` means CUDA and
raises when CUDA is missing (utils.device.resolve_device).  The
hand-written CUDA kernels (csrc/prune.cu: K1 and K1f; csrc/hpf.cu: K2)
build with nvcc at first use; on CPU tensors their plain PyTorch versions
run instead.
"""

__version__ = "0.1.0"
