"""audfprint_torch: the PyTorch/CUDA port of audfprint_tpu.

Mirrors the JAX package's module paths (ops/, models/, index/, match/,
cli.py, params, oracle/, utils/) so each counterpart is found at the same
place.  The package stands alone: it imports nothing of audfprint_tpu or
JAX, and keeps its own copies of the host modules it needs (params,
ops.config, index.hash_table, utils.{audio, formats, native, timing,
prng}, oracle/, native/audfp_host.cpp).

Every public entry point takes an explicit `device`; `None` means CUDA and
raises when CUDA is missing (utils.device.resolve_device).  The
hand-written CUDA kernels (csrc/prune.cu: K1 and K1f; csrc/hpf.cu: K2;
csrc/pair.cu: K3) build with nvcc at first use; on CPU tensors their
plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
