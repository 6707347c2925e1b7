"""portbench: the benchmark of audfprint_torch on one NVIDIA H100."""
