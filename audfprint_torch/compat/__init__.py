"""Reference-shaped import surface of the port.

Users of upstream dpwe/audfprint import `audfprint_analyze`, `hash_table`,
`audfprint_match`, `audio_read`, `stft`, `audfprint`.  These modules mirror
those names and public symbols on top of the PyTorch port, as
audfprint_tpu.compat does on top of the JAX package, so existing scripts
can switch with

    from audfprint_torch.compat import audfprint_analyze, hash_table, ...

Entry points that make tensors run on CUDA unless given device="cpu".
"""
