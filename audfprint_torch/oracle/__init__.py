"""NumPy oracle (the port's own copy of audfprint_tpu/oracle/): the
readable reference the device pipeline is held against."""
