"""The plain reference and the comparison that decides ``correct``. Plain
PyTorch and NumPy: nothing of kbmod_tpu_torch, kbmod_tpu or JAX."""
