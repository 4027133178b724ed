"""Utilities (PyTorch counterparts of ``qgtc_ppopp22_tpu.utils``)."""
