"""Formats and GEMMs (PyTorch counterparts of ``qgtc_ppopp22_tpu.ops``)."""
