"""Quantized GNN models (PyTorch counterparts of ``qgtc_ppopp22_tpu.models``)."""
