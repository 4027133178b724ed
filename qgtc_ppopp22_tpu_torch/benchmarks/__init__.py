"""Benchmarks of the port, run as modules on a CUDA machine
(``python -m qgtc_ppopp22_tpu_torch.benchmarks.kernel_sweep``)."""
