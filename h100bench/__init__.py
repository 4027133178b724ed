"""The benchmark of the PyTorch and CUDA port (``qgtc_ppopp22_tpu_torch``) on
one NVIDIA H100: ``python3 -m h100bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""
