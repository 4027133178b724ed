"""QGTC on PyTorch and CUDA: arbitrary-bit quantized GNN inference on Hopper.

The PyTorch counterpart of :mod:`qgtc_ppopp22_tpu`. It keeps that
package's container layouts byte for byte (``BitTensor`` planes,
``DigitTensor`` digits, ``PackedTensor`` M-packed words), so every result
can be held against the JAX package by exact integer equality.

Layers, from the entry point down:

* ``cli.py`` -> ``runtime.QGTCEngine`` (step engine: one forward chain per
  cluster batch, epochs timed the reference's way).
* ``graph/``: the NumPy host layer (synthetic datasets, partitioning,
  cluster batching and packing).
* ``models/qmodels.py``: the GCN / GIN GEMM chains.
* ``ops/``: formats, plus the two GEMMs whose CUDA kernels live in
  ``csrc/``: ``packmm`` (packed 1-bit adjacency x digit planes) and
  ``digitmm`` (digit planes x digit planes).

The package imports ``torch`` and never ``jax``. Kernels are compiled
with ``nvcc`` at first use on a CUDA tensor (``ops/_build.py``); on CPU
tensors each GEMM runs its plain PyTorch version.
"""

__version__ = "0.1.0"
