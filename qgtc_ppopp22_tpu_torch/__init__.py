"""QGTC on PyTorch and CUDA: arbitrary-bit quantized GNN inference on Hopper.

The PyTorch counterpart of :mod:`qgtc_ppopp22_tpu`. It keeps that
package's container layouts byte for byte (``BitTensor`` planes,
``DigitTensor`` digits, ``PackedTensor`` M-packed words), so every result
can be held against the JAX package by exact integer equality.

Layers, from the entry point down:

* ``cli.py`` and ``bench.py`` -> ``runtime.QGTCEngine`` (step engine: one
  forward chain per cluster batch, epochs timed the reference's way;
  fused and quant-in-loop engines: the buckets staged once, one captured
  CUDA graph replayed an epoch; mega engine: one whole-model launch per
  shape bucket), ``runtime.BaselineEngine`` (the full-precision bf16
  baseline, ``--regular``) and ``runtime.SparseEngine`` (the full graph,
  ``--sparse``).
* ``graph/``: the NumPy host layer (synthetic datasets, partitioning,
  cluster batching and packing), over ``native/`` (the C++ multilevel
  partitioner, densify, quantize and pack, built with g++ at first use)
  where it builds.
* ``models/qmodels.py``: the GCN / GIN GEMM chains and their NumPy
  goldens (``models/golden.py``); ``models/layers.py``: the same chains as
  composable layer objects; ``models/sparse.py``: the full-graph chains;
  ``models/baselines.py``: the bf16 baseline chains; ``models/train.py``:
  quantization-aware training of the float twin, deployed through the
  engines, and its checkpoints (the CLI's ``--weights``).
* ``ops/``: formats, plus the kernels' wrappers, whose CUDA sources live
  in ``csrc/``: ``packmm`` (packed 1-bit adjacency x digit planes),
  ``digitmm`` (digit planes x digit planes) and ``fused_model`` (the
  whole quantized model, and the whole baseline, per bucket).
* ``parallel/``: the same engine on a (dp, sp) mesh of devices
  (``MeshEngine``, ``--mesh``): batches over dp, each batch's adjacency
  rows over sp with a ring of shard GEMMs; dp across processes
  (``parallel/multihost.py``). ``entry.py``: the flagship step and the
  multi-device dry run.
* ``utils/``: device timing, the F1 metrics and the results writers.

The package imports ``torch`` and never ``jax``. Kernels are compiled
with ``nvcc`` at first use on a CUDA tensor (``ops/_build.py``); on CPU
tensors each GEMM runs its plain PyTorch version.
"""

__version__ = "0.1.0"
