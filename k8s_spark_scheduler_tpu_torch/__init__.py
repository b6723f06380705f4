"""PyTorch + CUDA port of the tpu-gang-scheduler packing core.

Mirrors the module layout of ``k8s_spark_scheduler_tpu`` (the JAX
reference) for the FIFO gang solve under every packing policy: exact
Fraction quantities, the numpy tensorizer, the host oracles, the
gang-solve programs in PyTorch, and the whole-queue solves as hand-written
CUDA kernels (``ops/csrc/queue_kernel.cu`` for tightly-pack and
distribute-evenly, ``minfrag_kernel.cu`` for minimal-fragmentation,
``single_az_kernel.cu`` for the single-AZ policies).

The package imports torch and numpy, never jax and nothing of the JAX
package.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``, where every kernel is replaced by its plain PyTorch
version.
"""

__version__ = "0.1.0"
