"""Parallelism of the port: tensor parallelism over torch.distributed
(``mesh``)."""

from mmt_tpu_torch.parallel.mesh import (TensorParallel, copy_to_tp,
                                         init_tensor_parallel,
                                         reduce_from_tp, spawn)

__all__ = ["TensorParallel", "copy_to_tp", "init_tensor_parallel",
           "reduce_from_tp", "spawn"]
