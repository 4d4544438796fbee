"""Parallelism of the port over torch.distributed (``mesh``): one group
type (``Group``) for data parallelism (``DataParallel``) and tensor
parallelism (``TensorParallel``)."""

from mmt_tpu_torch.parallel.mesh import (DataParallel, Group, TensorParallel,
                                         all_reduce_grads, all_reduce_sum,
                                         copy_to_tp, gather_rows,
                                         init_tensor_parallel,
                                         maybe_initialize_distributed,
                                         reduce_from_tp, spawn)

__all__ = ["DataParallel", "Group", "TensorParallel", "all_reduce_grads",
           "all_reduce_sum", "copy_to_tp", "gather_rows",
           "init_tensor_parallel", "maybe_initialize_distributed",
           "reduce_from_tp", "spawn"]
