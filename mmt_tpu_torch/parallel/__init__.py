"""Parallelism of the port over torch.distributed (``mesh``): one group
type (``Group``) for data parallelism (``DataParallel``) and tensor
parallelism (``TensorParallel``), laid out together by ``data_mesh``;
the local cards of a sharded serving index (``local_mesh``)."""

from mmt_tpu_torch.parallel.mesh import (DataParallel, Group, TensorParallel,
                                         all_reduce_grads, all_reduce_sum,
                                         copy_to_tp, data_mesh, gather_rows,
                                         init_tensor_parallel, local_mesh,
                                         maybe_initialize_distributed,
                                         reduce_from_tp, spawn)

__all__ = ["DataParallel", "Group", "TensorParallel", "all_reduce_grads",
           "all_reduce_sum", "copy_to_tp", "data_mesh", "gather_rows",
           "init_tensor_parallel", "local_mesh",
           "maybe_initialize_distributed", "reduce_from_tp", "spawn"]
