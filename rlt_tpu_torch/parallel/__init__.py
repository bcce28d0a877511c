"""Parallel layouts of the port on torch.distributed (the JAX package's
`parallel/`).

The JAX package lays one jitted program out over a `Mesh` and XLA inserts
the collectives. Here each rank is a process: `mesh.py` launches them and
builds the (data, model) groups, `sharding.py` applies the JAX package's
per-parameter rules (ep over the expert stack, else Megatron tp over the
encoder FFNs, else replicated) and lays the model's layers out,
`functional.py` holds the collectives as autograd Functions, and
`dryrun.py` runs the four layouts of the JAX package's dry run. The batch-
wide losses stay exact: every data rank gathers the batch's outputs and
evaluates the unchanged criterion on the whole batch, and the ranks'
gradients are summed.

This package imports torch, numpy and the standard library only.
"""

from rlt_tpu_torch.parallel.mesh import (  # noqa: F401
    Group,
    ProcessMesh,
    data_parallel_mesh,
    ensure_process_group,
    launch,
    local_rows,
    mesh_2d,
    padded_batch,
)
