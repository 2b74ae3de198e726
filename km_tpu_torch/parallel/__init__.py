"""Scale-out on torch.distributed: the count table sharded by key range
over a process group, the counting exchange, the 2-D pipeline step and
the multi-process set-up. NCCL carries the collectives on GPUs, gloo on
CPU tensors; a group's backend and its tensors' device must agree.

km_tpu's mesh axes map onto process groups:
- ``shard`` (km_tpu's table axis, the devices of a 1-D ``Mesh``): the
  group passed as ``group`` (the world group by default), one rank per
  key range of the table;
- ``reads`` (km_tpu's data-parallel axis of the 2-D mesh): the
  ``distributed.READS_AXIS`` dimension of a ``DeviceMesh`` built by
  :func:`distributed.global_mesh`; each reads row has its own shard
  group, ``mesh.get_group(distributed.SHARD_AXIS)``.

What km_tpu expresses as ``shard_map`` + ``all_to_all``/``psum`` is
``all_to_all_single`` with split sizes exchanged first, and
``all_reduce``. Each rank is one process on one device.
"""
