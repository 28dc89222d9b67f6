"""Data-parallel amp on a linear model (``python -m
apex_tpu_torch.parallel.multiproc --nproc N -m
apex_tpu_torch.examples.simple.distributed.distributed_data_parallel``)."""
