#!/bin/bash
# Two ranks of the data-parallel example through the port's spawner.
# On the CPU:      bash run.sh --device cpu
# One card, gloo:  bash run.sh --backend gloo
# (NCCL takes one rank a GPU: with one card, NPROC=1.)
python -m apex_tpu_torch.parallel.multiproc --nproc "${NPROC:-2}" \
    --coordinator "${COORDINATOR:-127.0.0.1:12355}" \
    -m apex_tpu_torch.examples.simple.distributed.distributed_data_parallel \
    "$@"
