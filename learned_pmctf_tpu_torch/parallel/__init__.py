"""Data and spatial parallelism over torch.distributed ranks: the port of
learned_pmctf_tpu/parallel. Along "data" the train step reduces
gradients over a group (training/steps.py), the trainer runs one rank a
card (cli/train_pmctf.py --data_parallel) and the eval CLI codes a block
of its rate points a rank (cli/flex.py --shard_q); along "spatial" each
rank codes a block of a frame's columns with halo exchanges written by
hand (halo.py)."""

from .mesh import (DataMesh, broadcast_from_rank0_, data_rows,  # noqa: F401
                   frame_columns, gather_to_rank0, init_process_group,
                   launched_by_torchrun, make_mesh, mean_over_ranks_, rank_device,
                   spawn)
