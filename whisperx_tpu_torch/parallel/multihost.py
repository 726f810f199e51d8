"""Multi-process execution: whole files shard over processes.

Counterpart of ``whisperx_tpu/parallel/multihost.py``. Audio files are
embarrassingly parallel, so processes (one per host, or several on one)
split the file list and each transcribes and writes its own slice with its
own devices; no collective runs on the transcription path.

The group is ``torch.distributed``'s over gloo: give the coordinator's
address (``host:port``), or launch under ``torchrun``, whose ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` are read.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the process group; returns (process_id, n_processes).

    With ``coordinator_address`` (``host:port``), a gloo group at
    ``tcp://<address>`` of ``num_processes``, this one ``process_id``;
    without one, torchrun's variables when ``WORLD_SIZE`` > 1; otherwise
    nothing is joined and (0, 1) is returned. A second call returns the
    group it is already in."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is not None:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("gloo", init_method="env://")
    else:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_index_count() -> Tuple[int, int]:
    """(this process, processes): the group's when one is joined, else
    ``RANK`` / ``WORLD_SIZE``, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))


def shard_files(
    paths: Sequence[str],
    process_id: Optional[int] = None,
    n_processes: Optional[int] = None,
) -> List[str]:
    """This process's slice of the file list, strided (``paths[pid::n]``)
    so early and large submissions spread instead of front-loading
    process 0."""
    pid, n = process_index_count()
    pid = pid if process_id is None else process_id
    n = n if n_processes is None else n_processes
    return list(paths)[pid::n]
