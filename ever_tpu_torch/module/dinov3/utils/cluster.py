"""``ever.module.dinov3.utils.cluster`` in the port (the JAX package's
``module/dinov3/utils/cluster.py``, the same behaviour): the scheduler
environment a run finds itself in, read from its environment variables,
with the reference's SLURM spellings kept for launch scripts.
"""

import os
from enum import Enum
from pathlib import Path
from typing import Optional

__all__ = ['ClusterType', 'get_cluster_type', 'get_slurm_account',
           'get_checkpoint_path', 'get_user_checkpoint_path',
           'get_slurm_qos', 'get_slurm_partition',
           'get_slurm_executor_parameters']


class ClusterType(Enum):
    TPU_POD = 'tpu_pod'
    SLURM = 'slurm'
    LOCAL = 'local'


def _guess_cluster_type() -> ClusterType:
    if os.environ.get('TPU_WORKER_ID') is not None or \
            os.environ.get('CLOUD_TPU_TASK_ID') is not None:
        return ClusterType.TPU_POD
    if os.environ.get('SLURM_JOB_ID') is not None:
        return ClusterType.SLURM
    return ClusterType.LOCAL


def get_cluster_type(cluster_type: Optional[ClusterType] = None) -> Optional[ClusterType]:
    return _guess_cluster_type() if cluster_type is None else cluster_type


def get_slurm_account(cluster_type: Optional[ClusterType] = None) -> Optional[str]:
    return os.environ.get('SLURM_JOB_ACCOUNT')


def get_checkpoint_path(cluster_type: Optional[ClusterType] = None) -> Optional[Path]:
    root = os.environ.get('EVER_CHECKPOINT_ROOT')
    return Path(root) if root else None


def get_user_checkpoint_path(cluster_type: Optional[ClusterType] = None) -> Optional[Path]:
    p = get_checkpoint_path(cluster_type)
    user = os.environ.get('USER')
    return p / user if (p and user) else None


def get_slurm_qos(cluster_type: Optional[ClusterType] = None) -> Optional[str]:
    return os.environ.get('SLURM_JOB_QOS')


def get_slurm_partition(cluster_type: Optional[ClusterType] = None) -> Optional[str]:
    return os.environ.get('SLURM_JOB_PARTITION')


def get_slurm_executor_parameters(nodes: int = 1, num_gpus_per_node: int = 8,
                                  **kwargs) -> dict:
    """Submitit-style parameter dict (reference ``cluster.py``)."""
    params = dict(
        mem_gb=0, gpus_per_node=num_gpus_per_node, tasks_per_node=num_gpus_per_node,
        cpus_per_task=10, nodes=nodes, slurm_partition=get_slurm_partition())
    params.update(kwargs)
    return {k: v for k, v in params.items() if v is not None}
