"""Datasets and samplers (counterpart of ``ever_tpu/data/__init__.py``).

``torch.utils.data.DataLoader`` stands in for the JAX package's process-pool
loader.  The readers register ``'loveda'``, ``'geotile'``, ``'levircd'``,
``'xview2'`` and ``'isaid'`` in ``DATASET``.
"""

from ever_tpu_torch.data import distributed  # noqa: F401  (first: the interface needs it)
from ever_tpu_torch.data.distributed import (  # noqa: F401
    DistributedInfiniteSampler,
    DistributedNonOverlapSeqSampler,
    DistributedNonOverlapSubsetSeqSampler,
    RandomSampler,
    SequentialSampler,
    StepDistributedRandomSubsetSampler,
    StepDistributedSampler,
    SubsetRandomSampler,
    SubsetSampler,
    as_ddp_inference_loader,
)
from torch.utils.data import DataLoader  # noqa: F401
from ever_tpu_torch.interface.dataloader import default_collate  # noqa: F401
from ever_tpu_torch.data import benchmarks, cross_validation, geotile, loveda  # noqa: F401
from ever_tpu_torch.data.benchmarks import ISAID, ISAID_PALETTE, LEVIRCD, XView2  # noqa: F401
from ever_tpu_torch.data.cross_validation import CrossValSamplerGenerator, make_CVSamplers  # noqa: F401
from ever_tpu_torch.data.geotile import GeoTileDataset, read_raster  # noqa: F401
from ever_tpu_torch.data.loveda import LoveDA  # noqa: F401
from ever_tpu_torch.data._scene import SpaceToDepth  # noqa: F401
