"""Datasets and samplers (counterpart of ``ever_tpu/data/__init__.py``).

``torch.utils.data.DataLoader`` stands in for the JAX package's process-pool
loader.  Not ported yet: the LEVIR-CD, xView2 and iSAID readers of
``ever_tpu/data/benchmarks.py`` (ROADMAP.md A.7).
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
from ever_tpu_torch.data import cross_validation, geotile, loveda  # noqa: F401
from ever_tpu_torch.data.cross_validation import CrossValSamplerGenerator, make_CVSamplers  # noqa: F401
from ever_tpu_torch.data.geotile import GeoTileDataset, read_raster  # noqa: F401
from ever_tpu_torch.data.loveda import LoveDA  # noqa: F401
from ever_tpu_torch.data._scene import SpaceToDepth  # noqa: F401
