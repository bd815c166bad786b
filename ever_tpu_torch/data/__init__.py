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
