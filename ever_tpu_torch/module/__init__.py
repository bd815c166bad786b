from ever_tpu_torch.module import vit  # noqa: F401  (registers the ViT models)
from ever_tpu_torch.module import fs_relation  # noqa: F401  (FarSeg and the ResNets)
