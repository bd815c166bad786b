from ever_tpu_torch.module import vit  # noqa: F401  (registers the ViT models)
