from ever_tpu_torch.interface.module import ERModule  # noqa: F401
