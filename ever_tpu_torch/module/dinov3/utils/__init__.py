"""``ever.module.dinov3.utils`` in the port."""

from ever_tpu_torch.module.dinov3.utils.utils import (cat_keep_shapes,  # noqa: F401
                                                      count_parameters, fix_random_seeds,
                                                      get_conda_env, get_sha, has_batchnorms,
                                                      named_apply, named_replace,
                                                      uncat_with_shapes)
