from gatekeeper_tpu_torch.utils.unstructured import (  # noqa: F401
    deep_get,
    deep_set,
    deep_copy,
    load_yaml_objects,
)
