from gatekeeper_tpu_torch.apis.templates import (  # noqa: F401
    CodeEntry,
    ConstraintTemplate,
    TemplateTarget,
)
from gatekeeper_tpu_torch.apis.constraints import Constraint  # noqa: F401
