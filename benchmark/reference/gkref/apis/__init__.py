from gkref.apis.templates import (  # noqa: F401
    CodeEntry,
    ConstraintTemplate,
    TemplateTarget,
)
from gkref.apis.constraints import Constraint  # noqa: F401
