from .kernel import launches, patch_apply
from .ops import patch_apply_op
from .ref import patch_apply_ref
