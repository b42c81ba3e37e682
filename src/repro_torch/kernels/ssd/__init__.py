from .kernel import launches, ssd_scan
from .ops import ssd_op
from .ref import ssd_ref
