from .kernel import bwd_launches, launches, ssd_scan, ssd_scan_bwd
from .ops import ssd_op
from .ref import ssd_bwd_ref, ssd_ref
