"""mamba2-780m: the ssm family of ``reference.py``, counted by
``costs.py``'s SSD formulas (one ``ssd_scan`` call a layer)."""

import costs
from reference import Reference  # noqa: F401

forward_flops = costs.forward_flops


def kernel_calls(cfg, b, s):
    return {"flash_attention": [], "ssd_scan": costs.scan_calls(cfg, b, s)}
