"""tiny-dense (tests): the dense family of ``reference.py``, counted by
``costs.py``'s dense formulas (one flash call a layer)."""

import costs
from reference import Reference  # noqa: F401

forward_flops = costs.forward_flops


def kernel_calls(cfg, b, s):
    return {"flash_attention": costs.flash_calls(cfg, b, s), "ssd_scan": []}
