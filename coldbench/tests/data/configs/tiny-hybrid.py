"""tiny-hybrid (tests): Mamba-2, GQA attention and routed experts in one
period, composed of ``reference.py``'s and ``costs.py``'s pieces alone.

Layer i of a period of ``attn_layer_period`` has the attention mixer
(no rotary embedding where ``use_rope`` is false, scores times
``query_scale``) at ``attn_layer_offset`` and the Mamba-2 mixer elsewhere,
each after an RMSNorm and with a residual; then an RMSNorm and the routed
experts where i % ``moe_layer_period`` == ``moe_layer_offset``, the gated
MLP elsewhere, with a residual.  The port serves the experts with
``capacity_factor`` = E / K, so it drops no token, as the reference's
routing does not."""

import costs
import reference


def _kinds(cfg):
    """(attention?, routed experts?) of each layer, in order."""
    period = cfg["attn_layer_period"]
    return [(l % period == cfg["attn_layer_offset"],
             l % period % cfg["moe_layer_period"] == cfg["moe_layer_offset"])
            for l in range(cfg["num_layers"])]


class Reference(reference.Reference):
    def layer(self, l, x, p):
        attn, moe = _kinds(self.c)[l]
        h = self.norm(x, p, "ln1")
        if attn:
            x = x + self.attention(h, p, scale=self.c.get("query_scale"),
                                   rope=self.c.get("use_rope", True))
        else:
            x = x + self.mamba(h, p)
        h = self.norm(x, p, "ln2")
        return x + (self.routed_ffn(h, p) if moe else self.mlp(h, p))


def forward_flops(cfg, b, s):
    total = costs.head_flops(cfg, b)
    for attn, moe in _kinds(cfg):
        total += costs.attn_flops(cfg, b, s) if attn else costs.mamba_flops(cfg, b, s)
        total += costs.moe_flops(cfg, b * s) if moe else costs.mlp_flops(cfg, b * s, cfg["d_ff"])
    return total


def kernel_calls(cfg, b, s):
    kinds = _kinds(cfg)
    return {"flash_attention": [costs.flash_call(cfg, b, s) for attn, _ in kinds if attn],
            "ssd_scan": [costs.scan_call(cfg, b, s) for attn, _ in kinds if not attn]}
