from .kernel import bwd_launches, flash_attention, flash_attention_bwd, launches
from .ops import flash_attention_op
from .ref import attention_bwd_ref, attention_fwd_ref, attention_ref
