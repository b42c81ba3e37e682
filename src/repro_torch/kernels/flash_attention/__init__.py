from .kernel import flash_attention, launches
from .ops import flash_attention_op
from .ref import attention_ref
