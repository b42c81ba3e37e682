from .kernel import decode_attention_int8, launches
from .ops import decode_attention_int8_op
from .ref import decode_attention_int8_ref, dequantize_kv, quantize_kv
