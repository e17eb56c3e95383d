from audio2photoreal_tpu_torch.ops.embeddings import sinusoidal_pos_emb
from audio2photoreal_tpu_torch.ops.rotary import RotaryTable, apply_rotary, make_rotary_table

__all__ = [
    "sinusoidal_pos_emb",
    "RotaryTable",
    "apply_rotary",
    "make_rotary_table",
]
