"""The logical axis vocabulary of parameters, and each leaf's axes.

A copy of ``repro.models.param``'s names. ``repro`` boxes every parameter
with its logical axes at init; the port's ``LM.param_spec`` keeps (shape,
dtype, init) leaves, and ``LM.param_axes`` builds the axes tree beside it
from the tables here, leaf by leaf as ``repro``'s init functions box them.
``launch.sharding_rules`` maps the axes onto mesh axes.
"""
from __future__ import annotations

EMBED = "embed"          # d_model (contraction side)
EMBED_OUT = "embed_out"  # d_model as an output dim (w_down/wo); decode replicates it
VOCAB = "vocab"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
MLP = "mlp"              # d_ff
EXPERT = "expert"
LRU = "lru"              # recurrent width
LORA = "lora"            # MLA low-rank dims
STACK = "stack"          # stacked layer axis (never split)

NORM = {"scale": (EMBED,)}

DENSE_MLP = {"w_gate": (EMBED, MLP), "w_up": (EMBED, MLP),
             "w_down": (MLP, EMBED_OUT)}

MOE_MLP = {"router": (EMBED, EXPERT),
           "w_gate": (EXPERT, EMBED, MLP), "w_up": (EXPERT, EMBED, MLP),
           "w_down": (EXPERT, MLP, EMBED_OUT), "shared": DENSE_MLP}

# per mixer kind (``configs.base``'s names), every leaf its mixer may hold
MIXER = {
    "attn": {"wq": (EMBED, HEADS, HEAD_DIM),
             "wk": (EMBED, KV_HEADS, HEAD_DIM),
             "wv": (EMBED, KV_HEADS, HEAD_DIM),
             "wo": (HEADS, HEAD_DIM, EMBED_OUT),
             "q_scale": (HEAD_DIM,), "k_scale": (HEAD_DIM,)},
    "mla": {"w_dq": (EMBED, LORA), "q_norm": (LORA,),
            "w_uq": (LORA, HEADS, HEAD_DIM),
            "w_dkv": (EMBED, LORA), "kv_norm": (LORA,),
            "w_krope": (EMBED, HEAD_DIM),
            "w_uk": (LORA, HEADS, HEAD_DIM),
            "w_uv": (LORA, HEADS, HEAD_DIM),
            "wo": (HEADS, HEAD_DIM, EMBED_OUT)},
    "rglru": {"w_in_x": (EMBED, LRU), "w_in_gate": (EMBED, LRU),
              "conv_w": (None, LRU), "conv_b": (LRU,),
              "w_rgate": (LRU, LRU), "b_rgate": (LRU,),
              "w_igate": (LRU, LRU), "b_igate": (LRU,),
              "lam": (LRU,), "w_out": (LRU, EMBED_OUT)},
    "mlstm": {"norm": NORM,
              "wq": (EMBED, HEADS, HEAD_DIM), "wk": (EMBED, HEADS, HEAD_DIM),
              "wv": (EMBED, HEADS, HEAD_DIM), "w_if": (EMBED, HEADS, None),
              "b_if": (HEADS, None), "w_ogate": (EMBED, HEADS, HEAD_DIM),
              "gn_scale": (HEADS, HEAD_DIM),
              "w_out": (HEADS, HEAD_DIM, EMBED_OUT)},
    "slstm": {"norm": NORM,
              "wx": (EMBED, None, HEADS, HEAD_DIM),
              "rh": (None, HEADS, HEAD_DIM, HEAD_DIM),
              "bias": (None, HEADS, HEAD_DIM),
              "gn_scale": (HEADS, HEAD_DIM),
              "w_up1": (None, MLP), "w_up2": (None, MLP),
              "w_down": (MLP, EMBED_OUT)},
}


def axes_like(spec, table, lead: tuple = ()):
    """The axes tree of the spec subtree ``spec`` ((shape, dtype, init)
    leaves) from ``table`` (the same keys, axes tuples at the leaves),
    each tuple prefixed by ``lead`` (the stacked layer axis)."""
    if isinstance(spec, dict):
        return {k: axes_like(v, table[k], lead) for k, v in spec.items()}
    axes = lead + tuple(table)
    if len(axes) != len(spec[0]):
        raise ValueError(f"axes {axes} do not fit shape {spec[0]}")
    return axes
