"""GPT-2 weight import, the warm start of the text side (twin of
cogview_tpu/models/hf_import.py; reference utils.py:422-437 ``move_weights``).

Maps a HuggingFace GPT-2 state dict onto the port's GPT params.  The
architectures differ (GPT-2 has no Sandwich-LN), so only the shared parts
transfer: the token and position embeddings (the tokens into the text
region of the unified vocabulary), the qkv and MLP weights and ln1/ln2;
the sandwich LayerNorms keep their values.  The dict holds tensors (or
arrays): ``transformers`` is not needed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

Params = Dict[str, Any]


def load_hf_gpt2_into(params: Params, sd: Mapping[str, Any], txt_offset: int = 8192) -> Params:
    """params: the port's GPT params; sd: a GPT-2 state dict (``wte.weight``,
    ``wpe.weight``, ``h.{i}.*``, ``ln_f.*``; HF's Conv1D weights are already
    [in, out]).  Returns new params: every leaf a copy in its own dtype and
    device, the GPT-2 values written into it; ``ln_final`` becomes GPT-2's
    ``ln_f`` in the state dict's dtype."""
    layers_in = params["layers"]
    L, H = layers_in["qkv"]["w"].shape[:2]
    device = layers_in["qkv"]["w"].device

    def src(key, dtype=None):
        return torch.as_tensor(sd[key]).to(device=device, dtype=dtype)

    wte = src("wte.weight", torch.float32)  # [V_hf, H]
    if wte.shape[1] != H:
        raise ValueError(f"hidden size mismatch: GPT-2 {wte.shape[1]}, params {H}")
    word = params["embed"]["word"].clone()
    n = min(wte.shape[0], word.shape[0] - txt_offset)
    word[txt_offset:txt_offset + n] = wte[:n]
    wpe = src("wpe.weight", torch.float32)
    pos = params["embed"]["pos"].clone()
    pn = min(wpe.shape[0], pos.shape[0])
    pos[:pn] = wpe[:pn]

    layers = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in layers_in.items()}
    n_hf = sum(1 for k in sd if k.endswith("attn.c_attn.weight"))
    for i in range(min(L, n_hf)):
        pre = f"h.{i}."
        layers["qkv"]["w"][i] = src(pre + "attn.c_attn.weight").reshape(H, 3, H)
        layers["qkv"]["b"][i] = src(pre + "attn.c_attn.bias").reshape(3, H)
        layers["attn_out"]["w"][i] = src(pre + "attn.c_proj.weight")
        layers["attn_out"]["b"][i] = src(pre + "attn.c_proj.bias")
        layers["mlp_in"]["w"][i] = src(pre + "mlp.c_fc.weight")
        layers["mlp_in"]["b"][i] = src(pre + "mlp.c_fc.bias")
        layers["mlp_out"]["w"][i] = src(pre + "mlp.c_proj.weight")
        layers["mlp_out"]["b"][i] = src(pre + "mlp.c_proj.bias")
        layers["ln_in"]["g"][i] = src(pre + "ln_1.weight")
        layers["ln_in"]["b"][i] = src(pre + "ln_1.bias")
        layers["ln_post"]["g"][i] = src(pre + "ln_2.weight")
        layers["ln_post"]["b"][i] = src(pre + "ln_2.bias")
    return {**params, "embed": {"word": word, "pos": pos}, "layers": layers,
            "ln_final": {"g": src("ln_f.weight").clone(), "b": src("ln_f.bias").clone()}}
