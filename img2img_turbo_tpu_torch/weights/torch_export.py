"""LoRA adapters and state dicts in the reference's peft key layout
(counterpart of `export_lora_weights` and `peft_wrap_state_dict` in
`img2img_turbo_tpu/weights/torch_import.py:355-392`), for the
reference-schema checkpoints `training/checkpoint.py` writes.

Adapters keep the JAX layout (`lora.py`): a (kh, kw, in, r) for a conv or
(in, r) for a linear, b (r, out). peft stores lora_A as (r, in, kh, kw) or
(r, in) and lora_B as (out, r, 1, 1) or (out, r).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from img2img_turbo_tpu_torch.lora import matches_target


def _cpu(t) -> torch.Tensor:
    return t.detach().float().cpu().contiguous()


def export_lora_weights(name: str, entry: Dict,
                        adapter: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """`<name>.lora_{A,B}[.<adapter>].weight` for one adapted module, fp32
    on the CPU."""
    a, b = _cpu(entry["a"]), _cpu(entry["b"])
    if a.ndim == 4:
        ta = a.permute(3, 2, 0, 1).contiguous()
        tb = b.t()[:, :, None, None].contiguous()
    else:
        ta, tb = a.t().contiguous(), b.t().contiguous()
    mid = f".{adapter}" if adapter else ""
    return {f"{name}.lora_A{mid}.weight": ta,
            f"{name}.lora_B{mid}.weight": tb}


def lora_state_dict(modules: Dict[str, Dict],
                    adapter: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """`export_lora_weights` over every module of an adapter."""
    out: Dict[str, torch.Tensor] = {}
    for name, entry in modules.items():
        out.update(export_lora_weights(name, entry, adapter))
    return out


def peft_wrap_state_dict(sd: Dict[str, torch.Tensor], modules: Dict,
                         targets: Sequence[str],
                         adapter: str) -> Dict[str, torch.Tensor]:
    """A plain diffusers state dict in the key layout of the same model
    after peft's `add_adapter(LoraConfig(target_modules=targets),
    adapter_name=adapter)`: a targeted module's own parameters move under
    `.base_layer.`, and each adapted module (`modules`, {name: {"a", "b"}})
    gains its `lora_{A,B}.<adapter>.weight`."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        name, field = k.rsplit(".", 1)
        if matches_target(name, targets):
            out[f"{name}.base_layer.{field}"] = _cpu(v)
        else:
            out[k] = _cpu(v)
    out.update(lora_state_dict(modules, adapter))
    return out
