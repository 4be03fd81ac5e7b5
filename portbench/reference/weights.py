"""The weights a cell trains from, made by the benchmark from the seed on
the device: one ``torch.Generator`` on the card, one ``randn`` call per
field over all layers at once, in the dtype the configuration serves them
in.  The program is handed these (packed into its own layout); the
reference makes them again, the same way, to follow it.

Distributions follow the usual decoder initialisation: projections
N(0, fan_in^-1/2), the embedding N(0, 0.02), RMSNorm scales ones.  A
configuration with tied embeddings (``c["tied"]``) has no head: the
output projection is the embedding's transpose."""
from __future__ import annotations

from typing import Dict

import torch

# per-layer fields of a dense decoder block: (shape from the widths, kind)
def dense_fields(c: Dict[str, int]) -> Dict[str, tuple]:
    d, hq, hkv, hd, ff = c["d"], c["hq"], c["hkv"], c["hd"], c["ff"]
    return {"attn_norm": (d,), "ffn_norm": (d,), "wg": (d, ff),
            "wi": (d, ff), "wk": (d, hkv * hd), "wo": (hq * hd, d),
            "wof": (ff, d), "wq": (d, hq * hd), "wv": (d, hkv * hd)}


def make(c: Dict[str, int], seed: int, device, layer_dtype: torch.dtype
         ) -> Dict[str, torch.Tensor]:
    """{"embed": [V, d], "head": [d, V] (untied only), "final_norm": [d]
    (fp32), and per field [L, ...] in ``layer_dtype``}."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    V, d, L = c["vocab"], c["d"], c["layers"]
    out = {"embed": torch.randn((V, d), generator=gen, device=device)
           .mul_(0.02)}
    if not c.get("tied"):
        out["head"] = torch.randn((d, V), generator=gen,
                                  device=device).mul_(d ** -0.5)
    out["final_norm"] = torch.ones((d,), device=device)
    for name, shape in sorted(dense_fields(c).items()):
        if len(shape) == 1:
            t = torch.ones((L,) + shape, device=device, dtype=layer_dtype)
        else:
            t = torch.randn((L,) + shape, generator=gen, device=device,
                            dtype=torch.float32).mul_(shape[0] ** -0.5)
            t = t.to(layer_dtype)
        out[name] = t
    return out
