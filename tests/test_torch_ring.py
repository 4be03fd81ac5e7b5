"""The sliding-window decode ring after a prompt longer than the window.

A windowed layer's decode cache holds the last ``window`` positions, and
decode writes position p at slot ``p % window``.  Prefill has to leave
the prompt's kept tail in the same places: position q at slot
``q % window``.  One decode step after prompts of 9–17 tokens (window 8)
must then give the last row of train-mode windowed attention over the
same sequence, at 1e-5 (fp32 cache; the two differ only in summation
order).  The JAX package keeps the tail at slots ``0 .. window - 1``
instead, so its decode past the window attends a different set of keys;
this test holds the port to the windowed attention itself, not to it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import blocks as TB

torch.set_num_threads(1)
WINDOW = 8


def _windowed_cfg():
    cfg = reduced_config(get_config("smollm-360m"), num_layers=4,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=256)
    return dataclasses.replace(cfg, sliding_window=WINDOW)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("s", range(9, 18))
def test_decode_after_a_prompt_past_the_window(s, impl):
    cfg = _windowed_cfg()
    rng = np.random.RandomState(s)
    b, d, nq, nkv, hd = 2, 64, 4, 2, 16
    x = torch.from_numpy((rng.randn(b, s + 1, d) * 0.5).astype(np.float32))
    w = [torch.from_numpy((rng.randn(*shape) * 0.15).astype(np.float32))
         for shape in ((d, nq * hd), (d, nkv * hd), (d, nkv * hd),
                       (nq * hd, d))]
    kw = dict(cfg=cfg, kernel_impl=impl)
    cache = {k: torch.zeros((b, WINDOW, nkv, hd)) for k in "kv"}
    TB._attn_fwd(x[:, :s], *w, mode="prefill", cache=cache,
                 pos=torch.arange(s), **kw)
    # position q sits at slot q % WINDOW
    _, full_cache, _ = TB._attn_fwd(
        x[:, :s], *w, mode="prefill",
        cache={k: torch.zeros((b, 32, nkv, hd)) for k in "kv"},
        pos=torch.arange(s), **kw)
    for q in range(s - WINDOW, s):
        for k in "kv":
            assert torch.equal(cache[k][:, q % WINDOW], full_cache[k][:, q])
    got, _, _ = TB._attn_fwd(x[:, s:], *w, mode="decode", cache=cache,
                             pos=torch.tensor(s), **kw)
    want, _, _ = TB._attn_fwd(x, *w, mode="train", cache=None,
                              pos=torch.arange(s + 1), **kw)
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, -1].numpy(),
                               atol=1e-5, rtol=1e-5)
