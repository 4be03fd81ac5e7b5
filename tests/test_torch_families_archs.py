"""Every architecture the JAX package registers, in the port.

* The registry: the port registers the reference's architectures with the
  same fields, every block type is ported, and ``reduced_config`` keeps each
  family's shape as the reference's does.
* ``reference_loss`` and its gradients for the four block families'
  architectures of ``tests/test_smoke_archs.py`` (whisper, zamba2, xLSTM,
  InternVL2; the six dense and MoE ones in ``test_torch_families_dense.py``)
  at its reduced size (4 layers, d_model 64, heads 4/2, d_ff 128, 2 stage
  buffers): the reference under
  ``kernel_impl="pallas"`` (its Pallas kernels in interpret mode), the port
  under "pallas" (the kernels' plain versions on the CPU), on the same
  params (``repro_torch.convert``) and the same tokens, VLM patches and
  audio frames from one numpy seed.  Losses within 1e-4 relative; every
  gradient leaf — shared params included — within 1e-3 of that leaf's
  largest |entry|, and finite.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import DistConfig as TDist  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import list_configs as tlist  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.dynamics.config import DynamicsConfig as TDyn  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.set_num_threads(1)
ARCHS = [
    "mixtral-8x7b", "mixtral-8x22b", "llama3-405b", "command-r-plus-104b",
    "smollm-360m", "deepseek-coder-33b", "internvl2-26b", "zamba2-1.2b",
    "xlstm-1.3b", "whisper-large-v3",
]
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def assert_grads(got, want, rel=1e-3):
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, k
        assert np.isfinite(g).all(), k
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (k, err, scale)


def test_registry_matches_the_reference():
    from repro.configs import get_config, list_configs
    assert tlist() == list_configs()
    for name in list_configs():
        want = dataclasses.asdict(get_config(name))
        got = dataclasses.asdict(tget(name))
        assert got == want, name
        TB.check_ported(tget(name))
    assert set(TB.PORTED_BLOCK_TYPES) == set(
        t for t in range(1, 9))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch):
    from repro.configs import get_config, reduced_config
    from repro.models import blocks as JB
    import jax.numpy as jnp
    jcfg = reduced_config(get_config(arch), **SMALL)
    tcfg = treduce(tget(arch), **SMALL)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for jfn, tfn, args in (
            (JB.slot_param_spec, TB.slot_param_spec, ()),
            (JB.shared_param_spec, TB.shared_param_spec, ()),
            (JB.slot_cache_spec, TB.slot_cache_spec, (2, 24))):
        want = jfn(jcfg, *args, dtype=jnp.float32)
        got = tfn(tcfg, *args, dtype=torch.float32)
        assert set(got) == set(want), arch
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (arch, k)
            assert str(got[k].dtype).split(".")[-1] == str(
                want[k].dtype), (arch, k)


def _loss_inputs(cfg, rng, B=2, s=16):
    tok = rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)
    lab = rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)
    pe = None
    if cfg.family == "vlm":
        pe = (rng.randn(B, cfg.num_patches, cfg.d_model) * 0.1).astype(
            np.float32)
    if cfg.is_encdec:
        pe = (rng.randn(B, cfg.encoder_seq, cfg.d_model) * 0.1).astype(
            np.float32)
    return tok, lab, pe


FAMILY_ARCHS = ["internvl2-26b", "zamba2-1.2b", "xlstm-1.3b",
                "whisper-large-v3"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reference_loss_and_grads_match_reference(arch):
    check_arch_parity(arch)


def check_arch_parity(arch):
    """``reference_loss`` and every gradient leaf of the reduced ``arch``,
    the port against the reference (the module docstring)."""
    import jax.numpy as jnp
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.dynamics.config import DynamicsConfig
    from repro.models import model as JM
    kw = dict(num_stages=2, slot_slack=1, remat="none",
              param_dtype="float32", kernel_impl="pallas")
    jcfg = reduced_config(get_config(arch), **SMALL)
    jd = DistConfig(**kw)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(0), jcfg, jd))
    assign = JM.make_assignment(jcfg, jd)
    dyn = jax.tree.map(np.asarray, JM.init_dyn(jcfg, jd, DynamicsConfig()))
    if jcfg.d_ff or jcfg.family == "ssm":
        dyn["ff_mask"] = dyn["ff_mask"].copy()
        dyn["ff_mask"][0, 0, 0] = 0.0           # a pruned block
    tok, lab, pe = _loss_inputs(jcfg, np.random.RandomState(0))

    def loss_fn(p):
        return JM.reference_loss(
            jcfg, jd, DynamicsConfig(), p, assign, dyn, jnp.asarray(tok),
            jnp.asarray(lab), prefix_emb=None if pe is None
            else jnp.asarray(pe))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)

    tcfg = treduce(tget(arch), **SMALL)
    td = TDist(**kw)
    tp = convert.to_torch(params, "cpu")
    leaves = [v for _, v in _leaves({"p": tp})]
    for v in leaves:
        v.requires_grad_(True)
    tl = TM.reference_loss(
        tcfg, td, TDyn(), tp, convert.to_torch(jax.tree.map(
            np.asarray, assign), "cpu"), convert.to_torch(dyn, "cpu"),
        torch.from_numpy(tok), torch.from_numpy(lab),
        prefix_emb=None if pe is None else torch.from_numpy(pe))
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    tg = {}
    for (path, v), g in zip(_leaves({"p": tp}), grads):
        node = tg
        *keys, leaf = path.strip("/").split("/")[1:]
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = torch.zeros_like(v) if g is None else g
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    jg = jax.tree.map(np.asarray, jg)
    if not jg["shared"]:
        tg.setdefault("shared", {})
    assert_grads(tg, jg)
    if tcfg.family in ("hybrid", "audio"):
        assert tg["shared"] and all(
            float(g.abs().sum()) > 0 for g in tg["shared"].values()), arch
