"""The VLM prefix (InternVL2), pruning an MoE arch and the paper's GPT
configs in the port, against the JAX package.

* A pipelined train step of reduced InternVL2 with the loader's patch
  embeddings prepended (``PipelineShapes.prefix``; the loss reads the
  positions after the prefix): loss and every gradient leaf against the
  reference's, S = 1 in this process.
* The same step over 2 ranks (the reference's params split over 2 stage
  buffers, the patch prefix riding the carry between the ranks): bitwise
  the one-process step at 2 stages, and within 1e-5 of the reference's.
* Serving InternVL2 text through the paged ``ElasticServer``:
  token-identical to the reference's at temperature 0.
* Pruning an MoE arch (``[moe-rest]``): the train CLI on reduced
  Mixtral-8x7B with ``--dynamism pruning`` against the reference's CLI
  (its Session in a 2-device subprocess), the same params: losses within
  1e-4, the same final split, and the step-10 prune masks blocks.  The
  reference's ``moe_ffn`` reads no ``ff_mask``, so the mask changes no
  expert's compute on either side; the mask itself is held to the
  reference's in ``test_torch_families_xlstm.py``.
* gpt-paper (head dim 32 at d_model 128, 4 heads): ``reference_loss`` and
  its gradients.
Both sides run ``kernel_impl="pallas"``.  Tolerances: the train step 1e-5
(relative loss, each leaf against its largest entry).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import DistConfig as TDist  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced_config as treduce  # noqa: E402
from repro_torch.dynamics.config import DynamicsConfig as TDyn  # noqa: E402
from repro_torch.pipeline import pipeline as TP  # noqa: E402
from test_torch_families_archs import assert_grads  # noqa: E402
from test_torch_families_mamba import SMALL, serve_both  # noqa: E402
from test_torch_train import _assert_grads  # noqa: E402

torch.set_num_threads(1)


VLM_STEP = dict(m=2, B=2, seq=24)


@pytest.fixture(scope="module")
def vlm_step():
    """The reference's S = 1 train step of reduced InternVL2 on the
    loader's patches: (params, assignment, dyn, batch, loss, grads), numpy."""
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.data.loader import DataConfig, make_loader
    from repro.dynamics.config import DynamicsConfig
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as JM
    from repro.pipeline.pipeline import PipelineShapes, build_loss_fn
    kw = dict(num_stages=1, slot_slack=2, remat="none",
              param_dtype="float32", kernel_impl="pallas")
    jcfg = reduced_config(get_config("internvl2-26b"), **SMALL)
    jd = DistConfig(**kw)
    m, B, seq = 2, 2, 24
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(5), jcfg, jd))
    assign = JM.make_assignment(jcfg, jd)
    dyn = jax.tree.map(np.asarray, JM.init_dyn(
        jcfg, jd, DynamicsConfig(kind="pruning")))
    dyn["ff_mask"] = dyn["ff_mask"].copy()
    dyn["ff_mask"][0, 1, 1] = 0.0
    batch = next(make_loader(jcfg, DataConfig(m, B, seq, seed=4)))
    assert batch["prefix_emb"].shape == (m, B, jcfg.num_patches, 64)
    loss_fn = build_loss_fn(jcfg, jd, DynamicsConfig(kind="pruning"),
                            make_host_mesh(data=1, model=1),
                            PipelineShapes(m, B, seq,
                                           prefix=jcfg.num_patches))
    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, assign, dyn, batch)
    return (params, jax.tree.map(np.asarray, assign), dyn, batch,
            float(jl), jax.tree.map(np.asarray, jg))


def test_vlm_train_step_with_the_patch_prefix_matches_reference(vlm_step):
    kw = dict(num_stages=1, slot_slack=2, remat="none",
              param_dtype="float32", kernel_impl="pallas")
    params, assign, dyn, batch, jl, jg = vlm_step
    m, B, seq = VLM_STEP["m"], VLM_STEP["B"], VLM_STEP["seq"]
    tcfg = treduce(tget("internvl2-26b"), **SMALL)
    shapes = TP.PipelineShapes.for_model(tcfg, m, B, seq)
    assert shapes.prefix == 8 and shapes.seq_total == seq + 8
    loss_fn = TP.build_loss_fn(tcfg, TDist(**kw), TDyn(kind="pruning"),
                               shapes)
    tl, _, tg = TP.value_and_grad(
        loss_fn, convert.to_torch(params, "cpu"),
        convert.to_torch(assign, "cpu"), convert.to_torch(dyn, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    _assert_grads(tg, jg)


def test_vlm_step_over_two_ranks_is_bitwise_one_process(vlm_step):
    from repro_torch.checkpoint.elastic import _resplit_stage_tree
    from repro_torch.launch.dist import launch
    from repro_torch.models import model as TM
    from repro_torch.pipeline.pipeline import PipelineShapes
    from test_torch_families_mamba import assert_bitwise
    params, _, dyn, batch, jl, jg = vlm_step
    tcfg = treduce(tget("internvl2-26b"), **SMALL)
    td = TDist(num_stages=2, slot_slack=2, remat="none",
               param_dtype="float32", kernel_impl="pallas")
    n = tcfg.total_blocks()
    split = TM.uniform_boundaries(n, 2)
    L = td.slots_for(tcfg)

    def two(tree):       # the one-stage rows split over 2 stage buffers
        return {k: v.numpy() for k, v in _resplit_stage_tree(
            convert.to_torch(tree, "cpu"), [n], split, L).items()}
    tree = {"params": dict(params, stages=two(params["stages"])),
            "dyn": two(dyn),
            "assign": {k: v.numpy() for k, v in TM.make_assignment(
                tcfg, td, split).items()},
            "batch": batch}
    shapes = PipelineShapes.for_model(tcfg, VLM_STEP["m"], VLM_STEP["B"],
                                      VLM_STEP["seq"])
    got = launch("_dist_targets:family_step", 2, device="cpu", kwargs=dict(
        cfg=tcfg, dcfg=td, dyncfg=TDyn(kind="pruning"), shapes=shapes,
        tree=tree))[0]
    tl, _, tg = TP.value_and_grad(
        TP.build_loss_fn(tcfg, td, TDyn(kind="pruning"), shapes),
        convert.to_torch(tree["params"], "cpu"),
        convert.to_torch(tree["assign"], "cpu"),
        convert.to_torch(tree["dyn"], "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(got["loss"]) == float(tl)
    assert_bitwise(got["grads"], tg)
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    # back on one stage buffer, against the reference's gradients
    back = dict(got["grads"], stages=_resplit_stage_tree(
        got["grads"]["stages"], split, [n], n + 2))
    _assert_grads(back, jg)


def test_vlm_server_matches_reference():
    got, want = serve_both("internvl2-26b",
                           paged=dict(page_size=4, pool_pages=16))
    assert got == want and len(got) == 6


MOE_PRUNE = ["--arch", "mixtral-8x7b", "--layers", "4", "--d-model", "64",
             "--seq", "32", "--num-micro", "2", "--mb-global", "2",
             "--kernel-impl", "pallas", "--stages", "2", "--seed", "0",
             "--log-every", "100", "--dynamism", "pruning", "--steps", "12",
             "--rebalance-every", "5"]


# d_ff 512: four prunable blocks a layer (at 128 there is one, and the
# prune keeps at least one block a layer)
MOE_REF_WIDTHS = ["--model.num_heads", "4", "--model.num_kv_heads", "2",
                  "--model.d_ff", "512", "--model.vocab_size", "256"]
MOE_PORT_WIDTHS = ["--num-heads", "4", "--num-kv-heads", "2", "--d-ff",
                   "512", "--vocab-size", "256", "--device", "cpu"]


def test_moe_pruning_train_cli_matches_reference(tmp_path):
    from repro_torch.launch.train import run
    from test_torch_train_cli import reference_run
    want, params = reference_run(MOE_PRUNE + MOE_REF_WIDTHS, tmp_path)
    rep = run(MOE_PRUNE + MOE_PORT_WIDTHS,
              params=convert.to_torch(params, "cpu"))
    np.testing.assert_allclose(rep["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    assert rep["final_lps"] == want["final_lps"]
    ff = rep["dyn"]["ff_mask"]
    active = rep["assignment"]["tags"] != 0
    assert 0.0 < float(ff[active].mean()) < 1.0     # the prune at step 10


def test_gpt_paper_head_dim_32_matches_reference():
    import jax.numpy as jnp
    from repro.configs import DistConfig, get_config, reduced_config
    from repro.dynamics.config import DynamicsConfig
    from repro.models import model as JM
    from repro_torch.models import model as TM
    small = dict(num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
                 d_ff=256)
    kw = dict(num_stages=2, slot_slack=1, remat="none",
              param_dtype="float32", kernel_impl="pallas")
    jcfg = reduced_config(get_config("gpt-paper-24l"), **small)
    assert jcfg.resolved_head_dim == 32
    jd = DistConfig(**kw)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(7), jcfg, jd))
    assign = JM.make_assignment(jcfg, jd)
    dyn = jax.tree.map(np.asarray, JM.init_dyn(jcfg, jd, DynamicsConfig()))
    rng = np.random.RandomState(7)
    tok, lab = (rng.randint(0, 256, (2, 130)).astype(np.int32)
                for _ in range(2))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JM.reference_loss(
        jcfg, jd, DynamicsConfig(), p, assign, dyn, jnp.asarray(tok),
        jnp.asarray(lab))))(params)
    tcfg = treduce(tget("gpt-paper-24l"), **small)
    tp = convert.to_torch(params, "cpu")
    flat = [v for v in tp["stages"].values()]
    for v in flat:
        v.requires_grad_(True)
    tl = TM.reference_loss(
        tcfg, TDist(**kw), TDyn(), tp,
        convert.to_torch(jax.tree.map(np.asarray, assign), "cpu"),
        convert.to_torch(dyn, "cpu"), torch.from_numpy(tok),
        torch.from_numpy(lab))
    grads = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert_grads({"stages": dict(zip(tp["stages"], grads))},
                 {"stages": jax.tree.map(np.asarray, jg["stages"])},
                 rel=1e-5)
