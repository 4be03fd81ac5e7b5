"""The yardstick's frozen copies against the program they were copied
from, today: the data generator against the loader, the schedules, the
per-kernel FLOP and byte formulas against ``repro_torch``'s accounting;
and the trace reduction on a trace made up here."""
import json

import numpy as np
import pytest
import torch

from pb_paths import DATA  # noqa: F401  (puts the paths in place)
from reference import data, formulas, schedule


def test_frozen_data_is_the_loaders():
    from repro_torch.configs import get_config
    from repro_torch.data.loader import DataConfig, make_loader
    cfg = get_config("smollm-360m")
    for seed in (0, 3, 2**31 + 5):
        it = make_loader(cfg, DataConfig(2, 3, 64, seed=seed))
        mine = data.batches(cfg.vocab_size, 2, 3, 64, seed)
        for _ in range(5):
            a, b = next(it), next(mine)
            assert np.array_equal(a["tokens"], b["tokens"])
            assert np.array_equal(a["labels"], b["labels"])


def test_schedules_are_the_loops():
    import dataclasses
    from repro_torch.dynamics import pruning as prn
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.dynamics.trajectories import zhu_gupta_sparsity
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m")
    dc = DynamicsConfig(kind="pruning", prune_initial_sparsity=0.5,
                        prune_final_sparsity=0.6)
    for step in (0, 1, 9, 10, 11, 57, 199, 250):
        assert schedule.cosine_lr(step, 200) == cosine_schedule(
            step, 200, 3e-4, warmup=10)
        sp = zhu_gupta_sparsity(step * 100, dataclasses.replace(
            dc, prune_start_iter=0, prune_end_iter=200 * 100,
            prune_frequency=1))
        assert schedule.sparsity(step, 200, 0.5, 0.6) == sp
        assert schedule.keep_blocks(32, 20, sp) == prn.target_keep_blocks(
            cfg, 32, sp)


def _counted(fn):
    from repro_torch.launch.counting import CountingMode
    with CountingMode() as mode:
        fn()
    return mode.kernels


@pytest.mark.parametrize("b,s,hq,hkv,d", [(2, 256, 4, 2, 64),
                                          (1, 512, 6, 3, 32)])
def test_attention_formulas_are_the_ports(b, s, hq, hkv, d):
    from repro_torch.kernels.block_sparse_attention import ops
    blk = 128
    q = torch.randn(b, s, hq, d)
    k, v = torch.randn(b, s, hkv, d), torch.randn(b, s, hkv, d)
    mask = torch.ones(1, 1, s // blk, s // blk, dtype=torch.int32)

    def both():
        out, lse = ops.block_sparse_attention_fwd(q, k, v, mask,
                                                  causal=False, block=blk)
        delta = torch.zeros(b, hq, s)
        ops.block_sparse_attention_bwd(q, k, v, mask, out, lse, delta,
                                       causal=False, block=blk)
    got = _counted(both)
    mb = mask.numel() * mask.element_size()
    pairs = s * s          # a dense, non-causal mask: every pair
    for kid, prod in (("K1", 2), ("K2a", 3), ("K2b", 4)):
        assert got[kid]["flops"] == formulas.attention_flops(b, hq, d, pairs,
                                                             prod)
        assert got[kid]["bytes"] == formulas.attention_bytes(
            kid, b, s, s, hq, hkv, d, 4, mb)
    # causal: the port counts whole reachable tiles, the yardstick the
    # exact pairs, never more
    cm = _counted(lambda: ops.block_sparse_attention_fwd(
        q, k, v, mask, causal=True, block=blk))
    exact = formulas.attention_flops(b, hq, d, formulas.causal_pairs(s), 2)
    assert exact < cm["K1"]["flops"]


@pytest.mark.parametrize("M,K,N,keep", [(256, 128, 384, 1.0),
                                        (512, 256, 256, 0.5)])
def test_matmul_formula_is_the_ports(M, K, N, keep):
    from repro_torch.kernels.pruned_matmul import ops
    nb = N // 128
    mask = torch.zeros(nb)
    mask[: int(nb * keep)] = 1
    x, w = torch.randn(M, K), torch.randn(K, N)
    got = _counted(lambda: ops.product(x, w, mask, "n", 128))["K3"]
    live = float((mask > 0).float().mean())
    assert got["flops"] == formulas.matmul_flops(M, K, N, live)
    mb = mask.numel() * mask.element_size()
    assert got["bytes"] == formulas.matmul_bytes(M, K, N, 4, mb)
    # the yardstick's bytes: the port's with the pruned side's operands
    # cut to the live blocks
    assert formulas.pruned_ffn_bytes(M, K, N, 1.0, 4, mb) == got["bytes"]
    assert formulas.pruned_ffn_bytes(M, K, N, live, 4, mb) == (
        (M * K + (K * N + M * N) * live) * 4 + mb)


def test_step_flops_adds_up():
    c = dict(layers=2, d=64, hq=4, hkv=2, hd=16, vocab=100, rows=3, seq=8)
    full = formulas.dense_step_flops(live_ff=2 * 256, **c)
    half = formulas.dense_step_flops(live_ff=256, **c)
    tokens = 3 * 8
    assert full - half == pytest.approx(3 * 3 * 2 * 64 * 256 * tokens)
    assert formulas.causal_pairs(8) == 36


def test_trace_reduction(tmp_path):
    import devtrace
    base = 1_000_000_000_000
    ev = [{"cat": "kernel", "name": "void pm_tc_kernel<float>(int)",
           "ts": 100.0, "dur": 50.0},
          {"cat": "kernel", "name": "void at::native::add(int)",
           "ts": 200.0, "dur": 100.0},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 250.0,
           "dur": 100.0},
          {"cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 5.0}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"baseTimeNanoseconds": base,
                             "traceEvents": ev}))
    ns = lambda us: base + int(us * 1000)  # noqa: E731
    s = devtrace.reduce_trace(str(p), [ns(0), ns(200), ns(400)],
                              [(ns(150), ns(190), "decide")])
    assert s["steps"] == 2
    assert s["window_s"] == pytest.approx(400e-6)
    assert s["busy_s"] == pytest.approx(200e-6)        # 50 + 150
    assert [(n, round(g * 1e6)) for n, g in s["idle_gaps"]] == [
        ("loop", 100), ("decide", 50), ("loop", 50)]
    assert devtrace.by_kernel(s) == {"K3": [1, pytest.approx(50e-6)]}
    assert devtrace.kernel_id("void bsa_dkv_sum_kernel<float, 64>()") == "K2b"
    assert devtrace.kernel_id("void gm_dw_tc_kernel()") == "K5"
    assert devtrace.kernel_id("cutlass_80_simt_sgemm") is None
