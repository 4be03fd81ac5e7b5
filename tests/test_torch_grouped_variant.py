"""Which variant of the grouped expert matmul serves a call, and the build's
header tracking — checked on the CPU.

K4 and K5 each have two CUDA variants (``repro_torch.kernels.grouped_matmul
.ops``): the tensor-core one (wgmma on TMA-fed shared memory) for bf16
calls with cap > 16, K and N multiples of 8 and a weight view that TMA can
read, and the SIMT one for everything else.  ``gm_variant`` decides from
dtype, shape and strides alone, so the decision is tested here; the kernels
themselves run in ``test_torch_cuda.py`` on the card.
"""
import ast
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_matmul import ops, ref

REPO = Path(__file__).resolve().parents[1]
GM_DIR = REPO / "src" / "repro_torch" / "kernels" / "grouped_matmul"
BF16, F32 = torch.bfloat16, torch.float32


def _w(E, K, N, layout):
    """w's (expert, k, n) strides for a weight of logical shape [E, K, N]."""
    if layout == "contiguous":                   # the forward
        return torch.empty((E, K, N)).stride()
    if layout == "transposed":                   # dx: w[E, N, K].transpose
        return torch.empty((E, N, K)).transpose(1, 2).stride()
    if layout == "strided":                      # every other column
        return torch.empty((E, K, 2 * N))[:, :, ::2].stride()
    if layout == "expanded":                     # one expert broadcast
        return torch.empty((1, K, N)).expand(E, K, N).stride()
    raise ValueError(layout)


@pytest.mark.parametrize("dtype,cap,K,N,layout,aligned,want", [
    # K4 on the MoE train path: d_model 4096, d_ff 14336, cap 320
    (BF16, 320, 4096, 14336, "contiguous", True, "tc"),
    (BF16, 320, 14336, 4096, "contiguous", True, "tc"),
    (BF16, 320, 14336, 4096, "transposed", True, "tc"),
    # ragged edges that stay on the tensor cores
    (BF16, 200, 328, 392, "contiguous", True, "tc"),
    (BF16, 200, 328, 392, "transposed", True, "tc"),
    (BF16, 17, 8, 8, "contiguous", True, "tc"),
    # fp32 (the MoE serve, the fp32 parity runs): wgmma has no fp32 form
    (F32, 320, 4096, 14336, "contiguous", True, "simt"),
    (F32, 320, 14336, 4096, "transposed", True, "simt"),
    # the decode tile
    (BF16, 8, 4096, 14336, "contiguous", True, "simt"),
    (BF16, 16, 4096, 14336, "contiguous", True, "simt"),
    # K or N not a multiple of 8: TMA rows must be multiples of 16 bytes
    (BF16, 320, 4100, 14336, "contiguous", True, "simt"),
    (BF16, 320, 4096, 14332, "contiguous", True, "simt"),
    (BF16, 320, 4100, 14336, "transposed", True, "simt"),
    # strides TMA cannot walk, or a pointer off 16 bytes
    (BF16, 320, 328, 392, "strided", True, "simt"),
    (BF16, 320, 328, 392, "expanded", True, "simt"),
    (BF16, 320, 328, 392, "contiguous", False, "simt"),
])
def test_k4_variant(dtype, cap, K, N, layout, aligned, want):
    assert ops.gm_variant(dtype, cap, K, N, _w(8, K, N, layout),
                          aligned) == want


@pytest.mark.parametrize("dtype,cap,K,N,aligned,want", [
    (BF16, 320, 4096, 14336, True, "tc"),
    (BF16, 320, 14336, 4096, True, "tc"),
    (BF16, 200, 328, 392, True, "tc"),
    (F32, 320, 4096, 14336, True, "simt"),
    (BF16, 8, 512, 640, True, "simt"),
    (BF16, 320, 300, 392, True, "simt"),
    (BF16, 320, 328, 260, True, "simt"),
    (BF16, 320, 328, 392, False, "simt"),
])
def test_k5_variant(dtype, cap, K, N, aligned, want):
    assert ops.gm_variant(dtype, cap, K, N, aligned=aligned) == want


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    g = torch.Generator().manual_seed(0)
    G, E, cap, K, N = 4, 2, 24, 16, 24
    x = torch.randn((G * cap, K), generator=g).to(BF16)
    w = torch.randn((E, K, N), generator=g).to(BF16)
    counts = torch.tensor([0, 24, 7, 13], dtype=torch.int32)
    n = [(k.launches, k.launches_tc) for k in (ops.KERNEL, ops.KERNEL_DW)]
    out = ops.grouped_product(x, w, counts, cap)
    dw = ops.grouped_product_dw(x, out, counts, cap, E, out_dtype=BF16)
    assert torch.equal(out, ref.grouped_product_ref(x, w, counts, cap))
    assert torch.equal(dw, ref.grouped_product_dw_ref(x, out, counts, cap, E,
                                                      out_dtype=BF16))
    assert n == [(k.launches, k.launches_tc)
                 for k in (ops.KERNEL, ops.KERNEL_DW)]


def test_tensor_core_path_is_wgmma_on_tma():
    """The tensor-core variant's source holds the warpgroup MMA and a TMA
    tensor map, and both C launchers are bound."""
    src = (GM_DIR / "csrc" / "grouped_matmul.cu").read_text()
    hdr = (REPO / "src" / "repro_torch" / "kernels" / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    assert "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16" in hdr
    assert "cp.async.bulk.tensor.3d" in hdr
    assert "__grid_constant__ CUtensorMap" in src
    assert "cuTensorMapEncodeTiled" in src
    for sym in ("gm_fwd_tc", "gm_dw_tc"):
        assert f'extern "C" int {sym}(' in src
    assert "gm_fwd_tc" in ops.KERNEL.functions
    assert "gm_dw_tc" in ops.KERNEL_DW.functions


def test_ops_wraps_no_launch_in_try():
    """A call that meets the tensor-core conditions launches that variant
    or raises: no try / except falls back to the other one."""
    tree = ast.parse((GM_DIR / "ops.py").read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_library_path_tracks_every_header_under_kernels(tmp_path,
                                                        monkeypatch):
    """A header shared from ``kernels/`` (``hopper.cuh``) or kept beside
    another package's source is part of the library's hash: editing it
    changes the path, so a stale library is never loaded."""
    root = tmp_path / "kernels"
    (root / "a" / "csrc").mkdir(parents=True)
    (root / "b" / "csrc").mkdir(parents=True)
    (root / "common.cuh").write_text("// common\n")
    (root / "hopper.cuh").write_text("// hopper v1\n")
    (root / "a" / "csrc" / "a.cu").write_text('#include "hopper.cuh"\n')
    (root / "b" / "csrc" / "b.cuh").write_text("// b v1\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", root)
    k = _build.Kernel("a", "a/csrc/a.cu", replaces="-", functions={})
    p0 = k.library_path()
    assert k.library_path() == p0                     # deterministic
    (root / "hopper.cuh").write_text("// hopper v2\n")
    p1 = k.library_path()
    assert p1 != p0
    (root / "b" / "csrc" / "b.cuh").write_text("// b v2\n")
    p2 = k.library_path()
    assert p2 not in (p0, p1)
    (root / "common.cuh").write_text("// common v2\n")
    assert k.library_path() not in (p0, p1, p2)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_requires_the_tensor_cores_on_the_moe_train_path():
    """Phase 4e fails a run in which a K4 or K5 launch took the SIMT
    variant; phase 3e fails a case whose variant differs from the dispatch's
    or that meets the tensor-core conditions and did not take them."""
    smoke = _smoke()
    names = ("grouped_matmul", "grouped_matmul_dw")
    good = {"grouped_matmul": 384, "grouped_matmul_dw": 192}
    smoke.check_tensor_core("moe train", good, dict(good), names)
    for name in names:
        with pytest.raises(AssertionError, match=name):
            smoke.check_tensor_core("moe train", good,
                                    {**good, name: good[name] - 1}, names)
    assert smoke.variant_of("K4 x", 1, "tc", True) == "tc"
    assert smoke.variant_of("K4 x", 0, "simt", False) == "simt"
    for launches, decided, expect in ((0, "tc", True), (1, "simt", False),
                                      (0, "simt", True), (2, "tc", True)):
        with pytest.raises(AssertionError, match="K4 x"):
            smoke.variant_of("K4 x", launches, decided, expect)


def test_chip_smoke_profile_counts_the_tensor_core_kernels():
    smoke = _smoke()
    for name in ("void tc::gm_tc_kernel<true>(CUtensorMap_st, int)",
                 "void tc::gm_dw_tc_kernel<float>(CUtensorMap_st)",
                 "void (anonymous namespace)::gm_kernel<float, 8>(float)"):
        assert smoke.OURS.search(name), name


def test_chip_smoke_exact_yardstick_is_the_plain_function():
    """Phase 5c's bf16 parity measures the spread of valid roundings with K4
    and K5 summed in float64: the same function as the plain versions, with
    a placement, dead rows holding garbage and an empty and a full group."""
    smoke = _smoke()
    g = torch.Generator().manual_seed(3)
    G, E, cap, K, N = 8, 4, 12, 16, 24
    counts = torch.tensor([0, 12, 5, 7, 12, 3, 9, 1], dtype=torch.int32)
    live = (torch.arange(G * cap) % cap < counts.repeat_interleave(cap))
    x = torch.randn((G * cap, K), generator=g)
    gr = torch.randn((G * cap, N), generator=g)
    x[~live], gr[~live] = 1e3, -1e3
    w = torch.randn((E, K, N), generator=g)
    em = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    wmap, gmap = ops.placement_maps(em)
    want = (ref.grouped_product_ref(x, w, counts, cap, wmap),
            ref.grouped_product_ref(gr, w.transpose(1, 2), counts, cap, wmap),
            ref.grouped_product_dw_ref(x, gr, counts, cap, E, gmap))
    orig = (ops.grouped_product, ops.grouped_product_dw)
    with smoke.ExactKernels():
        got = (ops.grouped_product(x, w, counts, cap, wmap),
               ops.grouped_product(gr, w.transpose(1, 2), counts, cap, wmap),
               ops.grouped_product_dw(x, gr, counts, cap, E, gmap,
                                      out_dtype=F32))
    assert (ops.grouped_product, ops.grouped_product_dw) == orig
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
