"""The dense and MoE architectures of ``tests/test_smoke_archs.py`` in the
port — the six besides the block families: ``reference_loss`` and its
gradients at the reference's reduced size against the JAX package's, by
``test_torch_families_archs.check_arch_parity`` (losses within 1e-4
relative, every gradient leaf within 1e-3 of its largest entry).
"""
import pytest

pytest.importorskip("jax")
from test_torch_families_archs import check_arch_parity  # noqa: E402

DENSE_ARCHS = ["mixtral-8x7b", "mixtral-8x22b", "llama3-405b",
               "command-r-plus-104b", "smollm-360m", "deepseek-coder-33b"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_reference_loss_and_grads_match_reference(arch):
    check_arch_parity(arch)
