"""int8 post-training quantization of ConvNeXt and GCViT against the JAX
package's pass, on the CPU at narrow widths, on both block paths:
``test_torch_int8_members.py``'s site parity (tables, reports, per-site
int8 codes, logits), in a file of its own so that the test workers share
the load. Fused: both packages forced onto the fused block path (the JAX
side runs its Pallas kernels in interpret mode), where the block kernels
read the MLP Linears without calling them."""
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
import pytest
from test_torch_int8_members import _quantized, _sites_match_jax


@pytest.mark.parametrize("path", ["fused", "unfused"])
def test_convnext_sites_match_jax(path):
    """Fused: the downsample convs the JAX model calls as ``nn.Conv`` (not
    the one between the two batch-last stages); unfused: those and every
    block's MLP."""
    report = _sites_match_jax(f"convnext {path}")
    down = ["stages_2_downsample_conv", "stages_3_downsample_conv"]
    mlp = [f"stages_{j}_blocks_0/mlp_fc{i}" for j in range(4) for i in (1, 2)]
    if path == "fused":
        assert report["quantized_sites"] == down
    else:
        assert set(report["quantized_sites"]) == set(down + mlp + ["stages_1_downsample_conv"])


@pytest.mark.parametrize("path", ["fused", "unfused"])
def test_gcvit_sites_match_jax(path):
    """The ReduceSize / FeatExtract convs and the SE Linears past the width
    rule at batch 2; unfused also the blocks' MLPs, never the attention's
    Linears."""
    report = _sites_match_jax(f"gcvit {path}")
    sites = report["quantized_sites"]
    assert "levels_0/downsample/reduction" in sites and "patch_embed/conv_down/conv_3" in sites
    assert "levels_1/downsample/conv_2/fc_0" not in sites  # 64 channels: 16 out of fc_0
    assert "levels_2/q_global_gen_to_q_global_0/conv_2/fc_0" in sites
    assert not _quantized(report, "attn")
    assert bool(_quantized(report, "mlp")) == (path == "unfused")
