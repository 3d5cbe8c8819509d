"""export.py's BiRefNet ``forward`` on the small SWIN-T BiRefNet of
test_torch_api.py: the bundle against the eager forward in process (bit for
bit) and the JAX package's bundle of the same weights (REL_RMS), its vtt
nodes (window attention, masked and not, and the fused deformable convs
writing into the ASPP buffer's views) equal to the forward's operator calls;
and the program-only form, which lays out the deformable convs' weights
inside the program from the params it is given."""

import torch

from test_torch_api import write_family_gguf
from test_torch_export import assert_bit_equal, card_routed_cpu, check_family, example_inputs, vtt_nodes
from vision_tpu_torch import load_model
from vision_tpu_torch.export import export_model, load_bundle


def test_birefnet_bundle_matches_the_forward_and_the_jax_bundle(tmp_path):
    _, bundle = check_family(write_family_gguf("birefnet", tmp_path), "birefnet", tmp_path,
                             lambda m, name: m._forward_u8, extent=(64, 64))
    nodes = vtt_nodes(bundle, "forward")
    assert nodes["window_attention"] > 0 and set(nodes) <= {"window_attention", "deform_conv", "deform_conv_out"}
    assert nodes["deform_conv"] + nodes["deform_conv_out"] == 20  # the decoder's deformable convs
    assert bundle.meta["extent"] == [64, 64]


def test_birefnet_program_only_bundle_derives_its_layouts(tmp_path):
    model = load_model(write_family_gguf("birefnet", tmp_path), card_routed_cpu())
    export_model(model, tmp_path / "p.vxp", extent=(64, 64), embed_params=False)
    bundle = load_bundle(tmp_path / "p.vxp")
    x = torch.from_numpy(example_inputs(bundle, "forward")[-1])
    assert_bit_equal(bundle.call("forward", model.params, x), model._forward_u8(x))
    # other weights give the forward of those weights: the layouts are the program's own
    doubled = {k: v * 2 if k.endswith("conv.conv.weight") else v for k, v in model.params.items()}
    got = bundle.call("forward", doubled, x)
    model.params, saved = doubled, model.params
    from vision_tpu_torch.models.birefnet import deform_layouts

    model.deform_layouts, saved_layouts = deform_layouts(doubled, model.dtype), model.deform_layouts
    try:
        assert_bit_equal(got, model._forward_u8(x))
    finally:
        model.params, model.deform_layouts = saved, saved_layouts
