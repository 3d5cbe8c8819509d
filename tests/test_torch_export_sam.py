"""export.py's SAM entries (``encode``, ``decode_point``, ``decode_box``) on
the full-width random MobileSAM of test_torch_api.py, and SAM3's
(``encode_vision``, ``encode_text``) on the small SAM3 of
test_torch_sam3.py, against the eager forwards in process (bit for bit) and
the JAX package's bundles of the same weights (REL_RMS), with the vtt nodes
equal to the forwards' operator calls; and the program-only forms."""

import numpy as np
import torch

from test_torch_api import write_family_gguf
from test_torch_export import (
    assert_bit_equal,
    assert_matches_jax,
    card_routed_cpu,
    check_family,
    leaves,
    vtt_calls,
    vtt_nodes,
)
from test_torch_sam3 import RANDOM_VP, _model_store, _tokenizer
from vision_tpu import export as jexport
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.models import sam3 as js3
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.export import export_model, load_bundle
from vision_tpu_torch.models import sam3 as s3


def _sam_forward(model, name):
    return {"encode": model.encode_u8, "decode_point": lambda e, c: model._dec_point(e, c[None]),
            "decode_box": lambda e, c: model._dec_box(e, c[None])}[name]


def test_sam_bundle_matches_the_forward_and_the_jax_bundle(tmp_path):
    model, bundle = check_family(write_family_gguf("sam", tmp_path), "sam", tmp_path, _sam_forward)
    assert bundle.names == ["decode_box", "decode_point", "encode"]
    assert vtt_nodes(bundle, "encode") == {"window_attention": 10}  # TinyViT's windowed blocks
    assert bundle.meta["image_size"] == 1024


def test_sam_decode_entries_serve_the_compute_path(tmp_path):
    """decode_point on an encode entry's embedding gives SamModel.compute's
    prediction: the tensor-coords forms change no result."""
    from vision_tpu_torch import load_model
    from vision_tpu_torch.models.mobile_sam import sam_process_point

    model = load_model(write_family_gguf("sam", tmp_path), card_routed_cpu())
    export_model(model, tmp_path / "s.vxp", entries=("decode_point", "decode_box"))
    bundle = load_bundle(tmp_path / "s.vxp")
    assert bundle.names == ["decode_box", "decode_point"]
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 1024, 1024, 3)).astype(np.uint8))
    embed = model.encode_u8(x).clone()
    coords = sam_process_point((40, 30), (96, 72))
    got = bundle.call("decode_point", embed, torch.from_numpy(coords))
    want = model.decode(embed, coords[None], "point")
    assert_bit_equal(got, want)
    box = np.array([[10.0, 12.0], [600.0, 500.0]], np.float32)
    assert_bit_equal(bundle.call("decode_box", embed, torch.from_numpy(box)), model.decode(embed, box[None], "box"))


def _sam3_models():
    store = _model_store()
    jm = js3.Sam3Model(store, _tokenizer(js3.ClipTokenizer), 8, jax_backend_init("cpu"),
                       vp=js3.Sam3VitParams(**RANDOM_VP))
    pm = s3.Sam3Model(params_from_numpy(store, "cpu", torch.float32), _tokenizer(s3.ClipTokenizer), 8,
                      card_routed_cpu(), vp=s3.Sam3VitParams(**RANDOM_VP))
    return pm, jm


def _sam3_inputs(pm):
    s, t = pm.vp.image_size, pm.max_tokens
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    ids = rng.integers(0, 40, (1, t)).astype(np.int32)
    mask = np.triu(np.full((t, t), -np.inf, np.float32), 1)
    return {"encode_vision": [x], "encode_text": [ids, mask]}


def test_sam3_bundle_matches_the_forward_and_the_jax_bundle(tmp_path):
    pm, jm = _sam3_models()
    names = export_model(pm, tmp_path / "p.vxp", batch=2)
    assert jexport.export_model(jm, tmp_path / "j.vxp", batch=2) == names == ["encode_text", "encode_vision"]
    bundle, jbundle = load_bundle(tmp_path / "p.vxp"), jexport.load_bundle(tmp_path / "j.vxp")
    assert bundle.meta["max_tokens"] == 8 and bundle.meta["image_size"] == RANDOM_VP["image_size"]
    forwards = {"encode_vision": pm._encode_vision, "encode_text": pm._encode_text}
    for name, args in _sam3_inputs(pm).items():
        assert bundle.input_specs(name) == [[s, d] for s, d in jbundle.input_specs(name)]
        targs = [torch.from_numpy(a) for a in args]
        got = bundle.call(name, *targs)
        assert_bit_equal(got, forwards[name](*targs))
        assert_matches_jax(got, jbundle.call(name, *args))
        assert vtt_nodes(bundle, name) == vtt_calls(forwards[name], *targs)
    x = torch.from_numpy(_sam3_inputs(pm)["encode_vision"][0])
    assert len(leaves(bundle.call("encode_vision", x))) == 4  # the FPN levels


def test_sam3_program_only_bundle(tmp_path):
    pm, _ = _sam3_models()
    export_model(pm, tmp_path / "p.vxp", embed_params=False)
    bundle = load_bundle(tmp_path / "p.vxp")
    ids, mask = (torch.from_numpy(a) for a in _sam3_inputs(pm)["encode_text"])
    assert_bit_equal(bundle.call("encode_text", pm.params, ids, mask), pm._encode_text(ids, mask))
    x = torch.from_numpy(_sam3_inputs(pm)["encode_vision"][0][:1])
    assert_bit_equal(bundle.call("encode_vision", pm.params, x), pm._encode_vision(x))
