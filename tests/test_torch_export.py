"""The port's export.py on the CPU, on the small GGUFs of test_torch_api.py:
for each family a bundle's entries bit-equal to the model's tensor forward
in process, and within REL_RMS of the JAX package's ``load_bundle(...).call``
of its own export of the same weights (uint8 outputs within one level on at
most 0.1% of the values, as test_torch_cli.py holds the CLIs); the ``vtt``
nodes of each program counted and equal to the operator calls of an eager
forward (the CPU model routed as the card routes: ``Device.with_flags``
turns the flash route on); the program-only and Q8_0-resident forms;
``meta.json`` and the refusals; and a bundle loaded and called in a process
that imports no model module. SAM and SAM3 are in test_torch_export_sam.py,
BiRefNet in test_torch_export_birefnet.py."""

import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_api import write_family_gguf
from vision_tpu import api as japi
from vision_tpu import export as jexport
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu_torch import load_model
from vision_tpu_torch.core.device import BuildFlag, backend_init
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.export import FORMAT, export_bundle, export_model, load_bundle

REL_RMS = 1e-4  # tests/test_golden.py:23
MAX_SHARE_OFF = 1e-3  # uint8 outputs: share of values one level off (test_torch_cli.py)
REPO = Path(__file__).resolve().parents[1]

# family -> (export extent, batch); Depth-Anything at 448 for 1025 tokens, past the flash route's 1024
GEOMETRY = {"depthany": ((448, 448), 1), "esrgan": ((40, 32), 2), "migan": (None, 2), "yolov9t": (None, 1)}


def card_routed_cpu():
    """The CPU device with the card's kernel routes (the flash flag on)."""
    dev = backend_init("cpu")
    return dev.with_flags(dev.flags | BuildFlag.flash_attention)


class VttCalls(TorchDispatchMode):
    """Counts the vtt operator calls of the enclosed code."""

    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith("vtt::"):
            self.calls[name.removeprefix("vtt::")] += 1
        return func(*args, **(kwargs or {}))


def vtt_calls(fn, *args) -> Counter:
    with torch.inference_mode(), VttCalls() as mode:
        fn(*args)
    return mode.calls


def vtt_nodes(bundle, name) -> Counter:
    """The vtt nodes of entry ``name``'s program."""
    gm = bundle._entry(name)
    return Counter(str(n.target.name()).removeprefix("vtt::") for n in gm.graph.nodes
                   if n.op == "call_function" and hasattr(n.target, "name") and n.target.name().startswith("vtt::"))


def example_inputs(bundle, name, seed=0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for shape, dtype in bundle.input_specs(name):
        if dtype == "uint8":
            out.append(rng.integers(0, 256, shape).astype(np.uint8))
        else:
            out.append(rng.standard_normal(shape).astype(np.float32))
    return out


def leaves(tree) -> list:
    """The outputs' arrays in a fixed order (dicts by key)."""
    if hasattr(tree, "_fields"):
        return leaves(tree._asdict())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def assert_bit_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def assert_matches_jax(got, want):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        u8 = b.dtype == np.uint8
        a, b = a.float().numpy().astype(np.float64), b.astype(np.float64)
        assert a.shape == b.shape
        if u8:
            diff = np.abs(a - b)
            assert diff.max() <= 1 and (diff > 0).mean() <= MAX_SHARE_OFF, (diff.max(), (diff > 0).mean())
        else:
            rel = np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-12)
            assert rel <= REL_RMS, rel


def check_family(path, family, tmp_path, forward, extent=None, batch=1):
    """Export the port's and the JAX package's models of ``path``, run every
    entry on the same inputs, and hold the port's bundle to the forward in
    process (``forward(model, entry)``: the callable the entry exported) and
    to the JAX bundle; the vtt nodes to the forward's operator calls."""
    model = load_model(path, card_routed_cpu())
    names = export_model(model, tmp_path / "port.vxp", extent=extent, batch=batch)
    jmodel = japi.load_model(path, jax_backend_init("cpu"))
    assert jexport.export_model(jmodel, tmp_path / "jax.vxp", extent=extent, batch=batch) == names
    bundle, jbundle = load_bundle(tmp_path / "port.vxp"), jexport.load_bundle(tmp_path / "jax.vxp")
    assert bundle.meta["family"] == jbundle.meta["family"]
    for name in names:
        assert bundle.input_specs(name) == [[s, d] for s, d in jbundle.input_specs(name)]
        args = example_inputs(bundle, name)
        targs = [torch.from_numpy(a) for a in args]
        got = bundle.call(name, *targs)
        assert_bit_equal(got, forward(model, name)(*targs))
        assert_matches_jax(got, jbundle.call(name, *args))
        assert vtt_nodes(bundle, name) == vtt_calls(forward(model, name), *targs)
    return model, bundle


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    return {family: write_family_gguf(family, d) for family in GEOMETRY}


@pytest.mark.parametrize("family", sorted(GEOMETRY))
def test_bundle_matches_the_forward_and_the_jax_bundle(family, ggufs, tmp_path):
    extent, batch = GEOMETRY[family]
    _, bundle = check_family(ggufs[family], family, tmp_path, lambda m, name: m._forward_u8, extent, batch)
    counts = sum((vtt_nodes(bundle, n) for n in bundle.names), Counter())
    # each family's kernels stand in its program (MI-GAN has none)
    want = {"depthany": {"flash_attention"}, "esrgan": {"conv3x3", "conv3x3_out"},
            "yolov9t": {"conv3x3", "conv3x3_out"}, "migan": set()}[family]
    assert set(counts) == want


@pytest.mark.parametrize("family", ["depthany", "migan"])
def test_program_only_bundle_takes_the_params_first(family, ggufs, tmp_path):
    model = load_model(ggufs[family], card_routed_cpu())
    extent, batch = GEOMETRY[family]
    export_model(model, tmp_path / "p.vxp", extent=extent, batch=batch, embed_params=False)
    embedded = export_model(model, tmp_path / "e.vxp", extent=extent, batch=batch)
    bundle = load_bundle(tmp_path / "p.vxp")
    assert bundle.meta["params_embedded"] is False
    assert (tmp_path / "p.vxp").stat().st_size * 20 < (tmp_path / "e.vxp").stat().st_size
    specs = bundle.input_specs("forward")
    assert len(specs) == len(model.params) + len(load_bundle(tmp_path / "e.vxp").input_specs("forward"))
    args = [torch.from_numpy(a) for a in example_inputs(load_bundle(tmp_path / "e.vxp"), embedded[0])]
    assert_bit_equal(bundle.call("forward", model.params, *args), model._forward_u8(*args))


def test_q8_0_resident_bundle_dequantizes_in_the_program(ggufs, tmp_path):
    from vision_tpu_torch.core.gguf import requantize_gguf
    from vision_tpu_torch.core.quant import is_quant

    q8 = tmp_path / "q8.gguf"
    requantize_gguf(ggufs["depthany"], q8, "q8_0")
    dev = card_routed_cpu()
    model = load_model(str(q8), dev.with_flags(dev.flags | BuildFlag.keep_quantized))
    residents = sum(is_quant(v) for v in model.params.values())
    assert residents > 0
    export_model(model, tmp_path / "q.vxp", extent=(126, 126))
    bundle = load_bundle(tmp_path / "q.vxp")
    x = torch.from_numpy(example_inputs(bundle, "forward")[0])
    assert_bit_equal(bundle.call("forward", x), model._forward_u8(x))
    nodes = vtt_nodes(bundle, "forward")
    assert nodes["dequant"] == vtt_calls(model._forward_u8, x)["dequant"] >= residents
    with pytest.raises(VispError, match="int8-resident .* exports with its weights"):
        export_model(model, tmp_path / "no.vxp", extent=(126, 126), embed_params=False)


def test_meta_json_and_refusals(ggufs, tmp_path):
    import json
    import zipfile

    model = load_model(ggufs["esrgan"], backend_init("cpu"))
    assert export_model(model, tmp_path / "e.vxp", extent=(16, 12), batch=3) == ["upscale"]
    with zipfile.ZipFile(tmp_path / "e.vxp") as z:
        assert sorted(z.namelist()) == ["meta.json", "upscale.pt2"]
        meta = json.loads(z.read("meta.json"))
    assert meta["format"] == FORMAT == "vision_tpu_torch-export-v1"
    assert meta["family"] == "EsrganModel" and meta["batch"] == 3 and meta["params_embedded"] is True
    assert meta["extent"] == [16, 12] and meta["scale"] == 4 and meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    assert meta["entries"]["upscale"] == {"inputs": [[[3, 12, 16, 3], "uint8"]], "device": "cpu"}
    bundle = load_bundle(tmp_path / "e.vxp")
    assert bundle.names == ["upscale"] and bundle.input_specs("upscale") == [[[3, 12, 16, 3], "uint8"]]
    import vision_tpu_torch  # the package's own entry points, as the JAX package's

    assert vision_tpu_torch.export_model(model, tmp_path / "p.vxp", extent=(16, 12)) == ["upscale"]
    assert vision_tpu_torch.load_bundle(tmp_path / "p.vxp", "cpu").names == ["upscale"]
    with pytest.raises(VispError, match="has no entry 'forward'"):
        bundle.call("forward", torch.zeros(1))
    with pytest.raises(VispError, match="always embeds"):
        export_model(model, tmp_path / "x.vxp", embed_params=False)
    with pytest.raises(VispError, match="unknown entries forward"):
        export_model(model, tmp_path / "x.vxp", extent=(16, 12), entries=("forward",))
    with pytest.raises(VispError, match="selected nothing"):
        export_model(model, tmp_path / "x.vxp", extent=(16, 12), entries=())
    with pytest.raises(VispError, match="batch must be >= 1"):
        export_model(model, tmp_path / "x.vxp", batch=0)
    with pytest.raises(VispError, match="unsupported model type 'object'"):
        export_model(type("object", (), {"params": {}, "device": backend_init("cpu")})(), tmp_path / "x.vxp")
    with pytest.raises(VispError, match="no entries"):
        export_bundle(tmp_path / "x.vxp", {})
    with zipfile.ZipFile(tmp_path / "bad.zip", "w") as z:
        z.writestr("x.txt", "")
    with pytest.raises(VispError, match="no meta.json"):
        load_bundle(tmp_path / "bad.zip")
    with zipfile.ZipFile(tmp_path / "old.zip", "w") as z:
        z.writestr("meta.json", json.dumps({"format": "vision_tpu-export-v1"}))
    with pytest.raises(VispError, match="unknown bundle format 'vision_tpu-export-v1'"):
        load_bundle(tmp_path / "old.zip")


def test_export_bundle_of_plain_functions_and_a_device_move(tmp_path):
    """export_bundle takes any tensor function; the programs keep the
    operators whole, and ``load_bundle(device=)`` moves them (here to the
    CPU they came from: the card's move is chip_smoke.py's phase 40)."""
    from vision_tpu_torch.ops.cuda.conv3x3 import conv3x3

    x, w = torch.randn(1, 6, 5, 4), torch.randn(3, 4, 3, 3)

    def into_view(x):
        buf = torch.zeros(1, 6, 5, 8)
        conv3x3(x, w, slope=0.1, out=buf[..., 2:5])
        return buf

    export_bundle(tmp_path / "f.vxp", {"conv": (lambda x: conv3x3(x, w), (x,)), "view": (into_view, (x,))},
                  meta={"family": "none"})
    bundle = load_bundle(tmp_path / "f.vxp", device="cpu")
    assert bundle.meta["family"] == "none" and bundle.names == ["conv", "view"]
    assert torch.equal(bundle.call("conv", x), conv3x3(x, w))
    assert torch.equal(bundle.call("view", x), into_view(x))
    assert vtt_nodes(bundle, "conv") == Counter({"conv3x3": 1})
    assert vtt_nodes(bundle, "view") == Counter({"conv3x3_out": 1})


def test_bundle_loads_in_a_process_without_model_modules(ggufs, tmp_path):
    model = load_model(ggufs["yolov9t"], card_routed_cpu())
    export_model(model, tmp_path / "y.vxp")
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (1, 640, 640, 3)).astype(np.uint8))
    np.save(tmp_path / "x.npy", x.numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from vision_tpu_torch.export import load_bundle\n"
        f"b = load_bundle({str(tmp_path / 'y.vxp')!r})\n"
        f"y = b.call('forward', torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))\n"
        f"np.save({str(tmp_path / 'boxes.npy')!r}, y['boxes'].numpy())\n"
        f"np.save({str(tmp_path / 'scores.npy')!r}, y['scores'].numpy())\n"
        "print(' '.join(sorted(m for m in sys.modules if m.split('.')[0] in ('vision_tpu_torch', 'vision_tpu', 'jax'))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    modules = res.stdout.split()
    assert "vision_tpu_torch.ops.cuda.library" in modules
    assert not [m for m in modules if m.startswith(("vision_tpu_torch.models", "vision_tpu.", "jax"))], modules
    want = model._forward_u8(x)
    assert np.array_equal(np.load(tmp_path / "boxes.npy"), want.boxes.numpy())
    assert np.array_equal(np.load(tmp_path / "scores.npy"), want.scores.numpy())
