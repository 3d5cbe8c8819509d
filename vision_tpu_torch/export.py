"""Model export — deployment bundles of ``torch.export`` programs, the port of
vision_tpu/export.py.

The reference's deployment artifact is the GGUF weight file; every consumer
still needs the whole graph builder at run time. Here, as in the JAX
package, the artifact is the PROGRAM: ``torch.export`` records a model's
tensor forward (with or without its weights) as an ``ExportedProgram``, and
the loader side needs PyTorch, this file format and the ``vtt`` operators
(ops/cuda/library.py), none of the model-building code: no GGUF parsing, no
model module.

A bundle is a zip with ``meta.json`` (format tag, family, per-entry input
specs, the exporting device, ``torch.__version__``) and one ``<entry>.pt2``
per exported program (the bytes of ``torch.export.save``):

  * ``export_model(model, dst)``: family-aware; exports the model's tensor
    forwards at one geometry (SAM: ``encode`` + ``decode_point`` +
    ``decode_box``; SAM3: ``encode_vision`` + ``encode_text``; Real-ESRGAN:
    ``upscale``; the others: ``forward``). With ``embed_params=True``
    (default) the weights ride along as the program's constants: one
    self-contained file. With ``embed_params=False`` the program takes the
    model's param dict first (``model.params``: the names, types and device
    its loader left them in), and the bundle holds the program only.
  * ``load_bundle(src, device=None).call(entry, *args)``: load and run. The
    hand-written kernels stay ``vtt`` operators in the graph, so an entry
    runs them on the card through their CUDA implementations and on the CPU
    through their plain versions. ``device`` moves the programs to another
    device at load (``torch.export.passes.move_to_device_pass``): a bundle
    exported on the CPU serves on the card, through the kernels.

Geometry is static (a program is traced at one shape): pick ``extent`` and
``batch`` at export time, and export one bundle per shape bucket, as the
serving layer's bucketing does. An exported program runs op by op, as the
eager forward does; it is not a CUDA graph. Kept differences from the JAX
package: no per-backend lowering list (``platforms=``; a program moves with
``load_bundle(device=)`` instead). The meshed export (``meta["mesh"]``,
``make_mesh`` / ``call_sharded`` of a bundle) waits for its queue item: a
model built on a mesh (parallel/) is refused.
An int8-resident model (``keep_quantized``) exports with its weights: its
residents become constants and each lookup a ``vtt::dequant`` node.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Callable, Mapping, Sequence

import torch
from torch.utils import _pytree as pytree

from .core.errors import raise_error
from .ops.cuda import library  # noqa: F401  (registers the vtt operators the programs call)

__all__ = ["ExportedBundle", "export_bundle", "export_model", "load_bundle"]

FORMAT = "vision_tpu_torch-export-v1"


def _leaf_specs(tree) -> list:
    return [[list(map(int, leaf.shape)), str(leaf.dtype).removeprefix("torch.")]
            for leaf in pytree.tree_leaves(tree) if isinstance(leaf, torch.Tensor)]


def _device_of(tree) -> str:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device.type
    return "cpu"


def _as_plain(x):
    """NamedTuples -> plain dicts, recursively, lists -> tuples: a bundle
    must load without the model modules that define the output types
    (SamPrediction, DetectOutput, ...)."""
    if hasattr(x, "_fields"):
        return {k: _as_plain(v) for k, v in zip(x._fields, x)}
    if isinstance(x, (list, tuple)):
        return tuple(_as_plain(v) for v in x)
    return x


class _Program(torch.nn.Module):
    """``fn`` as the module ``torch.export`` traces, its outputs made plain."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return _as_plain(self.fn(*args))


def export_bundle(dst: str | os.PathLike, entries: Mapping[str, tuple[Callable, Sequence]],
                  meta: Mapping[str, Any] | None = None) -> str:
    """Export named functions into one bundle file.

    ``entries``: ``{name: (fn, example_args)}``, ``example_args`` real
    tensors (or pytrees of them) of the shapes, types and device the program
    takes. Each function is traced with ``torch.export.export(...,
    strict=False)`` under ``torch.no_grad()``, with no decompositions, so the
    ``vtt`` operators (and the ``_out`` forms' writes into buffer views) stay
    as they are. ``meta``: extra keys merged into ``meta.json``. Returns
    ``dst``."""
    if not entries:
        raise_error("export_bundle: no entries to export")
    meta_out: dict = {"format": FORMAT, "torch_version": torch.__version__}
    if meta:
        meta_out.update(meta)
    meta_out["entries"] = {}
    blobs: dict[str, bytes] = {}
    for name, (fn, args) in entries.items():
        args = tuple(args)
        with torch.no_grad():
            program = torch.export.export(_Program(fn), args, strict=False)
        program.example_inputs = None  # else saved beside the program: the param dict of a program-only entry
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs[name] = buf.getvalue()
        meta_out["entries"][name] = {"inputs": _leaf_specs(args), "device": _device_of(args)}
    meta_out.setdefault("device", next(iter(meta_out["entries"].values()))["device"])
    with zipfile.ZipFile(os.fspath(dst), "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta_out, indent=1))
        for name, blob in blobs.items():
            z.writestr(name + ".pt2", blob)
    return os.fspath(dst)


class ExportedBundle:
    """A loaded bundle: ``meta`` (dict), ``names`` (entry list),
    ``call(name, *args)``. Each entry's program is deserialized at its first
    call (and moved to ``device`` when one was given)."""

    def __init__(self, path: str, meta: dict, blobs: Mapping[str, bytes], device: torch.device | None = None):
        self.path = path
        self.meta = meta
        self.device = device
        self._blobs = dict(blobs)
        self._loaded: dict[str, Callable] = {}

    @property
    def names(self) -> list[str]:
        return sorted(self._blobs)

    def _check(self, name: str) -> None:
        if name not in self._blobs:
            raise_error("bundle '{}' has no entry '{}' (have: {})", self.path, name, ", ".join(self.names))

    def _entry(self, name: str) -> Callable:
        if name not in self._loaded:
            self._check(name)
            program = torch.export.load(io.BytesIO(self._blobs[name]))
            if self.device is not None:
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, self.device)
            self._loaded[name] = program.module()
        return self._loaded[name]

    def call(self, name: str, *args):
        """Run entry ``name`` on ``args`` (tensors on the bundle's device, of
        the shapes and types of :meth:`input_specs`)."""
        fn = self._entry(name)
        with torch.inference_mode():
            return fn(*args)

    def input_specs(self, name: str) -> list:
        """Flattened ``[shape, dtype]`` list recorded at export time (read
        from meta.json; does not load the program)."""
        self._check(name)
        return self.meta["entries"][name]["inputs"]


def load_bundle(src: str | os.PathLike, device: torch.device | str | None = None) -> ExportedBundle:
    """Open a bundle written by ``export_bundle`` / ``export_model``;
    ``device``: move its programs there (None: keep the exporting device)."""
    path = os.fspath(src)
    with zipfile.ZipFile(path, "r") as z:
        names = set(z.namelist())
        if "meta.json" not in names:
            raise_error("'{}' is not a vision_tpu_torch export bundle (no meta.json)", path)
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != FORMAT:
            raise_error("'{}' has unknown bundle format {!r} (expected {!r})", path, meta.get("format"), FORMAT)
        blobs = {n[: -len(".pt2")]: z.read(n) for n in names if n.endswith(".pt2")}
    return ExportedBundle(path, meta, blobs, None if device is None else torch.device(device))


# ---------------------------------------------------------------------------
# family-aware model export


def _with_params(model, fn: Callable, derive: Callable | None = None) -> Callable:
    """``fn`` as a function of the param dict first: while it runs (once,
    under the trace) ``model.params`` is the given dict, and ``derive(model,
    params)`` sets what the model derives from its weights."""

    def run(params, *args):
        saved = dict(model.__dict__)
        model.params = params
        if derive is not None:
            derive(model, params)
        try:
            return fn(*args)
        finally:
            model.__dict__.update(saved)

    return run


def export_model(model, dst: str | os.PathLike, extent: tuple[int, int] | None = None, batch: int = 1,
                 embed_params: bool = True, entries: Sequence[str] | None = None) -> list[str]:
    """Export a high-level model's tensor forwards as a bundle.

    ``entries`` selects a subset of the family's entry names (default: all),
    e.g. ``("encode",)`` for a SAM bundle that only serves the encoder.
    ``extent`` (w, h) picks the input geometry of the extent-dynamic
    families: BiRefNet and Depth-Anything snap it to their grids as their
    ``compute`` does; Real-ESRGAN takes it verbatim. The fixed-input families
    (SAM 1024², MI-GAN ``resolution``², YOLOv9t ``input_size``², SAM3
    ``image_size``²) ignore it. ``batch`` sets the leading axis of the image
    entries (SAM's decode and SAM3's text entries stay per prompt: one
    embedding and (2, 2) coords; one (1, t) int32 token row and its (t, t)
    f32 mask). The inputs are those of the model's tensor forwards (uint8
    images, preprocessing inside the program), on the model's device.
    Returns the entry names written."""
    from .core.quant import is_quant

    if batch < 1:
        raise_error("export_model: batch must be >= 1, got {}", batch)
    kind = type(model).__name__
    if getattr(model, "mesh", None) is not None:
        raise_error("export_model: a meshed {} does not export yet (the meshed export and call_sharded wait for "
                    "their queue item); export the model built without a mesh", kind)
    if not embed_params and any(is_quant(v) for v in model.params.values()):
        raise_error("export_model: an int8-resident {} exports with its weights (its residents are no tensors of "
                    "the param dict); drop embed_params=False", kind)
    dev = model.device.torch_device
    params = model.params
    meta: dict = {"family": kind, "batch": batch, "params_embedded": embed_params}
    programs: dict[str, tuple[Callable, tuple]] = {}
    derive = None

    def u8(*shape):
        return torch.zeros(shape, dtype=torch.uint8, device=dev)

    def add(name, fn, *args):
        if embed_params:
            programs[name] = (fn, tuple(args))
        else:
            programs[name] = (_with_params(model, fn, derive), (params, *args))

    if kind == "SamModel":
        s = model.p.image_size
        # the decode entries' example embedding: one encoder forward (a copy
        # made outside inference mode, as the trace's inputs must be)
        embed = model.encode_u8(u8(1, s, s, 3)).clone()
        coords = torch.zeros((2, 2), dtype=torch.float32, device=dev)
        add("encode", model.encode_u8, u8(batch, s, s, 3))
        add("decode_point", lambda e, c: model._dec_point(e, c[None]), embed, coords)
        add("decode_box", lambda e, c: model._dec_box(e, c[None]), embed, coords)
        meta["image_size"] = s
    elif kind == "EsrganModel":
        if not embed_params:
            raise_error("export_model: esrgan always embeds its weights; drop embed_params=False")
        w, h = extent or (1024, 1024)
        add("upscale", model._forward_u8, u8(batch, h, w, 3))
        meta.update(extent=[w, h], scale=model.p.scale)
    elif kind == "BirefnetModel":
        from .models.birefnet import birefnet_image_extent, deform_layouts

        def derive(m, p):  # noqa: F811  (the fused kernel's weight layouts, traced from the given weights)
            m.deform_layouts = deform_layouts(p, m.dtype)

        w, h = birefnet_image_extent(extent or (1024, 1024), model.p, model.device.max_alloc)
        add("forward", model._forward_u8, u8(batch, h, w, 3))
        meta["extent"] = [w, h]
    elif kind == "DepthAnythingModel":
        from .models.depth_anything import depthany_image_extent

        w, h = depthany_image_extent(extent or (518, 518), model.p)
        add("forward", model._forward_u8, u8(batch, h, w, 3))
        meta["extent"] = [w, h]
    elif kind == "MiganModel":
        r = model.p.resolution
        add("forward", model._forward_u8, u8(batch, r, r, 3), u8(batch, r, r, 1))
        meta["resolution"] = r
    elif kind == "Yolov9tModel":
        s = model.p.input_size
        add("forward", model._forward_u8, u8(batch, s, s, 3))
        meta["input_size"] = s
    elif kind == "Sam3Model":
        s, t = model.vp.image_size, model.max_tokens
        x = torch.zeros((batch, s, s, 3), dtype=model.dtype, device=dev)
        ids = torch.zeros((1, t), dtype=torch.int32, device=dev)
        mask = torch.zeros((t, t), dtype=torch.float32, device=dev)
        add("encode_vision", model._encode_vision, x)
        add("encode_text", model._encode_text, ids, mask)
        meta.update(image_size=s, max_tokens=t)
    else:
        raise_error("export_model: unsupported model type '{}'", kind)
    if entries is not None:
        unknown = sorted(set(entries) - set(programs))
        if unknown:
            raise_error("export_model: unknown entries {} for {} (have: {})", ", ".join(unknown), kind,
                        ", ".join(sorted(programs)))
        programs = {k: v for k, v in programs.items() if k in set(entries)}
        if not programs:
            raise_error("export_model: entries selected nothing to export")
    export_bundle(dst, programs, meta=meta)
    return sorted(programs)
